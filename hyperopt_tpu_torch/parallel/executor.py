"""Asynchronous trial evaluation — the Mongo/Spark-backend analog
(counterpart of ``hyperopt_tpu/parallel/executor.py``).

Parity targets: ``hyperopt/mongoexp.py`` (sym: MongoTrials, MongoJobs.reserve,
MongoWorker.run_one) and ``hyperopt/spark.py`` (sym: SparkTrials).  The
reference moves ``Domain.evaluate`` across a process/cluster boundary via DB
polling (Mongo) or driver→executor RPC (Spark); the single-claim guarantee is
Mongo's atomic ``find_one_and_update``.

Here the boundary is a host-side worker pool feeding the one process
that owns the card (single-controller model):

* ``ExecutorTrials`` is a ``Trials`` with ``asynchronous=True``: inserting
  NEW trials dispatches evaluation onto a ``ThreadPoolExecutor``.  Claiming
  NEW→RUNNING happens under one lock (the atomic-claim analog; a test
  asserts no double-claim).  Workers write results, flip DONE/ERROR and bump
  ``refresh_time`` (the heartbeat analog); ``fmin``'s poll loop sees state
  changes exactly as it would see Mongo state changes.
* With ``traceable=True`` the pool evaluates a whole queue of trials as ONE
  vmapped device call (``Domain.make_batch_eval``, ``torch.func.vmap``
  over the objective) on the trials' device: instead of N processes each
  computing one objective, one batched program computes N.

The domain reaches workers the same way Mongo workers get it: a cloudpickle
blob stored by ``FMinIter`` under ``attachments['FMinIter_Domain']``
(misc.cmd = ('domain_attachment', 'FMinIter_Domain')).
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..obs import EventLog, MetricsRegistry
from ..obs.watchdog import beat as _wd_beat
from ..retry import RetryPolicy
from ..obs.events import (
    TRIAL_CANCELLED,
    TRIAL_CLAIMED,
    TRIAL_FINISHED,
    TRIAL_NEW,
)
from ..base import (
    JOB_STATE_CANCEL,
    JOB_STATE_DONE,
    JOB_STATE_ERROR,
    JOB_STATE_NEW,
    JOB_STATE_RUNNING,
    STATUS_FAIL,
    STATUS_OK,
    Ctrl,
    Trials,
    coarse_utcnow,
    spec_from_misc,
)

__all__ = ["ExecutorTrials"]

logger = logging.getLogger(__name__)

# each pool instance gets its own metrics namespace (executor-1, -2, ...) so
# two concurrent backends in one process don't mix queue gauges
_instance_ids = itertools.count(1)


class ExecutorTrials(Trials):
    """Trials whose evaluation runs on a worker pool (asynchronous=True).

    ``device`` is where the history and the suggesters live, and where a
    ``traceable`` pool evaluates each queue as one batch: the CUDA card
    unless ``device="cpu"``."""

    asynchronous = True
    poll_interval_secs = 0.05  # in-process pool: poll fast (FMinIter reads this)

    @property
    def default_max_queue_len(self):
        """FMinIter queues at least this many outstanding suggestions so the
        pool stays saturated (the SparkTrials-parallelism analog)."""
        return self.n_workers

    def __init__(self, n_workers=4, traceable=False, timeout=None,
                 retry=None, exp_key=None, refresh=True, device=None):
        self.n_workers = int(n_workers)
        self.traceable = bool(traceable)
        # per-trial budget (the SparkTrials(timeout=) analog): a RUNNING
        # trial past its deadline is moved to JOB_STATE_CANCEL by the
        # driver's poll loop; the orphaned worker thread's eventual result is
        # discarded.  Python threads can't be killed — cancellation is a
        # state-level guarantee (fmin never waits on it), not a CPU reclaim,
        # matching Spark's job-group cancel semantics at the trial-doc level.
        # Deadlines are MONOTONIC-clock, stamped at claim time:
        # wall-clock arithmetic on book_time meant an NTP step or a
        # suspended host could mass-cancel every healthy in-flight trial.
        self.timeout = timeout
        # per-trial retry policy (retry.py): a raising objective is re-run
        # in place with jittered exponential backoff, the attempt count
        # recorded in misc['attempts'] — None/0 keeps the old
        # fail-immediately behavior
        self.retry = RetryPolicy.coerce(retry)
        self._deadlines = {}  # tid -> monotonic cancel deadline
        self._monotonic = time.monotonic  # injectable for fake-clock tests
        self._sleep = time.sleep
        self._lock = threading.RLock()
        self._pool = None
        self._domain_cache = None
        self._batch_eval_cache = None
        self._dispatched = set()  # tids already submitted to the pool
        # obs: queue/utilization gauges + lifecycle events for this pool
        # (in-memory ring; the durable analog lives in FileStore).  The
        # registry is per-instance and deliberately NOT globally registered:
        # readers reach it via `trials.metrics`, and registering every pool
        # (plus every unpickle) would grow the process-global table forever
        self.metrics = MetricsRegistry(f"executor-{next(_instance_ids)}")
        self.metrics.gauge("n_workers").set(self.n_workers)
        self.obs_events = EventLog()
        self._busy = 0
        super().__init__(exp_key=exp_key, refresh=refresh, device=device)

    # -- obs plumbing ------------------------------------------------------

    def _worker_busy(self, delta):
        """Track pool utilization: busy-worker gauge + cumulative busy
        seconds (divide by wall x n_workers for utilization)."""
        with self._lock:
            self._busy += delta
            self.metrics.gauge("busy_workers").set(self._busy)

    # -- pool / domain plumbing -------------------------------------------

    def _get_pool(self):
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self.n_workers, thread_name_prefix="hyperopt-worker"
            )
        return self._pool

    def _get_domain(self):
        """Unpickle the domain attachment once (MongoWorker.run_one analog)."""
        if self._domain_cache is None:
            blob = self.attachments.get("FMinIter_Domain")
            if blob is None:
                return None
            if isinstance(blob, (bytes, bytearray)):
                import cloudpickle

                self._domain_cache = cloudpickle.loads(bytes(blob))
            else:
                self._domain_cache = blob
        return self._domain_cache

    # -- claim / evaluate --------------------------------------------------

    def _claim(self, trial):
        """Atomically move NEW -> RUNNING (MongoJobs.reserve analog).
        The cancel deadline is stamped HERE, from the monotonic clock —
        claim time is the only moment both the budget and the clock are
        known to be fresh."""
        with self._lock:
            if trial["state"] != JOB_STATE_NEW:
                return False
            trial["state"] = JOB_STATE_RUNNING
            trial["book_time"] = coarse_utcnow()
            trial["owner"] = threading.current_thread().name
            if self.timeout is not None:
                self._deadlines[trial["tid"]] = (
                    self._monotonic() + self.timeout)
        self.obs_events.emit(TRIAL_CLAIMED, trial["tid"],
                             owner=trial["owner"])
        return True

    def _finish(self, trial, result=None, error=None):
        with self._lock:
            # the monotonic deadline dies with the trial whatever the
            # outcome — only live RUNNING docs are budget-tracked
            self._deadlines.pop(trial["tid"], None)
            if trial["state"] == JOB_STATE_CANCEL:
                self.metrics.counter("results.discarded").inc()
                return  # timed out meanwhile: the late result is discarded
            # write result BEFORE state: the driver thread reads docs without
            # this lock, and must never observe DONE with a stale result
            if error is not None:
                trial["misc"]["error"] = (str(type(error)), str(error))
                trial["state"] = JOB_STATE_ERROR
            else:
                trial["result"] = result
                trial["state"] = JOB_STATE_DONE
            trial["refresh_time"] = coarse_utcnow()
        sec = None
        if trial.get("book_time") is not None:
            sec = (trial["refresh_time"] - trial["book_time"]).total_seconds()
            self.metrics.histogram("trial_sec").observe(sec)
        if error is not None:
            self.metrics.counter("trials.errors").inc()
            self.obs_events.emit(TRIAL_FINISHED, trial["tid"],
                                 status="error", sec=sec)
        else:
            self.metrics.counter("trials.completed").inc()
            self.obs_events.emit(TRIAL_FINISHED, trial["tid"],
                                 status=(result or {}).get("status", "ok"),
                                 sec=sec)

    def checkpoint_trial(self, doc):
        """Ctrl.checkpoint hook: stamp the partial result under the lock so
        the driver thread never reads a half-written doc (docs are shared
        in-process; the stamp is the persistence)."""
        with self._lock:
            doc["refresh_time"] = coarse_utcnow()

    def _cancel_timed_out(self):
        """RUNNING → CANCEL for trials past their MONOTONIC deadline
        (SparkTrials timeout policy: hyperopt/spark.py sym: _FMinState
        timeout handling).  Runs under the driver's poll cadence.

        Deadlines are stamped at claim time from ``time.monotonic`` — the
        old wall-clock ``now - book_time`` arithmetic meant an NTP step or
        a laptop resume could instantly "age" every healthy RUNNING trial
        past its budget and mass-cancel them.  A RUNNING trial with no
        recorded deadline (resumed from a checkpoint: monotonic values are
        meaningless across processes/boots) is granted a fresh full budget
        on first sight rather than cancelled on a clock it never saw."""
        if self.timeout is None:
            return
        with self._lock:
            now_mono = self._monotonic()
            now = coarse_utcnow()
            for t in self._dynamic_trials:
                if t["state"] != JOB_STATE_RUNNING or t.get("book_time") is None:
                    continue
                deadline = self._deadlines.get(t["tid"])
                if deadline is None:
                    self._deadlines[t["tid"]] = now_mono + self.timeout
                    continue
                if now_mono >= deadline:
                    t["state"] = JOB_STATE_CANCEL
                    # merge, don't overwrite: a Ctrl.checkpoint partial
                    # result must survive cancellation
                    t["result"] = {**(t.get("result") or {}), "status": STATUS_FAIL}
                    t["misc"]["error"] = (
                        "Cancelled",
                        f"trial exceeded per-trial timeout {self.timeout}s",
                    )
                    t["refresh_time"] = now
                    self._deadlines.pop(t["tid"], None)
                    self.metrics.counter("trials.timeouts").inc()
                    self.obs_events.emit(TRIAL_CANCELLED, t["tid"],
                                         reason="trial_timeout")
                    logger.warning("trial %s cancelled after %ss timeout",
                                   t["tid"], self.timeout)

    def cancel_unfinished(self):
        """Move every NEW/RUNNING trial to CANCEL — called by FMinIter when
        the fmin-level timeout expires so the driver never blocks on a hung
        in-flight objective (hyperopt/spark.py: job-group cancellation)."""
        with self._lock:
            for t in self._dynamic_trials:
                if t["state"] in (JOB_STATE_NEW, JOB_STATE_RUNNING):
                    t["state"] = JOB_STATE_CANCEL
                    t["result"] = {**(t.get("result") or {}), "status": STATUS_FAIL}
                    t["misc"]["error"] = ("Cancelled", "fmin timeout")
                    t["refresh_time"] = coarse_utcnow()
                    self._deadlines.pop(t["tid"], None)
                    self.metrics.counter("trials.cancelled").inc()
                    self.obs_events.emit(TRIAL_CANCELLED, t["tid"],
                                         reason="fmin_timeout")

    def _run_one(self, trial):
        """Evaluate one claimed trial (MongoWorker.run_one analog), with
        the per-trial retry policy: a raising objective re-runs in place
        after a jittered exponential backoff, up to ``retry.max_retries``
        extra attempts, the attempt count recorded in
        ``misc['attempts']``.  A trial cancelled (timeout / fmin timeout)
        between attempts is NOT retried — the state-level cancel guarantee
        outranks the retry budget."""
        domain = self._get_domain()
        if domain is None or not self._claim(trial):
            return
        self._worker_busy(+1)
        # per-trial progress beats feed the stall watchdog: an objective
        # hung past "start" with no "finish" shows up by name in the
        # stall report's last-heartbeat table
        _wd_beat("executor.trial", tid=trial["tid"], mark="start")
        t0 = time.perf_counter()
        try:
            spec = spec_from_misc(trial["misc"])
            attempt = 0
            while True:
                with self._lock:
                    if trial["state"] != JOB_STATE_RUNNING:
                        # cancelled during the backoff sleep (trial or
                        # fmin timeout): the doc is already terminal —
                        # re-evaluating would burn a full objective run
                        # whose result _finish must then discard
                        self.metrics.counter("results.discarded").inc()
                        break
                trial["misc"]["attempts"] = attempt + 1
                try:
                    result = domain.evaluate(
                        spec, Ctrl(self, current_trial=trial))
                except Exception as e:  # crash must not kill the driver
                    with self._lock:
                        cancelled = trial["state"] != JOB_STATE_RUNNING
                    if cancelled or not self.retry.retries_left(attempt + 1):
                        logger.error("async job exception: %s", e)
                        self._finish(trial, error=e)
                        break
                    delay = self.retry.delay(attempt, key=trial["tid"])
                    self.metrics.counter("trials.retries").inc()
                    self.metrics.histogram("retry.backoff_sec").observe(delay)
                    logger.warning(
                        "trial %s attempt %d failed (%s); retrying in %.2fs",
                        trial["tid"], attempt + 1, e, delay)
                    self._sleep(delay)
                    attempt += 1
                else:
                    self._finish(trial, result=result)
                    break
        finally:
            self.metrics.counter("worker_busy_sec").inc(
                time.perf_counter() - t0)
            self._worker_busy(-1)
            _wd_beat("executor.trial", tid=trial["tid"], mark="finish")

    def _run_batch(self, trials_batch):
        """Evaluate a queue of trials as ONE vmapped device program: the
        flat batch is built as tensors on the trials' device."""
        domain = self._get_domain()
        if domain is None:
            return
        claimed = [t for t in trials_batch if self._claim(t)]
        if not claimed:
            return
        self._worker_busy(+1)
        _wd_beat("executor.batch", n=len(claimed), mark="start")
        t0 = time.perf_counter()
        self.metrics.counter("batch_evals").inc()
        try:
            try:
                if self._batch_eval_cache is None:
                    self._batch_eval_cache = domain.make_batch_eval()
                labels = domain.cs.labels
                specs = [spec_from_misc(t["misc"]) for t in claimed]
                flat_batch = {
                    l: torch.as_tensor(
                        np.array([s.get(l, 0.0) for s in specs], np.float32)
                        if not domain.cs.params[l].is_int
                        else np.array([int(s.get(l, 0)) for s in specs], np.int32),
                        device=self.device)
                    for l in labels
                }
                losses = self._batch_eval_cache(flat_batch).detach().to(
                    "cpu", torch.float64).numpy()
            except Exception as e:
                logger.error("batched async eval exception: %s", e)
                for t in claimed:
                    self._finish(t, error=e)
                return
            for t, loss in zip(claimed, losses):
                if np.isfinite(loss):
                    self._finish(t, result={"loss": float(loss), "status": STATUS_OK})
                else:
                    self._finish(t, error=ValueError(f"non-finite loss {loss}"))
        finally:
            self.metrics.counter("worker_busy_sec").inc(
                time.perf_counter() - t0)
            self._worker_busy(-1)
            _wd_beat("executor.batch", n=len(claimed), mark="finish")

    # -- Trials overrides --------------------------------------------------

    def _dispatch(self, docs):
        """Submit NEW, not-yet-dispatched docs to the pool exactly once.

        Docs inserted before the domain attachment exists are left
        undispatched; ``refresh()`` picks them up later (the Mongo-worker
        poll-again analog) — so each doc is submitted once, not O(all-NEW)
        per insert/refresh.
        """
        if not docs or self._get_domain() is None:
            return
        with self._lock:
            todo = [
                d
                for d in docs
                if d["state"] == JOB_STATE_NEW and d["tid"] not in self._dispatched
            ]
            self._dispatched.update(d["tid"] for d in todo)
        if not todo:
            return
        self.metrics.counter("dispatched").inc(len(todo))
        pool = self._get_pool()
        if self.traceable and len(todo) > 1:
            pool.submit(self._run_batch, todo)
        else:
            for trial in todo:
                pool.submit(self._run_one, trial)

    def insert_trial_docs(self, docs):
        with self._lock:
            tids = super().insert_trial_docs(docs)
            inserted = self._dynamic_trials[-len(docs):] if len(docs) else []
        for d in inserted:
            self.obs_events.emit(TRIAL_NEW, d["tid"])
        self._dispatch(inserted)
        return tids

    def refresh(self):
        self._cancel_timed_out()
        with self._lock:
            super().refresh()
            pending = [
                d
                for d in self._dynamic_trials
                if d["state"] == JOB_STATE_NEW and d["tid"] not in self._dispatched
            ]
            n_queued = sum(
                1 for d in self._dynamic_trials
                if d["state"] in (JOB_STATE_NEW, JOB_STATE_RUNNING)
            )
        self.metrics.gauge("queue_depth").set(n_queued)
        self._dispatch(pending)

    def delete_all(self):
        with self._lock:
            self._dispatched = set()
            super().delete_all()

    def count_by_state_unsynced(self, arg):
        self._cancel_timed_out()
        with self._lock:
            return super().count_by_state_unsynced(arg)

    def shutdown(self, wait=True):
        if self._pool is not None:
            # cancel_futures: queued-but-unstarted work is dropped; running
            # threads (possibly hung user objectives) are not joined when
            # wait=False — their results land in already-terminal docs and
            # are discarded by _finish
            self._pool.shutdown(wait=wait, cancel_futures=not wait)
            self._pool = None

    # pickle: drop pool/lock/caches along with base-class exclusions
    def __getstate__(self):
        state = super().__getstate__()
        state["_pool"] = None
        state["_lock"] = None
        state["_domain_cache"] = None
        state["_batch_eval_cache"] = None
        # a resumed process has no workers yet: NEW docs must redispatch there
        state["_dispatched"] = set()
        # monotonic deadlines are meaningless in another process/boot:
        # _cancel_timed_out re-stamps resumed RUNNING trials on first sight
        state["_deadlines"] = {}
        state["_monotonic"] = None
        state["_sleep"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.RLock()
        self._monotonic = time.monotonic
        self._sleep = time.sleep
        # checkpoints written by older versions predate these attributes
        self.__dict__.setdefault("_dispatched", set())
        self.__dict__.setdefault("_deadlines", {})
        self.__dict__.setdefault("retry", RetryPolicy(0))
        self.__dict__.setdefault(
            "metrics", MetricsRegistry(f"executor-{next(_instance_ids)}"))
        self.__dict__.setdefault("obs_events", EventLog())
        self.__dict__.setdefault("_busy", 0)
