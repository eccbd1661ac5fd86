"""Standalone evaluation worker over a FileStore (counterpart of
``hyperopt_tpu/worker.py``).  ``--device`` names where the worker's
objectives run: the CUDA card unless ``--device cpu``.

Parity target: ``hyperopt/mongoexp.py`` (sym: MongoWorker.run_one ≈L800-1000,
main_worker / main_worker_helper — the ``hyperopt-mongo-worker`` CLI).  A
worker process loops: reclaim stale claims → atomically reserve one NEW job →
unpickle the Domain from the store's ``FMinIter_Domain`` attachment →
evaluate with a heartbeat thread bumping ``refresh_time`` → write DONE/ERROR.
Exits after ``--max-consecutive-failures`` consecutive errors or
``--reserve-timeout`` seconds without work, exactly like the reference CLI.

Run as ``python -m hyperopt_tpu_torch.worker --store DIR [--device cpu]``.
"""

from __future__ import annotations

import argparse
import logging
import os
import socket
import sys
import threading
import time

from . import chaos
from ._env import resolve_device
from .base import Ctrl, JOB_STATE_NEW, JOB_STATE_RUNNING, spec_from_misc
from .filestore import FileStore, FileTrials, ReserveTimeout
from .obs.watchdog import beat as _wd_beat, get_watchdog
from .retry import RetryPolicy

__all__ = ["FileWorker", "main"]

logger = logging.getLogger(__name__)


class FileWorker:
    """One worker loop bound to a store (mongoexp.py sym: MongoWorker)."""

    def __init__(self, store_root, poll_interval=0.25, heartbeat_interval=2.0,
                 stale_after=30.0, workdir=None, retry=None, device=None):
        # where the objectives run (the trials handed to Ctrl live there):
        # the CUDA card unless device="cpu"; without a card this raises
        self.device = resolve_device(device)
        self.store = FileStore(store_root)
        self.store_root = store_root
        self.poll_interval = float(poll_interval)
        self.heartbeat_interval = float(heartbeat_interval)
        self.stale_after = float(stale_after)
        self.workdir = workdir
        # per-trial retry policy (retry.py): flaky objectives re-run in
        # place with jittered backoff while the heartbeat thread keeps the
        # claim fresh; None/0 keeps the fail-immediately reference behavior
        self.retry = RetryPolicy.coerce(retry)
        self.owner = f"{socket.gethostname()}:{os.getpid()}"
        self._domain = None
        # forensics: a SIGTERM'd/crashed worker dumps its flight ring into
        # the store's attachments (flight.<owner>.jsonl) — the driver can
        # post-mortem every worker that ever died on this store
        self.flight_dump = self.store.arm_flight(self.owner)
        # a worker IS a live run for its whole process lifetime: without
        # the retain, the run-scoped watchdog would never consider this
        # process active and stall detection would silently no-op here
        wd = get_watchdog()
        if wd is not None:
            wd.retain()

    def _get_domain(self):
        if self._domain is None:
            blob = self.store.get_attachment("FMinIter_Domain")
            if blob is None:
                return None
            import cloudpickle

            self._domain = cloudpickle.loads(blob)
        return self._domain

    def run_one(self, reserve_timeout=None):
        """Reserve and evaluate one job (mongoexp.py sym: MongoWorker.run_one).
        Raises ReserveTimeout if nothing could be claimed in time (a
        MONOTONIC deadline: an NTP step must not expire the poll early)."""
        deadline = (None if reserve_timeout is None
                    else time.monotonic() + reserve_timeout)
        while True:
            _wd_beat("worker.poll", owner=self.owner)
            try:
                self.store.reclaim_stale(self.stale_after)
                doc = self.store.reserve(self.owner)
            except OSError as e:
                # transient store I/O failure (NFS blip, chaos-injected):
                # a poll loop that dies on one bad write defeats the whole
                # reclaim story — log, back off a beat, poll again
                logger.warning("store I/O error while polling: %s", e)
                doc = None
            if doc is not None:
                break
            if deadline is not None and time.monotonic() >= deadline:
                raise ReserveTimeout(f"no job within {reserve_timeout}s")
            time.sleep(self.poll_interval)

        domain = self._get_domain()
        if domain is None:
            # job exists but the driver hasn't attached the domain yet: put
            # the claim back and wait
            doc["state"] = JOB_STATE_NEW
            doc["owner"] = None
            self.store.write_doc(doc)
            try:
                os.remove(self.store._path(JOB_STATE_RUNNING, doc["tid"]))
            except FileNotFoundError:
                pass
            time.sleep(self.poll_interval)
            return False

        stop = threading.Event()

        def beat():
            while not stop.wait(self.heartbeat_interval):
                try:
                    self.store.heartbeat(doc)
                except OSError as e:
                    # a failed heartbeat WRITE (chaos-injected or a real
                    # NFS blip) must not kill the beat loop: a skipped
                    # beat is recoverable (worst case a stale reclaim
                    # re-runs deterministic work), a silently-dead beat
                    # thread guarantees the reclaim
                    logger.warning("heartbeat write failed for %s: %s",
                                   doc["tid"], e)
                # the store heartbeat proves the THREAD is alive; this one
                # tells the stall watchdog which trial the worker is inside
                _wd_beat("worker.trial", tid=doc["tid"], owner=self.owner)

        hb = threading.Thread(target=beat, daemon=True,
                              name=f"hyperopt-heartbeat-{doc['tid']}")
        hb.start()
        error = None
        result = None
        try:
            spec = spec_from_misc(doc["misc"])
            trials = FileTrials(self.store_root, refresh=False,
                                device=self.device)
            ctrl = Ctrl(trials, current_trial=doc)
            attempt = 0
            while True:
                # per-trial retry loop (retry.py): the heartbeat thread
                # stays up across attempts and backoff sleeps, so the
                # claim never goes stale while the trial is being retried;
                # the attempt count rides the doc into the terminal state
                doc["misc"]["attempts"] = attempt + 1
                chaos.point("trial", metrics=self.store.metrics)
                try:
                    result = domain.evaluate(spec, ctrl)
                    error = None
                    break
                except Exception as e:
                    error = e
                    if not self.retry.retries_left(attempt + 1):
                        break
                    delay = self.retry.delay(
                        attempt, key=f"{self.owner}:{doc['tid']}")
                    self.store.metrics.counter("trials.retries").inc()
                    self.store.metrics.histogram(
                        "retry.backoff_sec").observe(delay)
                    logger.warning(
                        "job %s attempt %d failed (%s); retrying in %.2fs",
                        doc["tid"], attempt + 1, e, delay)
                    time.sleep(delay)
                    attempt += 1
        finally:
            # the heartbeat must be fully stopped on EVERY exit path —
            # including an objective exception or a raise from
            # spec/ctrl construction — BEFORE finish() removes
            # running/<tid>.pkl: a still-beating thread could pass its
            # existence check and resurrect the file, which a concurrent
            # reclaim_stale would later move back to NEW and re-evaluate a
            # finished (or deterministic-failure) trial
            stop.set()
            hb.join(timeout=30)
        if hb.is_alive():
            # a heartbeat write is stalled (e.g. hung NFS): finishing now
            # would re-open the resurrect race the join exists to close.
            # Leave the claim; reclaim_stale re-queues it once stale.
            logger.error("job %s: heartbeat thread stuck; leaving claim for "
                         "stale reclaim", doc["tid"])
            return False
        from .exceptions import StoreFullError

        attempt = 0
        while True:
            try:
                if error is not None:
                    logger.error("job %s failed: %s", doc["tid"], error)
                    self.store.finish(doc, error=error)
                    return False
                self.store.finish(doc, result=result)
                return True
            except StoreFullError as e:
                # a full disk is transient (the serving side
                # is compacting/GCing): back off and retry the terminal
                # write instead of dropping a finished result on the
                # floor — the evaluation is the expensive part
                if not self.retry.retries_left(attempt + 1):
                    logger.warning(
                        "store full finishing job %s after %d retries: "
                        "%s (claim left for stale/orphan recovery)",
                        doc["tid"], attempt, e)
                    return False
                delay = self.retry.delay(
                    attempt, key=f"enospc:{self.owner}:{doc['tid']}")
                self.store.metrics.counter("store.enospc_retries").inc()
                logger.warning("store full finishing job %s; retrying "
                               "in %.2fs (%s)", doc["tid"], delay, e)
                time.sleep(delay)
                attempt += 1
                continue
            except OSError as e:
                # the terminal write failed (NFS blip, chaos-injected):
                # the claim (running doc or orphaned *.finish.* rename)
                # is exactly what the stale-reclaim/orphan-sweep
                # machinery recovers — surviving here beats taking the
                # worker down with the store
                logger.warning("store I/O error finishing job %s: %s "
                               "(claim left for stale/orphan recovery)",
                               doc["tid"], e)
                return False


def main(argv=None):
    """CLI entry point (mongoexp.py sym: main_worker)."""
    p = argparse.ArgumentParser(prog="python -m hyperopt_tpu_torch.worker")
    p.add_argument("--store", required=True, help="FileStore directory")
    p.add_argument("--poll-interval", type=float, default=0.25)
    p.add_argument("--heartbeat-interval", type=float, default=2.0)
    p.add_argument("--stale-after", type=float, default=30.0,
                   help="reclaim RUNNING jobs with heartbeats older than this")
    p.add_argument("--max-consecutive-failures", type=int, default=4)
    p.add_argument("--reserve-timeout", type=float, default=120.0,
                   help="exit after this long without claiming a job")
    p.add_argument("--max-jobs", type=int, default=sys.maxsize)
    p.add_argument("--workdir", default=None)
    p.add_argument("--device", default="cuda",
                   help="where the objectives run (default: the CUDA card)")
    p.add_argument("--retries", type=int, default=None,
                   help="extra per-trial attempts after a raising objective "
                        "(jittered exponential backoff; default: "
                        "HYPEROPT_TPU_TRIAL_RETRIES or 0)")
    p.add_argument("--retry-base-delay", type=float, default=0.5,
                   help="base backoff before the first retry (doubles per "
                        "attempt, jittered)")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    retry = (RetryPolicy.from_env() if args.retries is None
             else RetryPolicy(max_retries=args.retries,
                              base_delay=args.retry_base_delay))
    worker = FileWorker(
        args.store,
        poll_interval=args.poll_interval,
        heartbeat_interval=args.heartbeat_interval,
        stale_after=args.stale_after,
        workdir=args.workdir,
        retry=retry,
        device=args.device,
    )
    consecutive_failures = 0
    done = 0
    while done < args.max_jobs:
        try:
            ok = worker.run_one(reserve_timeout=args.reserve_timeout)
        except ReserveTimeout:
            logger.info("reserve timeout; exiting")
            return 0
        if ok:
            consecutive_failures = 0
            done += 1
        else:
            consecutive_failures += 1
            if consecutive_failures >= args.max_consecutive_failures:
                logger.error("too many consecutive failures; exiting")
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
