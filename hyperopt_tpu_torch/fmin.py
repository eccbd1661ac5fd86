"""``fmin`` and its ask→tell loop (counterpart of
``hyperopt_tpu/fmin.py``; parity target ``hyperopt/fmin.py`` sym: fmin,
FMinIter, space_eval, generate_trials_to_calculate,
fmin_pass_expr_memo_ctrl).

The loop is host-side control; the suggesters run on the trials' device,
which is the CUDA card unless the caller passes ``device="cpu"``.  With
``device_loop`` a traceable objective's whole ask→tell chain runs on that
device instead (``device_fmin``).  An asynchronous trials backend
(``FileTrials``, ``ExecutorTrials``) evaluates elsewhere: the loop then
only asks, inserts and polls.  Every run carries an ``obs.RunObs``
(spans, metrics, trial events, heartbeats; the JSONL stream, the scrape
server, device captures and device-memory samples when armed).
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import pickle
import time

import numpy as np

from . import obs as obs_mod
from . import progress as progress_mod
from ._env import resolve_device
from .base import (
    Ctrl,
    Domain,
    JOB_STATE_DONE,
    JOB_STATE_ERROR,
    JOB_STATE_NEW,
    JOB_STATE_RUNNING,
    STATUS_OK,
    Trials,
    spec_from_misc,
    trials_from_docs,
)
from .exceptions import AllTrialsFailed
from .spaces import space_eval  # noqa: F401  (re-export, reference parity)
from .utils import coarse_utcnow

__all__ = [
    "fmin",
    "FMinIter",
    "PhaseTimings",
    "space_eval",
    "fmin_pass_expr_memo_ctrl",
    "generate_trials_to_calculate",
    "partial",
]

logger = logging.getLogger(__name__)

# the tracer's aggregate view (obs/trace.py), re-exported as the JAX
# package does, and functools.partial for ``from ... fmin import partial``
PhaseTimings = obs_mod.PhaseTimings
partial = functools.partial


def fmin_pass_expr_memo_ctrl(f):
    """Decorator: objective wants (expr, memo, ctrl) instead of a sampled point."""
    f.fmin_pass_expr_memo_ctrl = True
    return f


def generate_trial(tid, space_points):
    """One NEW trial doc pinning explicit hyperparameter values."""
    variables = space_points.keys()
    return {
        "state": JOB_STATE_NEW,
        "tid": tid,
        "spec": None,
        "result": {"status": "new"},
        "misc": {
            "tid": tid,
            "cmd": ("domain_attachment", "FMinIter_Domain"),
            "idxs": {v: [tid] for v in variables},
            "vals": {v: [space_points[v]] for v in variables},
        },
        "exp_key": None,
        "owner": None,
        "version": 0,
        "book_time": None,
        "refresh_time": None,
    }


def generate_trials_to_calculate(points, device=None):
    """Trials pre-loaded with explicit points (``points_to_evaluate``)."""
    return trials_from_docs([generate_trial(tid, x) for tid, x in enumerate(points)],
                            device=device)


class FMinIter:
    """The ask→tell loop: ask the suggester for new trials, insert them,
    evaluate them (in-process, or by polling an asynchronous backend's
    workers), check the stop conditions, optionally checkpoint.
    ``lookahead=N`` keeps up to N asks in flight, dispatched before the
    current trials evaluate (pending trials contribute no loss to the
    posterior); ``lookahead=0`` is the synchronous loop."""

    catch_eval_exceptions = False
    pickle_protocol = -1

    def __init__(self, algo, domain, trials, rstate, asynchronous=None,
                 max_queue_len=None, poll_interval_secs=None,
                 max_evals=float("inf"), timeout=None, loss_threshold=None,
                 verbose=False, show_progressbar=True, early_stop_fn=None,
                 trials_save_file="", lookahead=0, device_loop=False,
                 obs=None, obs_http=None, profile=None, compile_cache=None):
        if compile_cache is not None:
            from ._build import set_build_dir

            set_build_dir(compile_cache)
        self.device_loop = device_loop
        self.algo = algo
        self.domain = domain
        self.trials = trials
        self.asynchronous = trials.asynchronous if asynchronous is None else asynchronous
        self.rstate = rstate
        # explicit argument > the backend's own depth (an executor keeps its
        # pool busy) > 1
        if max_queue_len is None:
            max_queue_len = getattr(trials, "default_max_queue_len", 1)
        self.max_queue_len = max_queue_len
        if self.max_queue_len != float("inf"):
            from .algos.rand import pad_ids_pow2

            b = len(pad_ids_pow2([0], min_bucket=min(int(self.max_queue_len), 64)))
            domain._ids_bucket = max(getattr(domain, "_ids_bucket", 1), b)
        # explicit argument > the backend's cadence > 1 s
        if poll_interval_secs is None:
            poll_interval_secs = getattr(trials, "poll_interval_secs", 1.0)
        self.poll_interval_secs = poll_interval_secs
        self.max_evals = max_evals
        # the eval budget for budget-aware suggesters (aTPE's
        # featurize_trials): the suggest protocol has no budget argument
        if max_evals != float("inf"):
            trials.max_evals_hint = int(max_evals)
        self.timeout = timeout
        self.loss_threshold = loss_threshold
        self.start_time = time.time()
        self.early_stop_fn = early_stop_fn
        self.trials_save_file = trials_save_file
        self.verbose = verbose
        self.show_progressbar = show_progressbar
        self.early_stop_args = []
        self.lookahead = int(lookahead)
        if self.lookahead < 0:
            raise ValueError(f"lookahead must be >= 0, got {lookahead}")
        self._algo_async = self._resolve_async_algo()
        if self.lookahead > 0:
            if self.asynchronous:
                raise ValueError(
                    "lookahead > 0 applies to the serial in-process loop "
                    "only — an asynchronous Trials backend already "
                    "overlaps evaluation with asks via max_queue_len")
            if self._algo_async is None:
                raise ValueError(
                    "lookahead > 0 requires a suggester with an async "
                    "dispatch/readback split (tpe.suggest or rand.suggest, "
                    "optionally functools.partial-tuned)")
        self._arm_obs(obs, obs_http, profile)
        if self.asynchronous:
            # workers in other threads or processes load the domain from
            # this blob (misc.cmd = ('domain_attachment', 'FMinIter_Domain'))
            if "FMinIter_Domain" not in trials.attachments:
                import cloudpickle

                trials.attachments["FMinIter_Domain"] = cloudpickle.dumps(domain)
        else:
            trials.attachments["FMinIter_Domain"] = domain

    def _arm_obs(self, obs, obs_http, profile):
        """The run's telemetry bundle: ``obs`` (None: the environment, a
        path, an ``ObsConfig`` or a built ``RunObs``) with ``obs_http`` /
        ``profile`` on top, its tracer aggregating into
        ``trials.phase_timings``; the handles go onto the trials
        (``obs_run_id``, ``obs_metrics``, ``obs_http_url``,
        ``obs_profiler`` and, for an armed stream, ``obs_health``, which
        switches TPE to its health-instrumented tick)."""
        trials = self.trials
        if obs_http is not None or profile is not None:
            if isinstance(obs, obs_mod.RunObs):
                logger.warning(
                    "obs_http=%r / profile=%r ignored: obs= is a pre-built RunObs "
                    "(set http_port/profile_dir on its ObsConfig instead)",
                    obs_http, profile)
            else:
                import dataclasses

                from .obs.profiler import split_profile_mode

                overrides = {}
                if obs_http is not None:
                    overrides["http_port"] = obs_http
                if profile is not None:
                    cap_dir, full_dir = split_profile_mode(str(profile))
                    overrides["profile_dir"] = cap_dir
                    overrides["profile_full"] = full_dir
                obs = dataclasses.replace(obs_mod.ObsConfig.resolve(obs), **overrides)
        if not hasattr(trials, "phase_timings"):
            trials.phase_timings = PhaseTimings()
        self.obs = obs_mod.RunObs.resolve(obs, totals=trials.phase_timings)
        trials.obs_run_id = self.obs.run_id
        trials.obs_metrics = self.obs.metrics
        trials.obs_http_url = self.obs.http.url if self.obs.http is not None else None
        trials.obs_profiler = self.obs.profiler
        trials.obs_health = self.obs if self.obs.sink is not None else None

    def _resolve_async_algo(self):
        """An ``(ids, domain, trials, seed) -> AskHandle`` dispatcher when
        the algo is tpe.suggest or rand.suggest (possibly
        ``functools.partial``-tuned), else None."""
        from .algos import rand as _rand
        from .algos import tpe as _tpe

        algo, kwargs = self.algo, {}
        while isinstance(algo, functools.partial):
            if algo.args:
                return None
            for k, v in (algo.keywords or {}).items():
                kwargs.setdefault(k, v)
            algo = algo.func
        if algo is _tpe.suggest:
            return lambda ids, dom, tr, s: _tpe.suggest_async(ids, dom, tr, s, **kwargs)
        if algo is _rand.suggest and not kwargs:
            return _rand.suggest_async
        return None

    def serial_evaluate(self, N=-1):
        """Evaluate queued NEW trials in-process."""
        for trial in self.trials._dynamic_trials:
            if trial["state"] != JOB_STATE_NEW:
                continue
            trial["state"] = JOB_STATE_RUNNING
            trial["book_time"] = coarse_utcnow()
            self.obs.trial_event(obs_mod.events_mod.TRIAL_CLAIMED, trial["tid"],
                                 owner="serial")
            # a hang past this beat is the objective: the watchdog's stall
            # report names the trial that wedged the loop
            self.obs.heartbeat("fmin.evaluate", tid=trial["tid"])
            spec = spec_from_misc(trial["misc"])
            ctrl = Ctrl(self.trials, current_trial=trial)
            t0 = time.perf_counter()
            try:
                result = self.domain.evaluate(spec, ctrl)
            except Exception as e:
                logger.error("job exception: %s", e)
                trial["state"] = JOB_STATE_ERROR
                trial["misc"]["error"] = (str(type(e)), str(e))
                trial["refresh_time"] = coarse_utcnow()
                self.obs.trial_event(obs_mod.events_mod.TRIAL_FINISHED, trial["tid"],
                                     status="error", sec=time.perf_counter() - t0)
                self.obs.counter("trials.errors").inc()
                if not self.catch_eval_exceptions:
                    self.trials.refresh()
                    raise
            else:
                trial["state"] = JOB_STATE_DONE
                trial["result"] = result
                trial["refresh_time"] = coarse_utcnow()
                self.obs.trial_event(obs_mod.events_mod.TRIAL_FINISHED, trial["tid"],
                                     status=result.get("status", "ok"),
                                     sec=time.perf_counter() - t0)
                self.obs.counter("trials.completed").inc()
            N -= 1
            if N == 0:
                break
        self.trials.refresh()

    def block_until_done(self):
        """Poll an asynchronous backend until no NEW/RUNNING trials remain
        (hyperopt/fmin.py sym: FMinIter.block_until_done).  Once the
        ``timeout`` has expired, in-flight trials are cancelled (the
        backend's ``cancel_unfinished``) instead of waited on, so a hung
        objective never wedges the driver."""
        if not self.asynchronous:
            self.serial_evaluate()
            return
        unfinished_states = [JOB_STATE_NEW, JOB_STATE_RUNNING]

        def timed_out():
            return (self.timeout is not None
                    and time.time() - self.start_time >= self.timeout)

        cancel = getattr(self.trials, "cancel_unfinished", None)
        if timed_out() and cancel is not None:
            cancel()
        qlen = self.trials.count_by_state_unsynced(unfinished_states)
        already_printed = False
        while qlen > 0:
            if not already_printed and self.verbose:
                logger.info("Waiting for %d jobs to finish ...", qlen)
                already_printed = True
            self.obs.heartbeat("fmin.drain", qlen=qlen)
            time.sleep(self.poll_interval_secs)
            if timed_out() and cancel is not None:
                cancel()
            qlen = self.trials.count_by_state_unsynced(unfinished_states)
        self.trials.refresh()

    def run(self, N, block_until_done=True):
        # a re-entered run (iterator protocol) re-adopts its metrics
        # namespace after the previous leg's finish()
        self.obs.rearm()
        with self.obs.profiler_ctx(), self.obs.span(
                "run", aggregate=False, N=N if N != float("inf") else "inf",
                device_loop=bool(self.device_loop)):
            try:
                # this thread serves the capture plane at its tick boundaries
                with self.obs.loop():
                    self._run(N, block_until_done)
            finally:
                # one metrics snapshot record per run(): a killed stream
                # still ends with the latest full picture
                self.obs.finish()

    def _run(self, N, block_until_done=True):
        if self.device_loop:
            plan, reasons = self._device_loop_plan()
            if plan is not None:
                return self._run_device(N, plan)
            if self.device_loop is True:
                raise ValueError("device_loop=True requested but the run is ineligible: "
                                 + "; ".join(reasons))
            logger.info("device_loop='auto': using host loop (%s)", "; ".join(reasons))
        trials = self.trials
        algo = self.algo
        async_algo = self._algo_async
        inflight = []  # speculative AskHandles, FIFO, scoped to this run
        n_queued = 0

        def get_queue_len():
            return trials.count_by_state_unsynced(JOB_STATE_NEW)

        def get_n_done():
            return trials.count_by_state_unsynced(JOB_STATE_DONE)

        def get_n_unfinished():
            return trials.count_by_state_unsynced([JOB_STATE_NEW, JOB_STATE_RUNNING])

        def next_seed():
            return (self.rstate.integers(2**31 - 1)
                    if hasattr(self.rstate, "integers")
                    else self.rstate.randint(2**31 - 1))

        stopped = False
        n_reported = get_n_done()
        tick = 0  # ask→tell tick ordinal: the capture timeline's step id
        obs = self.obs
        with progress_mod.get_progress_callback(self.show_progressbar)(
            initial=n_reported, total=self.max_evals
        ) as progress_ctx:
            all_trials_complete = False
            best_loss = float("inf")

            def land(new_trials):
                """Insert freshly-asked docs; False = suggester is done."""
                nonlocal n_queued, qlen, stopped
                obs.counter("suggest.calls").inc()
                if not len(new_trials):
                    stopped = True
                    return False
                for doc in new_trials:
                    obs.trial_event(obs_mod.events_mod.TRIAL_NEW, doc["tid"])
                obs.counter("trials.suggested").inc(len(new_trials))
                trials.insert_trial_docs(new_trials)
                trials.refresh()
                n_queued += len(new_trials)
                qlen = get_queue_len()
                obs.gauge("queue_depth").set(qlen)
                return True

            while n_queued < N or (block_until_done and not all_trials_complete):
                # one beat, one device-memory sample and one capture-plane
                # boundary per tick
                tick += 1
                obs.heartbeat("fmin.tick", n_queued=n_queued)
                obs.devmem_sample()
                obs.boundary()
                qlen = get_queue_len()
                while inflight and qlen < self.max_queue_len and n_queued < N:
                    handle = inflight.pop(0)
                    obs.gauge("suggest.inflight").set(len(inflight))
                    t_ask = time.perf_counter()
                    with self.obs.span("suggest"), self.obs.span("suggest.readback"):
                        new_trials = handle.result()
                    obs.histogram("ask.blocked_sec").observe(time.perf_counter() - t_ask)
                    if not land(new_trials):
                        break
                while qlen < self.max_queue_len and n_queued < N and not stopped:
                    n_to_enqueue = min(self.max_queue_len - qlen, N - n_queued)
                    new_ids = trials.new_trial_ids(n_to_enqueue)
                    trials.refresh()
                    t_ask = time.perf_counter()
                    # a capture overlapping this ask shows its kernels under
                    # the tick ordinal and the trial ids it proposed
                    with obs.annotate("fmin.tick", step=tick,
                                      tid=new_ids[0] if len(new_ids) else -1,
                                      n=len(new_ids)), self.obs.span("suggest"):
                        if async_algo is not None:
                            with self.obs.span("suggest.dispatch"):
                                handle = async_algo(new_ids, self.domain, trials,
                                                    next_seed())
                            with self.obs.span("suggest.readback"):
                                new_trials = handle.result()
                        else:
                            new_trials = algo(new_ids, self.domain, trials, next_seed())
                    obs.histogram("ask.blocked_sec").observe(time.perf_counter() - t_ask)
                    if len(new_trials) > len(new_ids):
                        raise ValueError("suggester returned more trials than ids")
                    if not land(new_trials):
                        break

                if self.lookahead and async_algo is not None and not stopped:
                    while len(inflight) < self.lookahead:
                        k = min(self.max_queue_len,
                                N - n_queued - sum(len(h.new_ids) for h in inflight))
                        if not (k >= 1 and k != float("inf")):
                            break
                        new_ids = trials.new_trial_ids(int(k))
                        trials.refresh()
                        # dispatch only: the landing readback carries the
                        # ask's one "suggest" span
                        with obs.annotate("fmin.tick.speculative", step=tick,
                                          tid=new_ids[0] if len(new_ids) else -1,
                                          n=len(new_ids)), \
                                self.obs.span("suggest.dispatch"):
                            inflight.append(async_algo(new_ids, self.domain, trials,
                                                       next_seed()))
                        obs.counter("suggest.speculative").inc()
                        obs.gauge("suggest.inflight").set(len(inflight))

                if self.asynchronous:
                    with self.obs.span("poll"):
                        time.sleep(self.poll_interval_secs)  # workers fill in the trials
                else:
                    with self.obs.span("evaluate"):
                        self.serial_evaluate()
                with self.obs.span("refresh"):
                    trials.refresh()
                if self.trials_save_file != "":
                    with self.obs.span("save"):
                        self._save_trials()

                if self.early_stop_fn is not None:
                    stop, kwargs = self.early_stop_fn(trials, *self.early_stop_args)
                    self.early_stop_args = kwargs
                    if stop:
                        logger.info("Early stop triggered")
                        stopped = True

                ok_losses = [r["loss"] for r in trials.results
                             if r.get("status") == STATUS_OK and r.get("loss") is not None]
                if ok_losses:
                    best_loss = min(best_loss, min(ok_losses))
                    # the scrape server reads the best loss from this gauge
                    obs.gauge("best_loss").set(float(best_loss))
                    progress_ctx.postfix = progress_mod.format_postfix(best_loss, obs)
                n_done_now = get_n_done()
                progress_ctx.update(n_done_now - n_reported)
                n_reported = n_done_now

                if self.timeout is not None and time.time() - self.start_time >= self.timeout:
                    stopped = True
                if self.loss_threshold is not None and best_loss <= self.loss_threshold:
                    stopped = True

                all_trials_complete = get_n_unfinished() == 0
                if stopped and (not block_until_done or all_trials_complete):
                    break
                if stopped and block_until_done:
                    self.block_until_done()
                    break

    def _device_loop_plan(self):
        """``(plan, reasons)``: plan is ``(tpe cfg, n_startup)`` when the run
        can take the device loop, else None with the reasons it cannot: a
        synchronous queue-1 run with a bounded budget, no lookahead, no
        history but its own device loop's, a tpe/rand suggester (possibly
        ``functools.partial``-tuned), and an objective the meta probe
        (``device_fmin.objective_is_traceable``) accepts."""
        from .algos import rand as _rand
        from .algos import tpe as _tpe
        from .device_fmin import objective_is_traceable

        reasons = []
        if getattr(self.trials, "asynchronous", False):
            reasons.append("asynchronous trials backend")
        if self.max_queue_len != 1:
            reasons.append("max_queue_len != 1 (host loop already amortizes)")
        if self.max_evals == float("inf"):
            reasons.append("unbounded max_evals")
        if self.lookahead:
            reasons.append("lookahead > 0 (host-loop speculation; the "
                           "device loop pipelines on device already)")
        # a history this iter's own device loop wrote is resumable (its
        # device-side state is kept on self); any other is not
        if len(self.trials) != getattr(self, "_device_n_done", 0):
            reasons.append("non-empty trials (resume is host-loop only)")
        algo, kwargs = self.algo, {}
        while isinstance(algo, functools.partial):
            for k, v in (algo.keywords or {}).items():
                kwargs.setdefault(k, v)
            algo = algo.func
        if algo not in (_tpe.suggest, _rand.suggest):
            reasons.append("algo is not tpe.suggest / rand.suggest")
        allowed = {"prior_weight", "n_startup_jobs", "n_EI_candidates", "gamma",
                   "linear_forgetting", "ei_select", "ei_tau", "prior_eps"}
        unknown = set(kwargs) - allowed
        if unknown:
            reasons.append(f"unsupported algo kwargs {sorted(unknown)}")
        if not reasons and not objective_is_traceable(self.domain):
            reasons.append("objective does not trace to a scalar float")
        if reasons:
            return None, reasons
        # tpe's own defaults, so the host and device loops are one optimizer
        cfg = {
            "prior_weight": float(kwargs.get("prior_weight", _tpe._default_prior_weight)),
            "n_EI_candidates": int(kwargs.get("n_EI_candidates",
                                              _tpe._default_n_EI_candidates)),
            "gamma": float(kwargs.get("gamma", _tpe._default_gamma)),
            "LF": int(kwargs.get("linear_forgetting", _tpe._default_linear_forgetting)),
        }
        for k in ("ei_select", "ei_tau", "prior_eps"):
            if k in kwargs:
                cfg[k] = kwargs[k]
        n_startup = (int(self.max_evals) if algo is _rand.suggest
                     else int(kwargs.get("n_startup_jobs", _tpe._default_n_startup_jobs)))
        return (cfg, n_startup), []

    def _run_device(self, N, plan):
        """The device-stepped queue-1 loop: ``CHUNK`` fresh-posterior
        trials per call of ``device_fmin.DeviceLoopRunner``, one readback
        each; reference-shaped docs, and the timeout, early stop, loss
        threshold and checkpoint at chunk granularity.  A later ``run()``
        continues from the device-side state this one leaves.  A chunk's
        spans: ``suggest`` (the runner's ``suggest.dispatch`` and
        ``suggest.readback`` inside it), ``record`` (the documents, their
        trial events and the insert), ``refresh``, ``save`` and
        ``early_stop``."""
        from .algos import rand as _rand
        from .device_fmin import DeviceLoopRunner

        cfg, n_startup = plan
        trials = self.trials
        cs = self.domain.cs
        L = len(cs.labels)
        cap = int(self.max_evals)
        runner = DeviceLoopRunner(self.domain, cfg, n_startup, cap, device=trials.device,
                                  obs=self.obs)
        n_done = getattr(self, "_device_n_done", 0)
        state = self._device_state if n_done else runner.init_state()
        target = min(cap, n_done + int(N))
        stopped = False
        prior = [l for l in trials.losses() if l is not None] if n_done else []
        best_loss = min(prior) if prior else float("inf")
        with progress_mod.get_progress_callback(self.show_progressbar)(
            initial=n_done, total=self.max_evals
        ) as progress_ctx:
            while n_done < target and not stopped:
                self.obs.heartbeat("fmin.device_chunk", n_done=n_done)
                self.obs.devmem_sample()  # chunk-boundary watermark
                self.obs.boundary()
                limit = min(n_done + runner.CHUNK, target)
                seed = (self.rstate.integers(2**31 - 1)
                        if hasattr(self.rstate, "integers")
                        else self.rstate.randint(2**31 - 1))
                try:
                    with self.obs.span("suggest"):
                        state, rows = runner.run_chunk(state, n_done, limit, seed)
                except BaseException:
                    # a chunk that failed part way left the state half
                    # written: drop the resume handle, so a later run()
                    # checks eligibility again instead of continuing from it
                    self._device_state = None
                    self._device_n_done = 0
                    raise
                k = limit - n_done
                with self.obs.span("record"):
                    new_ids = trials.new_trial_ids(k)
                    now = coarse_utcnow()
                    flats = _rand.unpack_flats(cs, rows[:, :L], k)
                    docs = _rand.flat_to_new_trial_docs(self.domain, trials, new_ids, flats)
                    for j, doc in enumerate(docs):
                        loss = float(rows[j][2 * L])
                        if np.isfinite(loss):
                            best_loss = min(best_loss, loss)
                            doc["result"] = {"loss": loss, "status": STATUS_OK}
                        else:
                            doc["result"] = {"status": "fail"}
                        doc["state"] = JOB_STATE_DONE
                        doc["book_time"] = now
                        doc["refresh_time"] = now
                        self.obs.trial_event(obs_mod.events_mod.TRIAL_FINISHED, doc["tid"],
                                             status=doc["result"].get("status", "ok"),
                                             source="device_loop")
                    self.obs.counter("trials.completed").inc(len(docs))
                    trials.insert_trial_docs(docs)
                with self.obs.span("refresh"):
                    trials.refresh()
                n_done = limit
                if self.trials_save_file != "":
                    with self.obs.span("save"):
                        self._save_trials()
                if self.early_stop_fn is not None:
                    with self.obs.span("early_stop"):
                        stop, kw = self.early_stop_fn(trials, *self.early_stop_args)
                    self.early_stop_args = kw
                    if stop:
                        logger.info("Early stop triggered")
                        stopped = True
                if np.isfinite(best_loss):
                    self.obs.gauge("best_loss").set(float(best_loss))
                    progress_ctx.postfix = progress_mod.format_postfix(best_loss, self.obs)
                progress_ctx.update(k)
                if self.timeout is not None and time.time() - self.start_time >= self.timeout:
                    stopped = True
                if self.loss_threshold is not None and best_loss <= self.loss_threshold:
                    stopped = True
                self._device_state = state
                self._device_n_done = n_done

    def _save_trials(self):
        """Checkpoint trials atomically: write a temp file, then rename.
        An asynchronous backend's workers mutate docs concurrently, so
        serialize under the backend's lock when it has one."""
        lock = getattr(self.trials, "_lock", None)
        with lock if lock is not None else contextlib.nullcontext():
            payload = pickle.dumps(self.trials, protocol=self.pickle_protocol)
        tmp = self.trials_save_file + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, self.trials_save_file)

    def __iter__(self):
        return self

    def __next__(self):
        self.run(1, block_until_done=self.asynchronous)
        if len(self.trials) >= self.max_evals:
            raise StopIteration()
        return self.trials

    def exhaust(self):
        n_done = len(self.trials)
        self.run(self.max_evals - n_done, block_until_done=self.asynchronous)
        self.trials.refresh()
        return self


def fmin(
    fn,
    space,
    algo=None,
    max_evals=None,
    timeout=None,
    loss_threshold=None,
    trials=None,
    rstate=None,
    pass_expr_memo_ctrl=None,
    catch_eval_exceptions=False,
    verbose=False,
    return_argmin=True,
    points_to_evaluate=None,
    max_queue_len=None,
    show_progressbar=True,
    early_stop_fn=None,
    trials_save_file="",
    device_loop=False,
    obs=None,
    obs_http=None,
    profile=None,
    lookahead=0,
    compile_cache=None,
    device=None,
):
    """Minimize ``fn`` over ``space`` (hyperopt/fmin.py sym: fmin).

    Runs on the CUDA card unless ``device="cpu"`` (or a ``trials`` built
    for the CPU) is given; with no card and no such request it raises.
    ``rstate`` defaults to ``HYPEROPT_FMIN_SEED`` when set; ``verbose`` is
    accepted for the reference's signature and unused.

    ``device_loop``: ``True`` or ``"auto"`` runs the queue-1 loop as
    chunks of device steps (``device_fmin.DeviceLoopRunner``; CUDA-graph
    replays on a card) when the objective is written in torch ops, with
    the same fresh-posterior-per-trial semantics and one read-back per 10
    trials.  ``"auto"`` takes the host loop when the run is ineligible
    and logs why; ``True`` raises with the reasons.

    ``obs``: the run's telemetry — None reads the environment
    (``HYPEROPT_TPU_OBS`` and its family), a path streams spans, trial
    events, health records and a metrics snapshot to that JSONL file
    (``python -m hyperopt_tpu_torch.obs.report run.jsonl`` renders it), or
    an ``obs.ObsConfig`` / ``obs.RunObs``.  An armed stream switches TPE
    to its health-instrumented tick: the same proposals, bit for bit.

    ``obs_http``: port of the live scrape server (``/metrics``,
    ``/snapshot``, ``/events``, ``/profile?sec=N``); ``0`` binds an
    ephemeral port, read back from ``trials.obs_http_url``.  Defaults to
    ``HYPEROPT_TPU_OBS_HTTP``; an occupied port warns and disables.

    ``profile``: a directory arming the bounded ``torch.profiler`` capture
    plane (``GET /profile?sec=N``, ``trials.obs_profiler.capture(sec)``,
    one capture on a watchdog stall; the loop records each capture on its
    own thread at its tick boundaries); ``"full:<dir>"`` profiles the
    whole run instead.  Defaults to ``HYPEROPT_TPU_PROFILE``.

    ``compile_cache``: a directory to build and load the CUDA kernel
    libraries in (``_build.set_build_dir``; default
    ``HYPEROPT_TPU_COMPILE_CACHE`` or ``build/`` beside the package): a
    later process naming it pays no ``nvcc`` compile."""
    if algo is None:
        from .algos import tpe

        algo = tpe.suggest

    if rstate is None:
        env_rseed = os.environ.get("HYPEROPT_FMIN_SEED", "")
        rstate = np.random.default_rng(int(env_rseed) if env_rseed else None)
    elif isinstance(rstate, (int, np.integer)):
        rstate = np.random.default_rng(int(rstate))

    validate_timeout(timeout)
    validate_loss_threshold(loss_threshold)

    if trials_save_file != "" and trials is None and os.path.exists(trials_save_file):
        with open(trials_save_file, "rb") as f:
            trials = pickle.load(f)

    if trials is None:
        if points_to_evaluate is None:
            trials = Trials(device=device)
        else:
            if not isinstance(points_to_evaluate, list):
                raise TypeError("points_to_evaluate must be a list of dicts")
            trials = generate_trials_to_calculate(points_to_evaluate, device=device)
    elif device is not None and resolve_device(device) != trials.device:
        raise ValueError(f"fmin(device={device!r}) but trials live on {trials.device}")

    domain = Domain(fn, space, pass_expr_memo_ctrl=pass_expr_memo_ctrl)
    rval = FMinIter(
        algo, domain, trials,
        max_evals=max_evals if max_evals is not None else float("inf"),
        timeout=timeout, loss_threshold=loss_threshold, rstate=rstate,
        verbose=verbose, max_queue_len=max_queue_len,
        show_progressbar=show_progressbar, early_stop_fn=early_stop_fn,
        trials_save_file=trials_save_file, lookahead=lookahead,
        device_loop=device_loop, obs=obs, obs_http=obs_http, profile=profile,
        compile_cache=compile_cache,
    )
    rval.catch_eval_exceptions = catch_eval_exceptions
    rval.exhaust()

    if return_argmin:
        if len(trials.trials) == 0:
            raise AllTrialsFailed(
                "There are no evaluation tasks, cannot return argmin of task losses.")
        return trials.argmin
    return None


def validate_timeout(timeout):
    if timeout is not None and (timeout <= 0 or isinstance(timeout, bool)):
        raise Exception(f"The timeout argument should be None or a positive value. Given value: {timeout}")


def validate_loss_threshold(loss_threshold):
    if loss_threshold is not None and not isinstance(loss_threshold, (int, float)):
        raise Exception(
            f"The loss_threshold argument should be None or a numeric value. Given value: {loss_threshold}"
        )
