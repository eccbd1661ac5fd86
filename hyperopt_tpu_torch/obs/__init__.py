"""hyperopt_tpu_torch.obs — run telemetry: spans, metrics, trial events
(counterpart of ``hyperopt_tpu/obs/``).

* :mod:`~hyperopt_tpu_torch.obs.trace` — nested spans (wall + CPU time,
  structured attrs) and the JSONL reader/writer.
* :mod:`~hyperopt_tpu_torch.obs.metrics` — process-global, per-namespace
  counters / gauges / bounded histograms with deterministic snapshots.
* :mod:`~hyperopt_tpu_torch.obs.events` — durable trial-lifecycle event
  log.
* :mod:`~hyperopt_tpu_torch.obs.flight` — always-on bounded ring of
  recent records, dumped on fatal signals, unhandled exceptions and
  atexit.
* :mod:`~hyperopt_tpu_torch.obs.watchdog` — stall detector over the
  heartbeats of every execution path.
* the run's planes: :mod:`~hyperopt_tpu_torch.obs.health` (search health,
  analytic kernel costs), :mod:`~hyperopt_tpu_torch.obs.profiler`
  (bounded ``torch.profiler`` captures), :mod:`~hyperopt_tpu_torch.obs.devmem`
  (device memory), :mod:`~hyperopt_tpu_torch.obs.serve` (the scrape
  server), :mod:`~hyperopt_tpu_torch.obs.report`,
  :mod:`~hyperopt_tpu_torch.obs.export` and
  :mod:`~hyperopt_tpu_torch.obs.trajectory`.
* the service's planes: :mod:`~hyperopt_tpu_torch.obs.reqtrace`,
  :mod:`~hyperopt_tpu_torch.obs.slo`, :mod:`~hyperopt_tpu_torch.obs.quality`,
  :mod:`~hyperopt_tpu_torch.obs.load` and :mod:`~hyperopt_tpu_torch.obs.tenant`.

The records are the JAX package's, line for line, so either package's
report reads what the other writes.  One flag arms a run:
``HYPEROPT_TPU_OBS=<run.jsonl>`` (or ``fmin(obs=...)``) streams JSONL; the
profile, scrape and device-memory planes ride the same :class:`ObsConfig`.
Render a run with::

    python -m hyperopt_tpu_torch.obs.report run.jsonl

The blackbox prober and the ``obs.top`` dashboard are not ported yet
(ROADMAP.md, queue 1, item 14b).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import logging
import os
import time

from . import events as events_mod
from .events import EventLog
from .flight import FlightRecorder, flight_path_for, get_flight
from .metrics import MetricsRegistry, adopt_metrics, get_metrics, reset_metrics
from .profiler import annotation_ctx
from .trace import JsonlSink, PhaseTimings, Tracer, iter_jsonl, read_jsonl
from .watchdog import Watchdog, get_watchdog

__all__ = [
    "ObsConfig",
    "RunObs",
    "Tracer",
    "JsonlSink",
    "PhaseTimings",
    "EventLog",
    "MetricsRegistry",
    "FlightRecorder",
    "Watchdog",
    "get_flight",
    "get_watchdog",
    "flight_path_for",
    "get_metrics",
    "reset_metrics",
    "adopt_metrics",
    "iter_jsonl",
    "read_jsonl",
]

logger = logging.getLogger(__name__)

_run_counter = itertools.count(1)


@dataclasses.dataclass
class ObsConfig:
    """Everything that arms a run's telemetry, in one object.

    ``level``:

    * ``"off"``   — no aggregation at all (phase timings still accumulate:
      they are load-bearing API, not telemetry).
    * ``"basic"`` — the default: in-memory metrics + phase totals, no I/O.
    * ``"trace"`` — additionally stream every span/event/metric snapshot to
      ``jsonl_path``.

    ``profile_dir`` arms the bounded device-capture plane
    (:mod:`~hyperopt_tpu_torch.obs.profiler`): programmatic /
    ``/profile?sec=N`` / stall-escalation ``torch.profiler`` captures land
    under this directory, and the fmin tick, device chunk and driver
    generation get ``record_function`` ids on the timeline.
    ``profile_full`` keeps one session over the whole run instead
    (``HYPEROPT_TPU_PROFILE=full:<dir>``) — the two are exclusive per run:
    a whole-run session would starve every bounded capture.

    ``flight_path`` pins the flight-recorder crash-dump path explicitly
    (``HYPEROPT_TPU_FLIGHT=<path>``); left None it derives from
    ``jsonl_path`` (``run.jsonl`` → ``run.flight.jsonl``) or, for fully
    disarmed runs, falls back to the recorder's cwd default on abnormal
    death only.  The ring itself is always on regardless of ``level``
    (disable the whole recorder with ``HYPEROPT_TPU_FLIGHT=0``).

    ``http_port`` arms the live scrape server (``obs/serve.py``:
    ``/metrics`` + ``/snapshot`` + ``/events``) — ``HYPEROPT_TPU_OBS_HTTP``
    or ``fmin(obs_http=<port>)``; 0 binds an ephemeral port, and a
    ``"host:port"`` string binds beyond the loopback default (remote
    Prometheus / cross-host ``obs.top``).
    ``devmem_period`` arms device-memory telemetry (``obs/devmem.py``)
    at that sample period in seconds — ``HYPEROPT_TPU_DEVMEM``.  Both are
    independent of ``level`` (registry scraping needs no JSONL stream) and
    both fail open: a bad env value or an occupied port warns once and
    disables.
    """

    level: str = "basic"
    jsonl_path: str | None = None
    profile_dir: str | None = None  # bounded-capture plane (obs/profiler.py)
    profile_full: str | None = None  # one session over the whole run
    run_id: str | None = None
    flight_path: str | None = None
    http_port: int | str | None = None  # port, or "host:port"
    devmem_period: float | None = None

    @classmethod
    def from_env(cls, env=None):
        from .._env import parse_devmem_period, parse_obs_http
        from .profiler import split_profile_mode

        env = os.environ if env is None else env
        raw = env.get("HYPEROPT_TPU_OBS", "").strip()
        profile_dir, profile_full = split_profile_mode(
            env.get("HYPEROPT_TPU_PROFILE", ""))
        raw_flight = env.get("HYPEROPT_TPU_FLIGHT", "").strip()
        # "0"/"off" (handled by flight.get_flight) and bare "1" are not
        # paths; anything else names the dump file
        flight_path = (raw_flight
                       if raw_flight not in ("", "0", "1", "off") else None)
        if raw in ("", "1", "basic"):
            level, jsonl_path = "basic", None
        elif raw in ("0", "off"):
            level, jsonl_path = "off", None
        else:  # a path arms the full trace stream
            level, jsonl_path = "trace", raw
        return cls(level=level, jsonl_path=jsonl_path,
                   profile_dir=profile_dir, profile_full=profile_full,
                   flight_path=flight_path,
                   http_port=parse_obs_http(env),
                   devmem_period=parse_devmem_period(env))

    @classmethod
    def resolve(cls, obs):
        """Normalize the ``obs=`` kwarg every entry point accepts: None →
        environment; a string → JSONL path at level "trace"; an ObsConfig →
        itself."""
        if obs is None:
            return cls.from_env()
        if isinstance(obs, cls):
            return obs
        if isinstance(obs, (str, os.PathLike)):
            env_cfg = cls.from_env()
            return cls(level="trace", jsonl_path=str(obs),
                       profile_dir=env_cfg.profile_dir,
                       profile_full=env_cfg.profile_full,
                       flight_path=env_cfg.flight_path,
                       http_port=env_cfg.http_port,
                       devmem_period=env_cfg.devmem_period)
        raise TypeError(f"obs must be None, a path, or ObsConfig; got {obs!r}")


class RunObs:
    """Per-run telemetry bundle: one tracer + one metrics namespace + one
    event log, all honoring one :class:`ObsConfig`.

    The registry namespace is ``run_id`` (process-global registry, per-run
    namespace), so concurrent runs in one process never mix counters while
    anything holding the run id can read the numbers back.
    """

    def __init__(self, config=None, totals=None, run_id=None):
        self.config = config if config is not None else ObsConfig.from_env()
        self.run_id = (run_id or self.config.run_id
                       or f"run-{next(_run_counter)}")
        armed = self.config.level == "trace" and self.config.jsonl_path
        self.sink = JsonlSink(self.config.jsonl_path) if armed else None
        self.tracer = Tracer(sink=self.sink, totals=totals,
                             run_id=self.run_id)
        self.metrics = get_metrics(self.run_id)
        self.events = EventLog(sink=self.sink)
        self._finished = False
        # forensics: always-on flight ring + crash handlers (installed once
        # per process, at the first run).  The dump path is explicit
        # (HYPEROPT_TPU_FLIGHT=<path>), derived from the armed stream, or —
        # for fully disarmed runs — the recorder's abnormal-death default.
        fpath = self.config.flight_path
        if fpath is None and self.config.jsonl_path:
            fpath = flight_path_for(self.config.jsonl_path)
        # a derived target is per-run: finish() removes it so clean exits
        # don't litter; an explicit HYPEROPT_TPU_FLIGHT path is persistent
        self._flight_target = (fpath if self.config.flight_path is None
                               else None)
        self.flight = get_flight().install(fpath)
        self.watchdog = get_watchdog()
        if self.watchdog is not None:
            # stall detection is scoped to live runs: retained here,
            # released by finish() — a process that outlives its runs must
            # not report its own idleness as a stall forever
            self.watchdog.retain()
            if self.sink is not None:
                # armed runs stream stall records next to their spans
                self.watchdog.attach_sink(self.sink)
        # device-profiling plane (obs/profiler.py): arm-optional and
        # thread-free — the DeviceProfiler is a directory + a lock; a
        # capture is recorded by the attached loop at its tick boundaries,
        # or on the thread that asked.  Armed runs register the
        # once-per-run stall escalation; disarmed runs construct nothing
        # here (torch.profiler is imported inside the capture calls).
        self.profiler = None
        if self.config.profile_dir:
            from .profiler import DeviceProfiler

            self.profiler = DeviceProfiler(self.config.profile_dir, obs=self)
            if self.watchdog is not None:
                self.watchdog.add_escalation(self.profiler.capture_on_stall)
        # live observability plane (obs/serve.py, obs/devmem.py): both are
        # arm-optional — a disarmed run imports neither module, starts no
        # thread, and its hot path stays exactly the pre-serve code
        self.http = None
        self.devmem = None
        if self.config.devmem_period is not None:
            from .devmem import DevMemSampler

            self.devmem = DevMemSampler(self, period=self.config.devmem_period)
            self.devmem.start()
        if self.config.http_port is not None:
            from .serve import ObsHTTPServer

            http = ObsHTTPServer(self.config.http_port, obs=self)
            # fail-open: an occupied port warned once inside start()
            self.http = http if http.start() else None

    @classmethod
    def resolve(cls, obs, totals=None, run_id=None):
        """``obs=`` kwarg → RunObs: passes an existing RunObs through (so
        ``fmin`` can hand its bundle to the device runner), builds one from
        a config/path/None otherwise."""
        if isinstance(obs, cls):
            return obs
        return cls(ObsConfig.resolve(obs), totals=totals, run_id=run_id)

    # -- sugar used by the instrumented call sites ------------------------

    def span(self, name, **attrs):
        return self.tracer.span(name, **attrs)

    def event(self, name, **attrs):
        self.tracer.event(name, **attrs)

    def heartbeat(self, component, **detail):
        """Feed the stall watchdog (no-op when it is disabled): the four
        execution paths call this at every liveness-proving boundary so a
        quiet period means a real hang, not a slow phase."""
        if self.watchdog is not None:
            self.watchdog.beat(component, **detail)

    def devmem_sample(self):
        """Span-boundary device-memory sample (rate-limited to the
        configured period; obs/devmem.py).  A disarmed run pays one
        attribute check."""
        if self.devmem is not None:
            self.devmem.maybe_sample()

    def trial_event(self, event, tid, **attrs):
        self.events.emit(event, tid, **attrs)

    def counter(self, name):
        return self.metrics.counter(name)

    def gauge(self, name):
        return self.metrics.gauge(name)

    def histogram(self, name):
        return self.metrics.histogram(name)

    def annotate(self, name, **ids):
        """A timeline ``record_function`` for one loop boundary (fmin
        tick / device chunk / driver generation) when the capture plane is
        armed, its ids encoded in the name (``fmin.tick#step=3,...#``); a
        shared null context otherwise — the disarmed call sites pay one
        attribute check, nothing else."""
        return annotation_ctx(self.profiler, name, **ids)

    def boundary(self):
        """A loop's tick (or chunk) boundary: where the capture plane
        starts and ends the captures handed to the loop
        (``DeviceProfiler.boundary``).  One attribute check disarmed."""
        if self.profiler is not None:
            self.profiler.boundary()

    @contextlib.contextmanager
    def loop(self):
        """Serve the capture plane on the calling thread for the block
        (``DeviceProfiler.attach_loop``): what ``fmin``'s loop wraps
        itself in."""
        prof = self.profiler
        if prof is None:
            yield
            return
        prof.attach_loop()
        try:
            yield
        finally:
            prof.detach_loop()

    def profiler_ctx(self):
        """One ``torch.profiler`` session over the whole loop when the
        full-trace mode is armed (``HYPEROPT_TPU_PROFILE=full:<dir>``;
        written to ``<dir>/device.trace.json.gz``).  The bare ``<dir>``
        form arms the bounded-capture plane instead and leaves the loop
        unwrapped."""
        pdir = self.config.profile_full
        if not pdir:
            return contextlib.nullcontext()
        from .profiler import trace_session

        logger.info("profiling to %s (torch.profiler)", pdir)
        return trace_session(pdir)

    def snapshot(self, extra_namespaces=("device",)):
        """This run's metrics snapshot plus the shared device namespace
        (the device loop's capture/execute split and the analytic kernel
        costs live there: the loop programs are process-global)."""
        snap = self.metrics.snapshot()
        for ns in extra_namespaces:
            if ns != self.run_id:
                snap.setdefault("shared", {})[ns] = get_metrics(ns).snapshot()
        if self.tracer.totals:
            snap["phase_timings"] = self.tracer.totals.summary()
        return snap

    def finish(self):
        """Flush the run: write the final metrics snapshot to the JSONL
        stream, close the sink's handle (it reopens in append mode if the
        run is re-entered — iterator-protocol fmin), and release this run's
        namespace from the global registry table so a long-lived sweep
        process doesn't grow it without bound.  ``self.metrics`` stays
        alive for anyone holding the bundle; idempotent.  A run re-entered
        after a finish (``for trials in FMinIter(...)``) must :meth:`rearm`
        first, or anything resolving the namespace by run id would get a
        fresh empty registry while the bundle keeps counting into this
        one."""
        if self.devmem is not None and not self._finished:
            # one final sample (the run's last watermark lands in the
            # stream/snapshot), then stop the sampler thread
            self.devmem.sample(reason="finish")
            self.devmem.stop()
        if self.http is not None:
            self.http.stop()
        if self.sink is not None:
            # ts is load-bearing: the Perfetto export drops ts-less
            # records, and this snapshot is what feeds the roofline
            # counter tracks (obs/export.py)
            self.sink.write({"kind": "metrics", "run_id": self.run_id,
                             "ts": time.time(),
                             "snapshot": self.snapshot()})
            if self.watchdog is not None:
                self.watchdog.detach_sink(self.sink)
            self.sink.close()
        if self.watchdog is not None and not self._finished:
            if self.profiler is not None:
                self.watchdog.remove_escalation(self.profiler.capture_on_stall)
            self.watchdog.release()
        if self._flight_target is not None:
            # the run survived: drop its derived dump target so a clean
            # process exit doesn't litter; the ring keeps recording
            self.flight.remove_target(self._flight_target)
        reset_metrics(self.run_id)
        self._finished = True

    def rearm(self):
        """Re-enter a finished run: re-register this bundle's OWN metrics
        registry — accumulated counters and all — under the run id
        (``finish()`` released the namespace; without the explicit re-adopt
        a resumed iterator-protocol ``FMinIter`` would silently split its
        counters between this object and a fresh registry created by the
        next ``get_metrics(run_id)`` caller).  The JSONL sink needs no
        re-arm: it reopens in append mode on the next write.  No-op while
        the run is live; ``FMinIter.run()`` calls this at every entry."""
        if self._finished:
            adopt_metrics(self.run_id, self.metrics)
            if self._flight_target is not None:
                self.flight.add_target(self._flight_target)
            if self.watchdog is not None:
                self.watchdog.retain()
                if self.sink is not None:
                    self.watchdog.attach_sink(self.sink)
                if self.profiler is not None:
                    # a hang in this new leg must still get its (one)
                    # device trace — the budget is per leg, not per object
                    self.profiler.reset_stall_budget()
                    self.watchdog.add_escalation(
                        self.profiler.capture_on_stall)
            if self.devmem is not None:
                self.devmem.start()  # restart the sampler thread
            if self.config.http_port is not None:
                # a shut-down http.server cannot restart: rebuild.  A
                # pinned port that the finished server just released binds
                # again; an ephemeral port may move (url is re-read)
                from .serve import ObsHTTPServer

                http = ObsHTTPServer(self.config.http_port, obs=self)
                self.http = http if http.start() else None
            self._finished = False
