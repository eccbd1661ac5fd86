"""hyperopt_tpu_torch.obs — the host core of the run telemetry
(counterpart of the parts of ``hyperopt_tpu/obs/`` that the evaluation
backends import).

* :mod:`~hyperopt_tpu_torch.obs.trace` — nested spans (wall + CPU time,
  structured attrs) and the JSONL reader/writer.
* :mod:`~hyperopt_tpu_torch.obs.metrics` — process-global, per-namespace
  counters / gauges / bounded histograms with deterministic snapshots.
* :mod:`~hyperopt_tpu_torch.obs.events` — durable trial-lifecycle event
  log (``FileStore`` persists it as an attachment for post-mortems).
* :mod:`~hyperopt_tpu_torch.obs.flight` — bounded ring of recent
  records, dumped on fatal signals, unhandled exceptions and atexit once
  a dump target is armed (``FileStore.arm_flight``).
* :mod:`~hyperopt_tpu_torch.obs.watchdog` — stall detector over the
  heartbeats of the executor and the file-store worker.
* the service's planes: :mod:`~hyperopt_tpu_torch.obs.reqtrace`
  (request trace ids), :mod:`~hyperopt_tpu_torch.obs.slo` (error-budget
  burn rates), :mod:`~hyperopt_tpu_torch.obs.serve` (Prometheus text)
  and :mod:`~hyperopt_tpu_torch.obs.tenant` (tenant ids).

The records are the JAX package's, line for line, so its report tools
read what the port writes.  The port keeps its own module-global
singletons.  The run-level planes (``ObsConfig``, ``RunObs``, device
profiling, the scrape server) and the quality, load, tenant and prober
planes are not ported yet: ``fmin``'s ``obs``/``obs_http``/``profile``
options and the environment knobs that arm them raise
``not_ported(..., 14)``.
"""

from __future__ import annotations

from .events import EventLog
from .flight import FlightRecorder, flight_path_for, get_flight
from .metrics import MetricsRegistry, adopt_metrics, get_metrics, reset_metrics
from .trace import JsonlSink, PhaseTimings, Tracer, iter_jsonl, read_jsonl
from .watchdog import Watchdog, get_watchdog

__all__ = [
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
