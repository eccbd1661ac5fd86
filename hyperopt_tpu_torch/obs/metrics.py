"""Metrics registry: counters, gauges and bounded histograms (counterpart
of ``hyperopt_tpu/obs/metrics.py``, copied: host-only; the port keeps its
own registries).

Second pillar of the run-telemetry layer.  Registries are process-global
and namespaced (``get_metrics("device")`` is the same object everywhere in
the process — the natural scope for process-global caches like
``device_fmin._RUN_CACHE``), while per-run consumers create their own
namespace so two concurrent runs don't mix counters.

All metric objects are deliberately lock-free: increments are single
bytecode-level dict/int operations (safe enough under the GIL for
telemetry), and keeping them lock-free means they survive the pickle
boundaries the Trials backends cross (``ExecutorTrials`` checkpoints,
``FileTrials`` resume).
"""

from __future__ import annotations

import json
import threading
from collections import deque

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_metrics",
    "reset_metrics",
    "adopt_metrics",
    "all_namespaces",
]


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n=1):
        self.value += n

    def snapshot(self):
        return self.value


class Gauge:
    """Last-set value (queue depth, busy workers, cache size)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v):
        self.value = v

    def snapshot(self):
        return self.value


class Histogram:
    """Bounded-memory duration/size distribution.

    Running ``count/sum/min/max`` are exact over the full stream; the
    percentile estimates come from a bounded ring of the most recent
    ``maxlen`` observations, so a week-long run cannot grow the registry
    without bound (the "bounded" in the tentpole spec).
    """

    __slots__ = ("count", "total", "min", "max", "_ring")

    def __init__(self, maxlen=512):
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self._ring = deque(maxlen=maxlen)

    def observe(self, v):
        v = float(v)
        self.count += 1
        self.total += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v
        self._ring.append(v)

    def snapshot(self):
        if not self.count:
            return {"count": 0}
        ring = sorted(self._ring)

        def pct(p):
            return ring[min(len(ring) - 1, int(p * (len(ring) - 1) + 0.5))]

        return {
            "count": self.count,
            "sum": self.total,
            "mean": self.total / self.count,
            "min": self.min,
            "max": self.max,
            "p50": pct(0.50),
            "p90": pct(0.90),
            "p99": pct(0.99),
        }


class MetricsRegistry:
    """Named metrics under one namespace; ``snapshot()`` is deterministic
    (sorted keys, pure data) so two identically-fed registries serialize
    byte-identically — the property the test suite pins."""

    def __init__(self, namespace="default"):
        self.namespace = namespace
        self._metrics = {}

    def _get(self, name, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            # setdefault: two racing creators converge on one instance
            m = self._metrics.setdefault(name, cls(*args))
        return m

    def counter(self, name) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name, maxlen=512) -> Histogram:
        return self._get(name, Histogram, maxlen)

    def iter_metrics(self):
        """Sorted ``(name, metric object)`` pairs — the typed view the
        Prometheus exposition needs (a snapshot can't distinguish a counter
        from an integer-valued gauge).  ``dict()`` first: the scrape
        thread iterates while the run thread creates metrics."""
        return sorted(dict(self._metrics).items())

    def snapshot(self):
        return {
            "namespace": self.namespace,
            "metrics": {
                name: m.snapshot()
                for name, m in sorted(dict(self._metrics).items())
            },
        }

    def to_json(self, indent=None):
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)


_REGISTRIES: dict = {}
_REG_LOCK = threading.Lock()


def get_metrics(namespace="default") -> MetricsRegistry:
    """The process-global registry for ``namespace`` (created on first
    use)."""
    reg = _REGISTRIES.get(namespace)
    if reg is None:
        with _REG_LOCK:
            reg = _REGISTRIES.setdefault(namespace, MetricsRegistry(namespace))
    return reg


def reset_metrics(namespace=None):
    """Drop one namespace (or all) — test/bench isolation."""
    with _REG_LOCK:
        if namespace is None:
            _REGISTRIES.clear()
        else:
            _REGISTRIES.pop(namespace, None)


def adopt_metrics(namespace, registry):
    """(Re-)install ``registry`` as the process-global registry for
    ``namespace``, replacing any registry created in the meantime.  This is
    how ``RunObs.rearm()`` re-enters a finished run: ``finish()`` released
    the namespace from the table, but the run's own registry object — with
    its accumulated counters — stays alive on the bundle, and a resumed run
    must keep counting into IT, not into a fresh empty namespace that
    happens to share the run id."""
    with _REG_LOCK:
        _REGISTRIES[namespace] = registry
    return registry


def all_namespaces():
    return sorted(_REGISTRIES)
