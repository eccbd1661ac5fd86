"""Device-memory telemetry: watermarks, an owner census, the OOM
narrative (counterpart of ``hyperopt_tpu/obs/devmem.py``).

* :func:`memory_stats` — per-card ``torch.cuda.memory_stats``:
  ``bytes_in_use`` is the caching allocator's ``allocated_bytes.all.current``,
  ``peak_bytes_in_use`` its ``allocated_bytes.all.peak`` and ``bytes_limit``
  the card's total memory (``torch.cuda.mem_get_info``).  Without a card
  the one entry is the CPU's, every byte field None, as the JAX package's
  CPU reports.
* :func:`live_array_census` — live tensors bucketed by owner.  JAX walks
  ``jax.live_arrays()``; torch has no such list, and walking
  ``gc.get_objects()`` costs time in proportion to every Python object of
  the process.  So the owners register their tensors here by weak
  reference at the allocation sites (:func:`register_owner`: the history
  mirror of ``base.PaddedHistory``, the device loop's state, the armed
  ask's packed readback), the census sums the live ones by owner (shared
  storages counted once), and ``other`` is the allocator's remainder
  (``allocated_bytes.all.current`` minus the owners' device bytes; its
  ``count`` is the allocator's remaining live blocks).  A sample costs
  one pass over the registered tensors, a few dozen per run.
* :class:`DevMemSampler` — the per-run collector: ``devmem.*`` gauges in
  the run's metrics namespace, ``kind="devmem"`` JSONL records, a bounded
  tail the flight recorder attaches to crash dumps, and an optional
  low-rate sampler thread; tick and chunk boundaries call
  :meth:`~DevMemSampler.maybe_sample`, rate-limited to the period.

Arming: ``HYPEROPT_TPU_DEVMEM=<seconds>`` (``1``/``on``: the 10 s default)
or ``ObsConfig(devmem_period=...)``.  Disarmed runs construct nothing.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from collections import deque

from .._env import DEFAULT_DEVMEM_PERIOD_SEC

__all__ = [
    "DEFAULT_PERIOD_SEC",
    "memory_stats",
    "live_array_census",
    "register_owner",
    "roll_up",
    "DevMemSampler",
]

logger = logging.getLogger(__name__)

DEFAULT_PERIOD_SEC = DEFAULT_DEVMEM_PERIOD_SEC

# owner name -> weak set of its tensors
_OWNERS: dict = {}
_OWNER_LOCK = threading.Lock()


def register_owner(name, *tensors):
    """Count ``tensors`` as ``name``'s ("history", "candidates") in the
    census for as long as they live.  Cheap: a weak-set add each."""
    with _OWNER_LOCK:
        ws = _OWNERS.setdefault(str(name), weakref.WeakSet())
        for t in tensors:
            ws.add(t)


def memory_stats():
    """``[{device, platform, bytes_in_use, peak_bytes_in_use,
    bytes_limit}, ...]``, one entry per visible card; without one, a
    single CPU entry whose byte fields are None."""
    import torch

    if not torch.cuda.is_available():
        return [{"device": "cpu", "platform": "cpu", "bytes_in_use": None,
                 "peak_bytes_in_use": None, "bytes_limit": None}]
    out = []
    for i in range(torch.cuda.device_count()):
        entry = {"device": f"cuda:{i}", "platform": "gpu", "bytes_in_use": None,
                 "peak_bytes_in_use": None, "bytes_limit": None}
        try:
            stats = torch.cuda.memory_stats(i)
            entry["bytes_in_use"] = int(stats.get("allocated_bytes.all.current", 0))
            entry["peak_bytes_in_use"] = int(stats.get("allocated_bytes.all.peak", 0))
            entry["bytes_limit"] = int(torch.cuda.mem_get_info(i)[1])
        except Exception:  # noqa: BLE001 - a card that reports nothing stays None
            pass
        out.append(entry)
    return out


def live_array_census(per_device=False):
    """Live tensors by owner: ``{owner: {"count", "bytes"}}`` with an
    ``"other"`` remainder (the allocator's live bytes the owners do not
    hold) and a ``"total"`` roll-up.  ``per_device=True`` also returns
    ``{device: {owner: {"count", "bytes"}}}``."""
    import torch

    with _OWNER_LOCK:
        owners = {name: list(ws) for name, ws in _OWNERS.items()}
    buckets, by_dev = {}, {}
    seen = set()
    for name, tensors in owners.items():
        for t in tensors:
            try:
                storage = t.untyped_storage()
                key = (str(t.device), storage.data_ptr())
                nbytes = int(storage.nbytes())
            except Exception:  # noqa: BLE001 - a freed or meta tensor
                continue
            if key in seen:
                continue
            seen.add(key)
            for b in (buckets.setdefault(name, {"count": 0, "bytes": 0}),
                      by_dev.setdefault(key[0], {}).setdefault(
                          name, {"count": 0, "bytes": 0})):
                b["count"] += 1
                b["bytes"] += nbytes
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            dev = f"cuda:{i}"
            try:
                stats = torch.cuda.memory_stats(i)
            except Exception:  # noqa: BLE001
                continue
            held = by_dev.get(dev, {})
            rest_b = int(stats.get("allocated_bytes.all.current", 0)) - sum(
                v["bytes"] for v in held.values())
            rest_n = int(stats.get("active.all.current", 0)) - sum(
                v["count"] for v in held.values())
            if rest_b > 0:
                o = buckets.setdefault("other", {"count": 0, "bytes": 0})
                o["count"] += max(rest_n, 0)
                o["bytes"] += rest_b
                by_dev.setdefault(dev, {})["other"] = {"count": max(rest_n, 0),
                                                       "bytes": rest_b}
    buckets["total"] = {"count": sum(b["count"] for b in buckets.values()),
                        "bytes": sum(b["bytes"] for b in buckets.values())}
    if per_device:
        return buckets, by_dev
    return buckets


def roll_up(devices):
    """Max-watermark roll-up across one sample's per-device entries:
    ``(in_use, peak, limit, frac)`` with None where no device reported."""
    in_use = [d.get("bytes_in_use") for d in devices]
    in_use = [v for v in in_use if v is not None]
    peaks = [d.get("peak_bytes_in_use") for d in devices]
    peaks = [v for v in peaks if v is not None]
    limits = [d.get("bytes_limit") for d in devices]
    limits = [v for v in limits if v is not None]
    mx_use = max(in_use) if in_use else None
    mx_peak = max(peaks) if peaks else None
    mx_lim = max(limits) if limits else None
    frac = (mx_use / mx_lim) if (mx_use is not None and mx_lim) else None
    return mx_use, mx_peak, mx_lim, frac


class DevMemSampler:
    """Per-run device-memory collector (see the module docstring):
    ``sample()`` reads the stats and the census, sets ``devmem.*`` gauges,
    streams a ``kind="devmem"`` record when the run is armed and keeps a
    bounded tail; ``maybe_sample()`` is the rate-limited boundary entry."""

    def __init__(self, obs, period=DEFAULT_PERIOD_SEC, keep=32):
        self.obs = obs
        self.period = float(period)
        self._tail = deque(maxlen=int(keep))
        self._last_mono = None
        self._lock = threading.Lock()
        self._thread = None
        self._stop = threading.Event()
        self._dead = False

    # -- sampling ----------------------------------------------------------

    def maybe_sample(self, reason="span"):
        """Rate-limited sample: one clock read between samples."""
        now = time.monotonic()
        last = self._last_mono
        if last is not None and now - last < self.period:
            return None
        return self.sample(reason=reason)

    def sample(self, reason="tick"):
        """Take one sample now; the record, or None after a permanent
        failure (telemetry never raises into the run)."""
        if self._dead:
            return None
        try:
            return self._sample(reason)
        except Exception as e:  # noqa: BLE001
            self._dead = True
            logger.warning("devmem sampling failed (%s); disabling the sampler — "
                           "the run continues without device-memory telemetry", e)
            return None

    def _sample(self, reason):
        self._last_mono = time.monotonic()
        devices = memory_stats()
        if len(devices) > 1:
            census, per_device = live_array_census(per_device=True)
        else:
            census, per_device = live_array_census(), None
        mx_use, mx_peak, mx_lim, frac = roll_up(devices)
        m = self.obs.metrics
        m.counter("devmem.samples").inc()
        if mx_use is not None:
            m.gauge("devmem.bytes_in_use").set(mx_use)
        if mx_peak is not None:
            m.gauge("devmem.peak_bytes_in_use").set(mx_peak)
        if mx_lim is not None:
            m.gauge("devmem.bytes_limit").set(mx_lim)
        if frac is not None:
            m.gauge("devmem.watermark_frac").set(frac)
        m.gauge("devmem.history_bytes").set(census.get("history", {}).get("bytes", 0))
        m.gauge("devmem.live_arrays").set(census["total"]["count"])
        m.gauge("devmem.live_bytes").set(census["total"]["bytes"])
        rec = {"kind": "devmem", "ts": time.time(), "reason": reason,
               "run_id": self.obs.run_id, "devices": devices, "census": census}
        if per_device:
            rec["per_device"] = per_device
        with self._lock:
            self._tail.append(rec)
        sink = getattr(self.obs, "sink", None)
        if sink is not None:
            sink.write(rec)
        return rec

    # -- crash-dump providers (FlightRecorder.devmem) ----------------------

    def tail(self):
        """Recent samples, oldest first."""
        with self._lock:
            return list(self._tail)

    def census_record(self):
        """A fresh census as a JSONL record, taken at dump time."""
        return {"kind": "devmem_census", "ts": time.time(),
                "census": live_array_census()}

    def watermark(self):
        """``(frac, peak_bytes)`` from the last sample, or ``(None,
        None)`` before the first."""
        with self._lock:
            if not self._tail:
                return None, None
            devices = self._tail[-1]["devices"]
        _, mx_peak, _, frac = roll_up(devices)
        return frac, mx_peak

    # -- sampler-thread lifecycle ------------------------------------------

    def start(self):
        """Start the low-rate daemon sampler (idempotent; none when
        ``period <= 0``) and attach to the flight recorder's dumps."""
        if self.period > 0 and (self._thread is None or not self._thread.is_alive()):
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, name="hyperopt-obs-devmem",
                                            daemon=True)
            self._thread.start()
        from .flight import get_flight

        fl = get_flight()
        if fl.devmem is None:
            fl.devmem = self
        return self

    def _run(self):
        while not self._stop.wait(self.period):
            self.maybe_sample(reason="sampler")

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        from .flight import get_flight

        fl = get_flight()
        if fl.devmem is self:
            fl.devmem = None
