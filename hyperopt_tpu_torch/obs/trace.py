"""Span/event tracer: nested context-manager spans with wall + CPU time,
structured attributes, and an optional JSONL sink (counterpart of
``hyperopt_tpu/obs/trace.py``, copied: host-only).

This is the first pillar of the run-telemetry layer.  It absorbs and
supersedes the ad-hoc ``PhaseTimings`` dict that used
to live in ``fmin.py``: the tracer aggregates every span's wall clock into a
:class:`PhaseTimings` (``totals``), so ``trials.phase_timings`` keeps its
exact historical shape (plain picklable dict of ``{"sec", "count"}``) while
armed runs additionally stream one JSON line per span.

Design constraints:

* **Dependency-free and cheap when disarmed** — with no sink, a span costs
  two clock reads, a dict update and one bounded flight-ring append; the
  default ``fmin`` path must not regress.
* **Thread-correct nesting** — the open-span stack is thread-local, so
  executor worker threads and the driver thread each get their own parent
  chain while sharing one sink/aggregate.
* **Post-mortem friendly** — records carry absolute timestamps (``ts``)
  next to monotonic durations, so interleaved multi-source JSONL files sort
  into one timeline; every finished span also lands in the process-global
  flight-recorder ring (``obs/flight.py``) so a killed process still dumps
  its recent history, and open spans are registered with the ring so the
  dump names the phase the process died inside.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time

from .flight import get_flight

__all__ = ["PhaseTimings", "Tracer", "JsonlSink", "iter_jsonl", "read_jsonl"]

logger = logging.getLogger(__name__)


class PhaseTimings(dict):
    """Per-phase wall-clock accounting for the ask→tell loop.  Maps phase name → ``{"sec": total, "count": calls}``;
    lives on the trials object (``trials.phase_timings``) so it survives
    pickling/resume and is inspectable after ``fmin`` returns.

    Since the obs layer landed this is the *aggregate view* the
    :class:`Tracer` maintains — the tracer owns the measurement, this dict
    owns the accumulated totals (and stays a plain dict so checkpoints
    written before the tracer existed still load).
    """

    def add(self, phase, dt):
        e = self.setdefault(phase, {"sec": 0.0, "count": 0})
        e["sec"] += dt
        e["count"] += 1

    def summary(self):
        total = sum(e["sec"] for e in self.values()) or 1.0
        return {
            k: {**e, "frac": e["sec"] / total}
            for k, e in sorted(self.items(), key=lambda kv: -kv[1]["sec"])
        }


class JsonlSink:
    """Append-only JSONL writer shared by tracer, metrics and event log.

    Writes are serialized under a lock and flushed per record (a crashed
    run's partial stream is still a valid prefix).  The file handle opens
    lazily so constructing a sink for a run that never emits costs nothing.

    A dead filesystem (revoked mount, full disk) must not raise into the
    instrumented ask→tell hot path: the first ``OSError`` on open/write/
    flush logs once, closes the handle and permanently disables the sink —
    telemetry degrades to the in-memory flight ring, the run keeps going.
    """

    def __init__(self, path):
        self.path = str(path)
        self._f = None
        self._lock = threading.Lock()
        self._dead = False

    def write(self, record: dict):
        if self._dead:
            return
        line = json.dumps(record, default=_json_default)
        with self._lock:
            if self._dead:
                return
            try:
                if self._f is None:
                    d = os.path.dirname(self.path)
                    if d:
                        os.makedirs(d, exist_ok=True)
                    self._f = open(self.path, "a")
                self._f.write(line + "\n")
                self._f.flush()
            except (OSError, ValueError) as e:
                self._dead = True
                if self._f is not None:
                    try:
                        self._f.close()
                    except OSError:
                        pass
                    self._f = None
                logger.error(
                    "obs sink %s failed (%s); disabling the JSONL stream — "
                    "telemetry degrades to the in-memory flight ring",
                    self.path, e)

    def close(self):
        with self._lock:
            if self._f is not None:
                try:
                    self._f.close()
                except OSError:
                    pass
                self._f = None

    # sinks ride on objects that cross pickle boundaries (Trials backends);
    # only the path is identity — the handle reopens on next write, and a
    # resumed process gets a fresh try at a sink its parent declared dead
    def __getstate__(self):
        return {"path": self.path}

    def __setstate__(self, state):
        self.path = state["path"]
        self._f = None
        self._lock = threading.Lock()
        self._dead = False


def _json_default(o):
    # numpy scalars and anything else non-JSON: degrade to float/str, never
    # let a telemetry write raise into the instrumented hot path
    try:
        return float(o)
    except Exception:
        return str(o)


def iter_jsonl(path):
    """Stream a JSONL file one record at a time, skipping unparseable
    lines with a warning instead of raising: a process killed mid-write
    leaves a torn final line, and one partial record must never make the
    whole post-mortem unreadable.  ``obs.report`` and the trace exporter
    read through here so a multi-hour multi-controller stream is never
    materialized wholesale in memory."""
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except ValueError:
                logger.warning(
                    "%s:%d: skipping unparseable JSONL record "
                    "(torn write from a killed process?)", path, lineno)


def read_jsonl(path):
    """List-returning wrapper over :func:`iter_jsonl` for callers that want
    the whole (small) stream at once — the historical interface."""
    return list(iter_jsonl(path))


class _Span:
    __slots__ = ("tracer", "name", "attrs", "aggregate", "span_id",
                 "parent_id", "depth", "ts", "_t0", "_c0", "_pushed")

    def __init__(self, tracer, name, attrs, aggregate=True):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.aggregate = aggregate

    def __enter__(self):
        tr = self.tracer
        fl = tr.flight
        if tr.sink is None:
            # disarmed fast path: two clock reads + the flight ring's
            # open-span note — this is what the default fmin loop pays
            self._pushed = False
            self.ts = time.time()
            self._t0 = time.perf_counter()
            if fl is not None:
                fl.note_open(id(self), self.name, self.ts)
            return self
        stack = tr._stack()
        self.span_id = tr._next_id()
        self.parent_id = stack[-1].span_id if stack else None
        self.depth = len(stack)
        stack.append(self)
        # the stack push is recorded on the span itself: if the tracer is
        # disarmed mid-span, __exit__ must still pop THIS frame or every
        # later span on the thread inherits a phantom parent/depth
        self._pushed = True
        self.ts = time.time()
        if fl is not None:
            fl.note_open(id(self), self.name, self.ts)
        self._c0 = time.process_time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        wall = time.perf_counter() - self._t0
        tr = self.tracer
        if self._pushed:
            stack = tr._stack()
            if stack and stack[-1] is self:
                stack.pop()
        if self.aggregate and tr.totals is not None:
            tr.totals.add(self.name, wall)
        fl = tr.flight
        feed = fl is not None and fl.enabled
        if fl is not None:
            # unconditional: a recorder disabled mid-span must still clear
            # the open-span entry its __enter__ registered, or every later
            # dump reports a phantom open-at-death span
            fl.note_close(id(self))
        # spans entered armed keep streaming even if the tracer was
        # disarmed meanwhile (the push is what grants stream identity);
        # with neither a ring nor a stream consuming, build nothing
        stream = tr.sink is not None and self._pushed
        if not (feed or stream):
            return False
        rec = {
            "kind": "span",
            "name": self.name,
            "ts": self.ts,
            "wall_sec": wall,
        }
        if not self.aggregate:
            # umbrella spans (fmin's "run", device.compile) are excluded
            # from the live phase totals; mark them so offline consumers
            # (report --format json) can rebuild the SAME totals
            rec["aggregate"] = False
        if self._pushed:
            rec["cpu_sec"] = time.process_time() - self._c0
            rec["span_id"] = self.span_id
            rec["parent_id"] = self.parent_id
            rec["depth"] = self.depth
        # thread identity on EVERY recorded span (not just armed ones): the
        # trace exporter assigns tracks by it, and post-mortem dumps of
        # disarmed multi-threaded runs are exactly where it matters
        rec["thread"] = threading.current_thread().name
        if tr.run_id is not None:
            rec["run_id"] = tr.run_id
        if self.attrs:
            rec["attrs"] = self.attrs
        if exc_type is not None:
            rec["error"] = exc_type.__name__
        if feed:
            fl.record(rec)
        if stream:
            tr.sink.write(rec)
        return False


class Tracer:
    """Produces nested spans; aggregates per-name wall clock into
    ``totals`` and (when armed) streams one record per span to ``sink``."""

    def __init__(self, sink=None, totals=None, run_id=None, flight=None):
        self.sink = sink
        self.totals = totals if totals is not None else PhaseTimings()
        self.run_id = run_id
        # every span/event also feeds the process-global flight ring (the
        # post-mortem path that works even when no sink is armed)
        self.flight = flight if flight is not None else get_flight()
        self._local = threading.local()
        self._id_lock = threading.Lock()
        self._id = 0

    def _stack(self):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _next_id(self):
        with self._id_lock:
            self._id += 1
            return self._id

    def span(self, name, aggregate=True, **attrs):
        """Context manager timing one phase; nests under any open span on
        this thread.  ``aggregate=False`` keeps an umbrella span (e.g. the
        whole ``run``) out of the per-phase totals, which would otherwise
        double-count its children."""
        return _Span(self, name, attrs, aggregate=aggregate)

    def event(self, name, **attrs):
        """Instantaneous structured record (divergence dumps, stop reasons);
        always lands in the flight ring, streamed when a sink is armed."""
        rec = {"kind": "event", "name": name, "ts": time.time()}
        if self.run_id is not None:
            rec["run_id"] = self.run_id
        if attrs:
            rec["attrs"] = attrs
        if self.flight is not None:
            self.flight.record(rec)
        if self.sink is not None:
            self.sink.write(rec)
