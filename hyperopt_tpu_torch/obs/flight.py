"""Always-on flight recorder: the last N seconds of a run's life, on disk
when the process dies (counterpart of ``hyperopt_tpu/obs/flight.py``,
copied: host-only; the port keeps its own process-global recorder).

The obs layer's spans/metrics/events only reach disk when a run is armed
(``HYPEROPT_TPU_OBS=<path>``), and a killed or wedged process never gets to
flush anything.  This module is the forensics pillar that survives both: a
process-global, lock-cheap in-memory ring of the most recent telemetry
records (spans — armed *or* disarmed — events, trial lifecycle, stall
reports) that is dumped to ``<run>.flight.jsonl`` when the process dies
abnormally:

* **unhandled exception** — a chained ``sys.excepthook``;
* **fatal signals** — SIGTERM / SIGINT / SIGABRT handlers that dump the
  ring, then hand control to whatever handler was installed before (or
  re-raise the default disposition so exit codes stay honest);
* **atexit** — a final dump for every explicitly-armed recorder, so even a
  clean exit leaves the forensics artifact the run asked for;
* **hard faults** — ``faulthandler`` is enabled at install time (SIGSEGV /
  SIGFPE / SIGBUS / SIGILL write C-level tracebacks to
  ``<dump>.faults``, or stderr when no dump path is configured).

Bounds: the ring holds at most ``max_records`` records *and* (by a cheap
shallow estimate, made exact at dump time) at most ``max_bytes`` of
payload, whichever trips first — a week-long run cannot grow it.
Recording must stay cheap next to a disarmed ``fmin`` tick, so the hot
path does **no serialization**: a size estimate and a
deque append under a short lock.  JSON encoding happens once, at dump
time, where the exact ``max_bytes`` budget is enforced newest-first.

The dump is ordinary obs JSONL — parse with
:func:`~hyperopt_tpu_torch.obs.trace.read_jsonl` (the JAX package's
``obs.report --postmortem`` renders it too).  A
dump carries, besides the ring itself:

* a ``kind="flight_dump"`` header (reason, pid, wall time);
* one ``kind="open_span"`` record per span still open at death — the
  phase the process died *inside*;
* a ``kind="last_heartbeats"`` record from the stall watchdog (per-
  component last-heartbeat ages — which collective a controller reached).

Arming the dump path: ``HYPEROPT_TPU_FLIGHT=<path>`` (``0``/``off``
disables recording entirely), or it derives from an armed obs stream
(``run.jsonl`` → ``run.flight.jsonl``).  With neither, the ring still
records and abnormal deaths dump to ``hyperopt_tpu.flight.jsonl`` in the
working directory; clean exits write nothing.
"""

from __future__ import annotations

import atexit
import faulthandler
import json
import logging
import os
import signal
import sys
import threading
import time
from collections import deque

__all__ = ["FlightRecorder", "get_flight", "flight_path_for"]

logger = logging.getLogger(__name__)

_DEFAULT_MAX_RECORDS = 4096
_DEFAULT_MAX_BYTES = 4 << 20  # 4 MiB of encoded JSONL

_FATAL_SIGNALS = tuple(
    s for s in (getattr(signal, n, None)
                for n in ("SIGTERM", "SIGINT", "SIGABRT"))
    if s is not None
)


def _json_default(o):
    # mirror trace._json_default: telemetry must never raise into the paths
    # it observes
    try:
        return float(o)
    except Exception:
        return str(o)


def flight_path_for(jsonl_path):
    """Dump path derived from an armed obs stream: ``run.jsonl`` →
    ``run.flight.jsonl`` (kept next to the stream it post-mortems)."""
    root, ext = os.path.splitext(str(jsonl_path))
    return f"{root}.flight{ext or '.jsonl'}"


def _estimate_bytes(rec):
    """Cheap shallow size estimate for the ring's byte bound — three dict
    lookups, no iteration, no serialization (the hot path pays this per
    record; the exact bound is enforced against real encoded bytes at dump
    time).  Stall records carry thread stacks, hence the flat surcharge."""
    n = 48 + 24 * len(rec)
    name = rec.get("name")
    if type(name) is str:
        n += len(name)
    attrs = rec.get("attrs")
    if type(attrs) is dict:
        n += 24 * len(attrs)
    if "stacks" in rec:
        n += 4096
    return n


class FlightRecorder:
    """Bounded in-memory ring of recent telemetry records + crash dumps.

    ``record`` is the hot call: encode once, append under a short lock,
    trim to the count/byte bounds.  Everything else (install, dump) runs
    at most a handful of times per process and never raises — a recorder
    failure must not take down the run it exists to post-mortem.
    """

    def __init__(self, max_records=_DEFAULT_MAX_RECORDS,
                 max_bytes=_DEFAULT_MAX_BYTES):
        self.enabled = True
        self.max_records = int(max_records)
        self.max_bytes = int(max_bytes)
        self.watchdog = None  # optional: last-heartbeat provider for dumps
        self.devmem = None  # optional: device-memory tail/census provider
        # optional live-record tap (the scrape server's SSE broadcast hub,
        # obs/serve.py).  One attribute load + None check per record when no
        # server is armed; the tap itself must never raise or block (the
        # broadcast hub appends to bounded per-client rings, dropping
        # oldest on overflow)
        self.tap = None
        # shutdown hooks (scrape-server close): run on fatal signals and at
        # atexit so an armed HTTP listener dies with the run, not after it
        self._shutdown_hooks = []
        self._ring = deque()  # (record dict, estimated bytes)
        self._bytes = 0
        # REENTRANT: the fatal-signal handler runs on the main thread
        # between bytecodes and calls record()/dump() — with a plain Lock a
        # signal landing while the main thread holds it would deadlock the
        # dying process instead of dumping
        self._lock = threading.RLock()
        # id(span) -> (name, start ts, thread name); plain dict ops are
        # GIL-atomic, dumps iterate a snapshot copy
        self._open_spans = {}
        self._targets = []
        self._installed = False
        self._prev_signal = {}
        self._prev_excepthook = None
        self._fault_file = None
        self._fh_stderr = False  # we enabled faulthandler, bound to stderr
        self.dump_count = 0
        self._seq = 0  # records ever appended (not bounded by the ring)
        self._abnormal_seq = None  # _seq at the last signal/exception dump

    # -- recording (the hot path) -----------------------------------------

    def record(self, rec: dict):
        """Append one record to the ring — no serialization on the hot
        path, just a shallow size estimate and a deque append."""
        if not self.enabled:
            return
        try:
            n = _estimate_bytes(rec)
        except Exception:
            return
        with self._lock:
            self._ring.append((rec, n))
            self._seq += 1
            self._bytes += n
            while self._ring and (len(self._ring) > self.max_records
                                  or self._bytes > self.max_bytes):
                self._bytes -= self._ring.popleft()[1]
        tap = self.tap
        if tap is not None:
            try:
                tap(rec)
            except Exception:  # a broken tap must not touch the hot path
                self.tap = None

    def note_open(self, key, name, ts):
        """Register a span as open; a dump reports every span still open at
        death (the phase the process died inside).  Stores the raw thread
        ident — name resolution happens at dump time, off the hot path."""
        if self.enabled:
            self._open_spans[key] = (name, ts, threading.get_ident())

    def note_close(self, key):
        self._open_spans.pop(key, None)

    def records(self):
        """Snapshot of the ring (oldest first)."""
        with self._lock:
            return [rec for rec, _ in self._ring]

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._bytes = 0
        self._open_spans.clear()

    # -- arming ------------------------------------------------------------

    def add_target(self, path):
        path = str(path)
        with self._lock:
            if path not in self._targets:
                self._targets.append(path)

    def remove_target(self, path):
        path = str(path)
        with self._lock:
            if path in self._targets:
                self._targets.remove(path)

    def add_shutdown_hook(self, fn):
        """Register an idempotent, non-raising callable to run when the
        process dies (fatal signal or atexit) — how the scrape server's
        listener socket is closed on the flight recorder's signal path."""
        with self._lock:
            if fn not in self._shutdown_hooks:
                self._shutdown_hooks.append(fn)

    def remove_shutdown_hook(self, fn):
        with self._lock:
            if fn in self._shutdown_hooks:
                self._shutdown_hooks.remove(fn)

    def run_shutdown_hooks(self):
        """Run (and keep) the registered hooks; they are idempotent, so a
        signal dump followed by the atexit dump is safe."""
        with self._lock:
            hooks = list(self._shutdown_hooks)
        for fn in hooks:
            try:
                fn()
            except Exception:  # a dying process: best-effort only
                pass

    def install(self, path=None):
        """Arm the crash handlers (idempotent) and, when ``path`` is given,
        add it as a dump target.  Pre-existing signal handlers and the
        previous ``sys.excepthook`` are preserved and chained to."""
        if not self.enabled:
            return self
        if path:
            self.add_target(path)
        if not self._installed:
            self._installed = True
            atexit.register(self._atexit_dump)
            self._prev_excepthook = sys.excepthook
            sys.excepthook = self._excepthook
            for sig in _FATAL_SIGNALS:
                try:
                    self._prev_signal[sig] = signal.signal(
                        sig, self._signal_handler)
                except (ValueError, OSError):
                    # not the main thread / unsupported platform: the ring
                    # and the exception/atexit dumps still work
                    continue
        self._arm_faulthandler()
        return self

    def _arm_faulthandler(self):
        """Route hard faults (SIGSEGV class) to ``<first target>.faults``,
        or stderr while no target exists.  Runs on every install, not just
        the first: a process whose first run was disarmed upgrades the
        stderr binding to a file once an armed run names one.  A
        faulthandler someone else enabled is never stolen."""
        try:
            if self._fault_file is not None:
                return
            if self._targets and (self._fh_stderr
                                  or not faulthandler.is_enabled()):
                target = self._targets[0]
                d = os.path.dirname(target)
                if d:
                    os.makedirs(d, exist_ok=True)
                # the handle must stay open for faulthandler's lifetime;
                # an empty .faults file afterwards means "no hard faults"
                self._fault_file = open(target + ".faults", "w")
                faulthandler.enable(file=self._fault_file)
                self._fh_stderr = False
            elif not faulthandler.is_enabled():
                faulthandler.enable()
                self._fh_stderr = True
        except Exception:  # pragma: no cover - faulthandler is best-effort
            pass

    # -- dumping -----------------------------------------------------------

    def dump(self, reason, path=None):
        """Write header + ring + open spans + last heartbeats to ``path``
        (or every armed target, or the default cwd path).  Encoding happens
        here, once, and the exact ``max_bytes`` budget is enforced
        newest-first.  Never raises; returns the list of paths written."""
        with self._lock:
            recs = [rec for rec, _ in self._ring]
        lines, budget = [], self.max_bytes
        for rec in reversed(recs):  # newest-first under the exact budget
            try:
                line = json.dumps(rec, default=_json_default)
            except Exception:
                continue
            budget -= len(line) + 1
            if budget < 0:
                break
            lines.append(line)
        lines.reverse()  # back to chronological order
        targets = ([str(path)] if path
                   else list(self._targets) or ["hyperopt_tpu.flight.jsonl"])
        now = time.time()
        head = json.dumps({
            "kind": "flight_dump", "reason": str(reason), "ts": now,
            "pid": os.getpid(), "n_records": len(lines),
        })
        extra = []
        thread_names = {t.ident: t.name for t in threading.enumerate()}
        for name, ts, ident in list(self._open_spans.values()):
            extra.append(json.dumps({
                "kind": "open_span", "name": name, "ts": ts,
                "age_sec": now - ts,
                "thread": thread_names.get(ident, f"thread-{ident}"),
            }, default=_json_default))
        wd = self.watchdog
        if wd is not None:
            try:
                extra.append(json.dumps(
                    {"kind": "last_heartbeats", "ts": now,
                     "beats": wd.last_beats()}, default=_json_default))
            except Exception:
                pass
        dm = self.devmem
        if dm is not None:
            # the memory narrative: recent devmem samples + a live-array
            # census, so an OOM'd process dumps WHAT was holding HBM
            try:
                for rec in dm.tail():
                    extra.append(json.dumps(rec, default=_json_default))
                extra.append(json.dumps(dm.census_record(),
                                        default=_json_default))
            except Exception:
                pass
        written = []
        for target in targets:
            try:
                d = os.path.dirname(target)
                if d:
                    os.makedirs(d, exist_ok=True)
                # overwrite: a later dump (exception then atexit) supersedes
                # the earlier one — the ring only ever grows between them
                with open(target, "w") as f:
                    f.write(head + "\n")
                    for line in lines:
                        f.write(line + "\n")
                    for line in extra:
                        f.write(line + "\n")
                    f.flush()
                    os.fsync(f.fileno())
                written.append(target)
            except Exception:
                continue  # a dead target must not block the others
        self.dump_count += 1
        return written

    # -- death hooks -------------------------------------------------------

    def _signal_handler(self, signum, frame):
        try:
            name = signal.Signals(signum).name
        except ValueError:  # pragma: no cover
            name = str(signum)
        self.record({"kind": "event", "name": "fatal_signal",
                     "ts": time.time(), "attrs": {"signal": name}})
        self._abnormal_seq = self._seq
        self.dump(reason=f"signal:{name}")
        self.run_shutdown_hooks()
        prev = self._prev_signal.get(signum)
        if callable(prev):
            prev(signum, frame)
        elif prev == signal.SIG_DFL:
            # restore the default disposition and re-deliver, so the exit
            # status stays what a kill would have produced without us
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)
        # SIG_IGN / None: swallow, matching the pre-existing behavior

    def _excepthook(self, exc_type, exc, tb):
        try:
            self.record({"kind": "event", "name": "unhandled_exception",
                         "ts": time.time(),
                         "attrs": {"type": exc_type.__name__,
                                   "message": str(exc)[:500]}})
            if self.devmem is not None and "RESOURCE_EXHAUSTED" in str(exc):
                # device OOM: take one FRESH sample + census at the moment
                # of death (the tail alone shows the ramp, not the peak
                # that killed us) so the dump carries a memory narrative
                try:
                    self.devmem.sample(reason="oom")
                except Exception:
                    pass
            self._abnormal_seq = self._seq
            self.dump(reason=f"exception:{exc_type.__name__}")
        finally:
            (self._prev_excepthook or sys.__excepthook__)(exc_type, exc, tb)

    def _atexit_dump(self):
        # only explicitly-armed recorders leave an artifact on a CLEAN exit.
        # An abnormal death (signal/exception) already dumped above — do NOT
        # overwrite that dump with a misleading reason="atexit" header...
        # UNLESS the process demonstrably kept running afterwards (a caught
        # KeyboardInterrupt, say): new ring records since the abnormal dump
        # mean it describes a survived incident, not this death.
        if self._targets and (self._abnormal_seq is None
                              or self._seq > self._abnormal_seq):
            self.dump(reason="atexit")
        self.run_shutdown_hooks()


_global = None
_global_lock = threading.Lock()


def get_flight() -> FlightRecorder:
    """The process-global flight recorder (created on first use;
    ``HYPEROPT_TPU_FLIGHT=0``/``off`` disables recording entirely)."""
    global _global
    if _global is None:
        with _global_lock:
            if _global is None:
                fr = FlightRecorder()
                if os.environ.get("HYPEROPT_TPU_FLIGHT",
                                  "").strip().lower() in ("0", "off"):
                    fr.enabled = False
                _global = fr
    return _global
