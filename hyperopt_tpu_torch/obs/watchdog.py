"""Stall watchdog: turn "the job hung at hour 6" into a named blocked call
(counterpart of ``hyperopt_tpu/obs/watchdog.py``, copied: host-only; the
port keeps its own process-global watchdog, which its executor and
worker feed).

The execution paths this repo runs — ``FMinIter`` ask→tell ticks, the
chunked device loop, executor worker threads, the multi-controller driver's
collectives — all share one failure mode no exception ever reports: a hung
objective, a dead NFS mount, or a peer controller that never reaches its
allgather leaves the process alive but silent.  The watchdog is a daemon
thread fed by cheap heartbeats from all of those paths; once *no* component
has beaten for a configurable quiet period it emits a ``kind="stall"``
record carrying

* the last heartbeat per component (age + structured detail — for the
  driver that detail is the last collective reached and whether the
  process was *entering* or *leaving* it), and
* every thread's current stack (``sys._current_frames()``), so the blocked
  frame is named, not guessed.

Stall records go to the flight-recorder ring (always), any armed JSONL
sinks (``Watchdog.attach_sink``) and the log — and they fire **once per
quiet period**, not once per tick: a 6-hour hang under a 5-minute quiet
period produces ~72 stall records, not tens of thousands.  A fresh
heartbeat re-arms the detector.

Heartbeats are dictionary stores under the GIL — no lock on the beat path —
so instrumented hot loops pay ~a dict assignment per tick.

**What this detects — and what it doesn't.**  Quiet is *global*: a stall
fires when the whole process stops proving liveness — a blocked
collective, a wedged device readback, a serial objective that never
returns, a worker stuck on dead NFS.  Two boundaries follow.  (1) A
serial trial merely *slower* than the quiet period is indistinguishable
from a hung one; the stall record is still truthful (the stacks show the
run is inside the user objective, and the log says so) — size
``HYPEROPT_TPU_WATCHDOG`` above your slowest legitimate trial to keep
those reports meaningful.  (2) In asynchronous mode the *driver* keeps
beating while it polls, so one deadlocked worker among many does not
register as a process-wide stall — per-trial budgets
(``ExecutorTrials(timeout=...)``, ``FileStore.reclaim_stale``) are the
designed detector for individual hung trials there; the watchdog's job
is the whole process going dark.

Configuration: ``HYPEROPT_TPU_WATCHDOG=<seconds>`` sets the quiet period
(default 300); ``0``/``off`` disables the global watchdog.  The ``clock``
parameter exists for deterministic tests (fake clocks drive
:meth:`Watchdog.check` directly).
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
import traceback

from .flight import get_flight

__all__ = ["Watchdog", "get_watchdog", "beat"]

logger = logging.getLogger(__name__)

_DEFAULT_QUIET_SEC = 300.0


class Watchdog:
    """Quiet-period stall detector over named component heartbeats."""

    def __init__(self, quiet_sec=_DEFAULT_QUIET_SEC, interval=None,
                 clock=time.monotonic, flight=None, max_stack_frames=12):
        self.quiet_sec = float(quiet_sec)
        # tick a few times per quiet period, but never busier than 2 Hz and
        # never lazier than 30 s — a stall is reported within ~1.25x quiet
        self.interval = (float(interval) if interval is not None
                         else min(max(self.quiet_sec / 4.0, 0.5), 30.0))
        self._clock = clock
        self._flight = flight
        self.max_stack_frames = int(max_stack_frames)
        self._beats = {}  # component -> (mono ts, wall ts, detail dict|None)
        self._sinks = []
        # stall-escalation hooks (obs/profiler.py registers a bounded
        # once-per-run device capture): run AFTER the stall record is
        # emitted, on the watchdog thread, each wrapped so an escalation
        # failure can never take the detector down with it
        self._escalations = []
        self._lock = threading.Lock()
        self._thread = None
        self._stop = threading.Event()
        self._last_stall_mono = None
        self.stall_count = 0
        # live-run refcount: stall detection only runs while at least one
        # run is active (RunObs retains/releases) — otherwise a notebook or
        # server that ran one fmin would emit bogus stall reports every
        # quiet period for the rest of the process lifetime
        self._active = 0

    # -- feeding -----------------------------------------------------------

    def beat(self, component, **detail):
        """Record liveness for ``component`` (a dict store — safe and cheap
        from any thread).  ``detail`` is kept verbatim for the stall report
        and the flight dump's ``last_heartbeats`` record."""
        self._beats[component] = (self._clock(), time.time(), detail or None)

    def last_beats(self):
        """Per-component last heartbeat: age (seconds), wall ts, detail."""
        now = self._clock()
        out = {}
        # dict() is a single C-level copy (atomic under the GIL); iterating
        # self._beats directly could raise mid-insert from a worker thread
        for comp, (mono, wall, detail) in sorted(dict(self._beats).items()):
            entry = {"age_sec": now - mono, "ts": wall}
            if detail:
                entry["detail"] = detail
            out[comp] = entry
        return out

    # -- run lifecycle (RunObs retain/release) -----------------------------

    def retain(self):
        """A run went live: stall detection is meaningful again."""
        with self._lock:
            self._active += 1

    def release(self):
        """A run finished.  At zero live runs detection quiesces (the
        beats table is kept — a crash dump's last-heartbeat record should
        still say what the process did last)."""
        with self._lock:
            self._active = max(0, self._active - 1)
            if self._active == 0:
                self._last_stall_mono = None

    # -- sinks -------------------------------------------------------------

    def attach_sink(self, sink):
        """Also stream stall records to ``sink`` (an armed run's
        ``JsonlSink``); detach on run finish."""
        if sink is None:
            return
        with self._lock:
            if sink not in self._sinks:
                self._sinks.append(sink)

    def detach_sink(self, sink):
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)

    # -- escalations -------------------------------------------------------

    def add_escalation(self, fn):
        """Register a callable run with the stall record after each stall
        report — the profiler plane's hook for "hangs die with a device
        trace".  Escalations run on the watchdog thread (the stalled main
        thread may be wedged inside the very call being diagnosed) and are
        individually exception-guarded."""
        with self._lock:
            if fn not in self._escalations:
                self._escalations.append(fn)

    def remove_escalation(self, fn):
        with self._lock:
            if fn in self._escalations:
                self._escalations.remove(fn)

    # -- detection ---------------------------------------------------------

    def check(self, now=None):
        """Emit and return a stall record when every component has been
        quiet for ``quiet_sec``; None otherwise.  Fires once per quiet
        period: after a stall report, the next fires only after another
        full quiet period of silence.  A fresh heartbeat re-arms."""
        now = self._clock() if now is None else now
        beats = dict(self._beats)  # atomic snapshot vs concurrent beat()
        with self._lock:
            if not beats or self._active <= 0:
                return None
            last = max(mono for mono, _, _ in beats.values())
            if now - last < self.quiet_sec:
                self._last_stall_mono = None  # alive again: re-arm
                return None
            if (self._last_stall_mono is not None
                    and now - self._last_stall_mono < self.quiet_sec):
                return None  # already reported this quiet period
            self._last_stall_mono = now
            self.stall_count += 1
            count = self.stall_count
            quiet_for = now - last
        rec = {
            "kind": "stall",
            "ts": time.time(),
            "quiet_sec": self.quiet_sec,
            "quiet_for_sec": quiet_for,
            "stall_count": count,
            "last_heartbeats": self.last_beats(),
            "stacks": self._thread_stacks(),
        }
        self._emit(rec)
        return rec

    def _thread_stacks(self):
        """``{thread name: [file:line func, ...]}`` for every live thread
        except the watchdog's own (its stack is always this function)."""
        names = {t.ident: t.name for t in threading.enumerate()}
        own = self._thread.ident if self._thread is not None else None
        stacks = {}
        for ident, frame in sys._current_frames().items():
            if ident == own:
                continue
            frames = traceback.extract_stack(frame)[-self.max_stack_frames:]
            stacks[names.get(ident, f"thread-{ident}")] = [
                f"{f.filename}:{f.lineno} {f.name}" for f in frames
            ]
        return stacks

    def _emit(self, rec):
        fl = self._flight if self._flight is not None else get_flight()
        fl.record(rec)
        with self._lock:
            sinks = list(self._sinks)
        for sink in sinks:
            try:
                sink.write(rec)
            except Exception:  # a dead sink must not kill the watchdog
                pass
        beats = rec["last_heartbeats"]
        newest_comp, newest = None, None
        for comp, b in beats.items():
            if newest is None or b["age_sec"] < newest:
                newest_comp, newest = comp, b["age_sec"]
        # self-explaining false-positive hint: if the last sign of life was
        # entering an evaluation, a slow-but-healthy trial looks exactly
        # like this — tell the reader which knob separates the two
        hint = ""
        if newest_comp in ("fmin.evaluate", "executor.trial",
                           "worker.trial"):
            hint = (" (last beat entered a trial evaluation: a hung "
                    "objective, or one slower than the quiet period — "
                    "raise HYPEROPT_TPU_WATCHDOG if trials legitimately "
                    "take this long)")
        logger.warning(
            "stall: no heartbeat from any component for %.0fs "
            "(newest %s ago from %s; components: %s) — thread stacks "
            "recorded%s",
            rec["quiet_for_sec"],
            f"{newest:.0f}s" if newest is not None else "?",
            newest_comp or "?",
            ", ".join(sorted(beats)) or "none", hint)
        with self._lock:
            escalations = list(self._escalations)
        for fn in escalations:
            try:
                fn(rec)
            except Exception:  # an escalation must never kill the detector
                logger.exception("stall escalation %r failed", fn)

    # -- thread lifecycle --------------------------------------------------

    def start(self):
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="hyperopt-obs-watchdog", daemon=True)
            self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval):
            try:
                self.check()
            except Exception:  # pragma: no cover - must never die silently
                logger.exception("watchdog check failed")

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


_global = None
_global_lock = threading.Lock()
_DISABLED = object()


def get_watchdog():
    """The process-global watchdog (started lazily on first use), or None
    when ``HYPEROPT_TPU_WATCHDOG`` is ``0``/``off``."""
    global _global
    if _global is _DISABLED:
        return None
    if _global is None:
        with _global_lock:
            if _global is None:
                raw = os.environ.get("HYPEROPT_TPU_WATCHDOG", "").strip()
                if raw.lower() in ("0", "off", "false"):
                    _global = _DISABLED
                    return None
                try:
                    quiet = float(raw) if raw else _DEFAULT_QUIET_SEC
                except ValueError:
                    quiet = _DEFAULT_QUIET_SEC
                wd = Watchdog(quiet_sec=quiet)
                wd.start()
                fl = get_flight()
                if fl.watchdog is None:
                    fl.watchdog = wd  # dumps report last heartbeats
                _global = wd
    return _global if _global is not _DISABLED else None


def beat(component, **detail):
    """Module-level heartbeat: feed the global watchdog from call sites that
    hold no obs handle (executor worker threads, the standalone worker, the
    device runner's module paths).  A disabled watchdog makes this a cheap
    no-op."""
    wd = get_watchdog()
    if wd is not None:
        wd.beat(component, **detail)
