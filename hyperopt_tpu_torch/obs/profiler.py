"""Bounded, on-demand ``torch.profiler`` captures (counterpart of
``hyperopt_tpu/obs/profiler.py``).

The span and metric pillars see host time; this module is the device
half of the observability plane: bounded captures of the CPU and CUDA
timeline, armed by ``HYPEROPT_TPU_PROFILE=<dir>`` / ``fmin(profile=<dir>)``
and triggered three ways:

* programmatically — ``RunObs.profiler.capture(sec)`` from any thread;
* over HTTP — ``GET /profile?sec=N`` on the scrape server
  (``obs/serve.py``) waits for one capture and answers its record;
* on a stall — the watchdog's escalation hook takes ONE bounded capture
  per run.

Every capture is bounded (``sec`` clamps to ``max_capture_sec``) and
exclusive (one session per profiler; a concurrent request fails open with
a busy record instead of raising into the run).

**Which thread records.**  A ``torch.profiler`` session records the
kernels of the thread that started it (a session over every thread left
the process hanging at exit with torch 2.11 on an H100).  The JAX
package's capture runs on the thread that asks (the HTTP handler), which
here would record none of ``fmin``'s kernels.  So while a loop is attached
(:meth:`DeviceProfiler.attach_loop`: ``fmin``'s host loop and its device
loop attach for the length of ``run``), a capture asked for on another
thread is handed to the loop: the loop starts the session on its own
thread at its next tick boundary (:meth:`DeviceProfiler.boundary`) and
stops it at the first boundary ``sec`` later, while the caller waits,
bounded by ``sec`` plus :data:`HANDOFF_MARGIN_SEC`, and then writes the
trace on its own thread, off the loop.  A capture with no
loop attached, and the stall capture (the loop may be wedged), run on the
caller's thread as in the JAX package.  After each session CUPTI is torn
down (``TEARDOWN_CUPTI=1``, set here unless the caller set it), or every
later launch of the process runs ~30% slower.

Each capture lands in its own ``capture-<n>-<reason>`` directory under
the armed profile dir as ``device.trace.json.gz`` (``export_chrome_trace``)
and is recorded as a ``kind="profile"`` JSONL record (and flight-ring
event) with the artifact path, the capture's wall-clock bounds and the
reason; ``obs.report --export-trace`` merges the artifact next to the host
spans (``obs/export.py``).

**Timeline annotations.**  :func:`annotation_ctx` wraps
``torch.profiler.record_function`` so the fmin tick, the device-loop chunk
and the multihost generation show up named inside any capture that overlaps
them, their ids TraceMe-encoded in the name (``fmin.tick#step=3,tid=22#``,
what ``scripts/validate_trace.py`` accepts).  Disarmed runs get a shared
null context: one ``is None`` check, proposals bit for bit the same.

``HYPEROPT_TPU_PROFILE=full:<dir>`` keeps one session over the whole loop
instead (``RunObs.profiler_ctx``), exclusive with the bounded captures.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import logging
import os
import shutil
import threading
import time

__all__ = ["DeviceProfiler", "find_capture_artifact", "annotation_ctx",
           "split_profile_mode", "trace_session"]

logger = logging.getLogger(__name__)

#: hard ceiling on one capture's duration
DEFAULT_MAX_CAPTURE_SEC = 30.0

#: bounded duration of the automatic stall-escalation capture
DEFAULT_STALL_CAPTURE_SEC = 5.0

#: retained completed-capture records
CAPTURES_KEEP = 256

#: failed captures streamed to the sink/flight ring before going quiet
FAILURE_STREAM_MAX = 20

#: how long a handed-off capture may wait for the loop's tick boundaries
#: beyond its own duration: a session's first start sets CUPTI up (~10 s
#: on an H100), and a tick may be long
HANDOFF_MARGIN_SEC = 60.0

#: the artifact's file name inside a capture directory
ARTIFACT = "device.trace.json.gz"

_NULL_CTX = contextlib.nullcontext()


def split_profile_mode(raw):
    """``HYPEROPT_TPU_PROFILE`` value → ``(capture_dir, full_trace_dir)``:
    ``<dir>`` arms the bounded capture plane, ``full:<dir>`` one session
    over the whole run.  Empty/unset → ``(None, None)``."""
    raw = (raw or "").strip()
    if not raw:
        return None, None
    if raw.startswith("full:"):
        full = raw[len("full:"):].strip()
        return None, (full or None)
    return raw, None


def find_capture_artifact(capture_dir):
    """Newest ``*.trace.json.gz`` under one capture's directory tree, or
    None."""
    hits = glob.glob(os.path.join(str(capture_dir), "**", "*.trace.json.gz"),
                     recursive=True)
    return max(hits, key=os.path.getmtime) if hits else None


def annotation_ctx(profiler, name, **ids):
    """A ``record_function`` for the named loop boundary when the capture
    plane is armed, a shared null context otherwise."""
    if profiler is None:
        return _NULL_CTX
    return profiler.annotation(name, **ids)


def annotation_name(name, **ids):
    """``name#k=v,k2=v2#``: the ids TraceMe-encoded in the event name
    (``step`` first), which survives every chrome-trace exporter."""
    if not ids:
        return name
    keys = sorted(ids, key=lambda k: (k != "step", k))
    return name + "#" + ",".join(f"{k}={ids[k]}" for k in keys) + "#"


def _start_session():
    """A started ``torch.profiler`` session over CPU and (with a card)
    CUDA activity on the calling thread."""
    os.environ.setdefault("TEARDOWN_CUPTI", "1")
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _write(prof, path):
    """Write the stopped session's chrome trace to ``path`` (gzip)."""
    raw = path[: -len(".gz")]
    prof.export_chrome_trace(raw)
    with open(raw, "rb") as fin, gzip.open(path, "wb") as fout:
        shutil.copyfileobj(fin, fout)
    os.remove(raw)


@contextlib.contextmanager
def trace_session(out_dir):
    """One session over the block, written to ``<out_dir>/``
    :data:`ARTIFACT` (the ``full:<dir>`` mode)."""
    os.makedirs(out_dir, exist_ok=True)
    prof = _start_session()
    try:
        yield prof
    finally:
        prof.stop()
        _write(prof, os.path.join(str(out_dir), ARTIFACT))


class _Request:
    """One capture handed to the attached loop."""

    __slots__ = ("sec", "rec", "state", "prof", "t_mono", "done", "waiting")

    def __init__(self, sec, rec):
        self.sec = sec
        self.rec = rec
        # "pending" → "running" → "stopped" (the caller writes the trace)
        # or "done"; "returned" when the loop detached before starting it
        self.state = "pending"
        self.prof = None
        self.t_mono = None
        self.done = threading.Event()
        self.waiting = True  # the caller waits, and writes the trace


class DeviceProfiler:
    """Bounded, exclusive, fail-open ``torch.profiler`` capture manager
    (see the module docstring).  Construction is cheap and thread-free:
    a directory, a lock and counters."""

    def __init__(self, out_dir, obs=None, max_capture_sec=DEFAULT_MAX_CAPTURE_SEC,
                 stall_capture_sec=DEFAULT_STALL_CAPTURE_SEC, clock=time.sleep,
                 handoff_margin_sec=HANDOFF_MARGIN_SEC):
        self.out_dir = str(out_dir)
        self.obs = obs  # RunObs (or anything with .sink/.run_id), optional
        self.max_capture_sec = float(max_capture_sec)
        self.stall_capture_sec = float(stall_capture_sec)
        self.handoff_margin_sec = float(handoff_margin_sec)
        self._sleep = clock  # injectable for tests (no real waiting)
        self._lock = threading.Lock()  # one session at a time
        self._cv = threading.Condition()
        self._loop = None  # ident of the attached loop's thread
        self._loops = 0
        self._request = None
        self._count = 0
        self._stall_captured = False  # once-per-run bound
        self._warned_unsupported = False
        self._failures_streamed = 0
        self.captures = []  # capture records, oldest first, bounded

    # -- annotations -------------------------------------------------------

    def annotation(self, name, **ids):
        """``record_function`` named ``name#ids#``; fail-open."""
        try:
            from torch.profiler import record_function

            return record_function(annotation_name(name, **ids))
        except Exception:  # noqa: BLE001 - telemetry never raises into the run
            return _NULL_CTX

    # -- the loop hand-off -------------------------------------------------

    def attach_loop(self):
        """Serve captures on the calling thread at its :meth:`boundary`
        calls until :meth:`detach_loop`."""
        with self._cv:
            self._loop = threading.get_ident()
            self._loops += 1

    def detach_loop(self):
        """Stop serving: a running capture ends now; a pending one goes
        back to its caller, who captures on its own thread."""
        with self._cv:
            self._loops = max(0, self._loops - 1)
            if self._loops == 0:
                self._loop = None
            req = self._request
            if req is not None and req.state == "running":
                self._end(req)
            elif req is not None and req.state == "pending":
                req.state = "returned"
                self._request = None
                req.done.set()

    def boundary(self):
        """The attached loop's tick (or chunk) boundary: start a pending
        capture here, or end the running one once its ``sec`` elapsed.
        One attribute read when nothing is asked."""
        if self._request is None:
            return
        with self._cv:
            req = self._request
            if req is None:
                return
            if req.state == "pending":
                self._begin(req)
            elif time.monotonic() - req.t_mono >= req.sec:
                self._end(req)

    def _begin(self, req):
        rec = req.rec
        try:
            os.makedirs(rec["dir"], exist_ok=True)
            t0 = time.time()
            req.prof = _start_session()
        except Exception as e:  # noqa: BLE001 - fail open
            self._unsupported(e)
            rec.update(ok=False, error=f"{type(e).__name__}: {e}")
            self._finish(req)
            return
        req.t_mono = time.monotonic()
        rec.update(ts=t0, t0=t0, start_sec=time.time() - t0)
        req.state = "running"

    def _end(self, req):
        """Stop the session on the loop's thread (it must stop where it
        started); the waiting caller writes the trace, off the loop."""
        rec = req.rec
        t1 = time.time()
        try:
            req.prof.stop()
        except Exception as e:  # noqa: BLE001 - fail open
            rec.update(ok=False, error=f"{type(e).__name__}: {e}")
            req.prof = None
            self._finish(req)
            return
        rec.update(t1=t1, wall_sec=t1 - rec["t0"], stop_sec=time.time() - t1)
        if req.waiting:
            self._request = None
            req.state = "stopped"
            req.done.set()
        else:
            self._write_trace(req)

    def _write_trace(self, req):
        rec = req.rec
        t = time.time()
        try:
            path = os.path.join(rec["dir"], ARTIFACT)
            _write(req.prof, path)
        except Exception as e:  # noqa: BLE001 - fail open
            rec.update(ok=False, error=f"{type(e).__name__}: {e}")
        else:
            rec.update(ok=True, write_sec=time.time() - t, trace_json=path)
        req.prof = None
        self._finish(req)

    def _finish(self, req):
        req.state = "done"
        if self._request is req:
            self._request = None
        self._record(req.rec)
        req.done.set()

    # -- captures ----------------------------------------------------------

    def capture(self, sec, reason="ondemand", here=False):
        """One bounded capture: the ``kind="profile"`` record (``ok=True``
        with the artifact path) or an ``ok=False`` record naming why (busy,
        unsupported, bad duration, no tick boundary in time).  Never
        raises.  ``here=True`` records on the calling thread even while a
        loop is attached."""
        try:
            sec = float(sec)
        except (TypeError, ValueError):
            return self._record({
                "kind": "profile", "ok": False, "ts": time.time(),
                "reason": str(reason), "error": f"bad capture duration {sec!r}"})
        if not sec > 0:
            return self._record({
                "kind": "profile", "ok": False, "ts": time.time(),
                "reason": str(reason),
                "error": f"capture duration must be > 0, got {sec}"})
        sec = min(sec, self.max_capture_sec)
        if not self._lock.acquire(blocking=False):
            return self._record({
                "kind": "profile", "ok": False, "ts": time.time(),
                "reason": str(reason), "busy": True,
                "error": "capture already in progress"})
        try:
            self._count += 1
            cap_dir = os.path.join(self.out_dir, f"capture-{self._count}-{reason}")
            rec = {"kind": "profile", "reason": str(reason), "ts": time.time(),
                   "sec": sec, "dir": cap_dir}
            loop = self._loop
            if not here and loop is not None and loop != threading.get_ident():
                rec["thread"] = "loop"
                got = self._handoff(sec, rec)
                if got is not None:
                    return got
            rec["thread"] = "caller"
            return self._capture_here(sec, rec)
        finally:
            self._lock.release()

    def _handoff(self, sec, rec):
        """Hand ``rec`` to the attached loop; its record, or None when the
        loop detached before starting it (capture on this thread then)."""
        req = _Request(sec, rec)
        with self._cv:
            if self._loop is None:
                return None
            self._request = req
        if not req.done.wait(sec + self.handoff_margin_sec):
            with self._cv:
                if req.state == "pending":
                    self._request = None
                    rec.update(ok=False, error=(
                        f"the loop reached no tick boundary within "
                        f"{sec + self.handoff_margin_sec:.0f} s"))
                    return self._record(rec)
            # running: the loop ends it at its next boundary or detach
            if not req.done.wait(self.handoff_margin_sec):
                with self._cv:
                    if not req.done.is_set():
                        req.waiting = False  # the loop writes and records it
                        return dict(rec, ok=False, error="capture still running")
        if req.state == "returned":
            return None
        if req.state == "stopped":
            self._write_trace(req)
        return rec

    def _capture_here(self, sec, rec):
        try:
            os.makedirs(rec["dir"], exist_ok=True)
            t0 = time.time()
            prof = _start_session()
        except Exception as e:  # noqa: BLE001 - fail open
            self._unsupported(e)
            rec.update(ok=False, error=f"{type(e).__name__}: {e}")
            return self._record(rec)
        rec.update(ts=t0, t0=t0, start_sec=time.time() - t0)
        try:
            self._sleep(sec)
        finally:
            t1 = time.time()
            try:
                prof.stop()
                t2 = time.time()
                path = os.path.join(rec["dir"], ARTIFACT)
                _write(prof, path)
            except Exception as e:  # noqa: BLE001 - fail open
                rec.update(ok=False, error=f"{type(e).__name__}: {e}")
                return self._record(rec)
        rec.update(ok=True, t1=t1, wall_sec=t1 - t0, stop_sec=t2 - t1,
                   write_sec=time.time() - t2, trace_json=path)
        return self._record(rec)

    def _unsupported(self, e):
        if not self._warned_unsupported:
            self._warned_unsupported = True
            logger.warning(
                "device profiler capture unavailable (%s: %s); /profile and "
                "stall captures degrade to errors for this run — spans, "
                "metrics and the flight ring are unaffected", type(e).__name__, e)

    def capture_on_stall(self, stall_rec=None):
        """The watchdog escalation hook: ONE bounded capture per run, on
        the watchdog's own thread (the stalled loop may be wedged inside
        the very call the trace is meant to show, so nothing is handed to
        it).  A busy miss keeps the budget; any other failure latches."""
        if self._stall_captured:
            return None
        rec = self.capture(self.stall_capture_sec, reason="stall", here=True)
        if not rec.get("busy"):
            self._stall_captured = True
        if rec.get("ok"):
            logger.warning("stall escalation: captured %.1fs device trace to %s "
                           "(referenced from the flight dump)",
                           rec["wall_sec"], rec["dir"])
        return rec

    def reset_stall_budget(self):
        """Re-open the once-per-run stall-capture budget (a re-entered
        run's new leg)."""
        self._stall_captured = False

    @property
    def capture_count(self):
        return self._count

    # -- plumbing ----------------------------------------------------------

    def _record(self, rec):
        """Stream the capture record (success or failure) next to the run's
        spans and pin it in the flight ring; returns ``rec``.  Bounded
        against pollers, as in the JAX package."""
        self.captures.append(rec)
        if len(self.captures) > CAPTURES_KEEP:
            del self.captures[: len(self.captures) - CAPTURES_KEEP]
        if not rec.get("ok"):
            self._failures_streamed += 1
            if self._failures_streamed > FAILURE_STREAM_MAX:
                return rec
        obs = self.obs
        sink = getattr(obs, "sink", None)
        if getattr(obs, "run_id", None) is not None:
            rec.setdefault("run_id", obs.run_id)
        from .flight import get_flight

        get_flight().record(rec)
        if sink is not None:
            sink.write(rec)
        return rec
