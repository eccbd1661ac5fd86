"""In-process observability scrape server: ``/metrics``, ``/snapshot``,
``/events`` and ``/profile`` (counterpart of ``hyperopt_tpu/obs/serve.py``).

A stdlib ``http.server`` daemon thread rides the run and serves straight
from the live registries, never by replaying JSONL:

* ``GET /metrics`` — Prometheus text exposition of every
  ``MetricsRegistry`` namespace (:func:`prometheus_text`, also what the
  service's HTTP server answers);
* ``GET /snapshot`` — JSON: the live analog of the ``obs.report``
  headline sections (``report.headline_sections``, the serializer of
  ``obs.report --format json``: phases, health, utilization, roofline)
  plus live-only extras (in-flight trials, last heartbeats, the latest
  device-memory sample);
* ``GET /events`` — a Server-Sent-Events tail of the span/event stream
  through the flight recorder's tap, each client on a bounded
  drop-oldest ring (:class:`Broadcast`);
* ``GET /profile?sec=N`` — one bounded ``torch.profiler`` capture
  (``obs/profiler.py``; armed by ``fmin(profile=<dir>)``), answered with
  its record as JSON.  While ``fmin``'s loop runs, the loop records it on
  its own thread and this handler waits.

Arming: ``HYPEROPT_TPU_OBS_HTTP=<port>`` or ``fmin(obs_http=<port>)``
(``0`` binds an ephemeral port: read it from ``trials.obs_http_url``).
Fail-open everywhere: an occupied port or a serialization error is a
once-logged warning, never an exception into the run.  Shutdown:
``RunObs.finish()``, the flight recorder's fatal-signal path and atexit.
"""

from __future__ import annotations

import json
import logging
import re
import threading
import time
from collections import deque

from .metrics import Counter, Gauge, Histogram, all_namespaces, get_metrics

__all__ = ["ObsHTTPServer", "prometheus_text", "Broadcast", "split_hostport"]

logger = logging.getLogger(__name__)

_NAME_PREFIX = "hyperopt_tpu_"
_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")


def _metric_name(name):
    """Registry metric name → valid Prometheus metric name (dots and any
    other illegal characters collapse to underscores)."""
    out = _NAME_PREFIX + _NAME_SANITIZE.sub("_", str(name))
    if not _NAME_OK.match(out):  # e.g. a leading digit after the prefix
        out = _NAME_PREFIX + "_" + _NAME_SANITIZE.sub("_", str(name))
    return out


def _label_value(v):
    """Escape a label VALUE per the exposition format (backslash, quote,
    newline)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(v):
    if v is None:
        return "NaN"
    f = float(v)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f)


def prometheus_text(namespaces=None):
    """The whole process's metrics as Prometheus text exposition format.

    One metric family per (sanitized) registry metric name; the registry
    namespace rides as a ``namespace`` label so concurrent runs stay
    distinguishable.  Counters expose ``_total``, histograms become
    summaries (``quantile`` series + ``_sum``/``_count``), gauges map
    directly.  Built from live registry objects — a scrape never touches
    JSONL or the hot path.
    """
    if namespaces is None:
        namespaces = all_namespaces()
    families = {}  # prom name -> {"type": ..., "samples": [line, ...]}
    for ns in namespaces:
        label = f'namespace="{_label_value(ns)}"'
        for name, m in get_metrics(ns).iter_metrics():
            pname = _metric_name(name)
            if isinstance(m, Counter):
                fam = families.setdefault(pname + "_total",
                                          {"type": "counter", "samples": []})
                fam["samples"].append(
                    f"{pname}_total{{{label}}} {_fmt(m.value)}")
            elif isinstance(m, Histogram):
                fam = families.setdefault(pname,
                                          {"type": "summary", "samples": []})
                snap = m.snapshot()
                for q, key in (("0.5", "p50"), ("0.9", "p90"),
                               ("0.99", "p99")):
                    if key in snap:
                        fam["samples"].append(
                            f'{pname}{{{label},quantile="{q}"}} '
                            f"{_fmt(snap[key])}")
                fam["samples"].append(
                    f"{pname}_sum{{{label}}} {_fmt(snap.get('sum', 0.0))}")
                fam["samples"].append(
                    f"{pname}_count{{{label}}} {_fmt(snap.get('count', 0))}")
            elif isinstance(m, Gauge):
                fam = families.setdefault(pname,
                                          {"type": "gauge", "samples": []})
                fam["samples"].append(f"{pname}{{{label}}} {_fmt(m.value)}")
    lines = []
    for pname in sorted(families):
        fam = families[pname]
        # the classic text/plain; version=0.0.4 format keys metadata by
        # the literal sample name, so a counter's TYPE line must name the
        # `_total` family itself (the base-name split is OpenMetrics-only)
        lines.append(f"# TYPE {pname} {fam['type']}")
        lines.extend(fam["samples"])
    return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# SSE broadcast hub (the /events tail)
# ---------------------------------------------------------------------------


class _Subscriber:
    __slots__ = ("ring", "event", "dropped")

    def __init__(self, maxlen):
        self.ring = deque(maxlen=maxlen)
        self.event = threading.Event()
        self.dropped = 0


class Broadcast:
    """Fan one record stream out to N bounded subscriber rings.

    ``publish`` is called from the flight recorder's tap — i.e. from
    inside instrumented code — so it must be cheap and can never block: a
    full ring drops its OLDEST record (the subscriber learns via a
    ``dropped`` counter on the next event it reads) instead of slowing the
    writer.
    """

    def __init__(self):
        self._subs = []
        self._lock = threading.Lock()

    def publish(self, rec):
        for sub in list(self._subs):
            if len(sub.ring) == sub.ring.maxlen:
                sub.dropped += 1  # deque drops the oldest on append
            sub.ring.append(rec)
            sub.event.set()

    def subscribe(self, maxlen=256):
        sub = _Subscriber(int(maxlen))
        with self._lock:
            self._subs.append(sub)
        return sub

    def unsubscribe(self, sub):
        with self._lock:
            if sub in self._subs:
                self._subs.remove(sub)

    def drain(self, sub, timeout=1.0):
        """Wait up to ``timeout`` for records; returns (records, dropped
        since last drain)."""
        sub.event.wait(timeout)
        out = []
        while sub.ring:
            try:
                out.append(sub.ring.popleft())
            except IndexError:  # raced the publisher's trim
                break
        sub.event.clear()
        dropped, sub.dropped = sub.dropped, 0
        return out, dropped

    @property
    def n_subscribers(self):
        return len(self._subs)


_BROADCAST = Broadcast()
_tap_servers = 0  # live servers; the flight tap installs while > 0
_tap_lock = threading.Lock()


def _retain_tap():
    from .flight import get_flight

    global _tap_servers
    with _tap_lock:
        _tap_servers += 1
        get_flight().tap = _BROADCAST.publish


def _release_tap():
    from .flight import get_flight

    global _tap_servers
    with _tap_lock:
        _tap_servers = max(0, _tap_servers - 1)
        if _tap_servers == 0 and get_flight().tap is _BROADCAST.publish:
            # restore the disarmed hot path to a bare None check
            get_flight().tap = None


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


def split_hostport(value, default_host="127.0.0.1"):
    """``9109`` / ``"9109"`` / ``"0.0.0.0:9109"`` → ``(host, port)``.  The
    default binds loopback (scraping a sweep must be opt-in exposure);
    ``host:port`` opens it to a remote Prometheus / ``obs.top``."""
    if isinstance(value, str) and ":" in value:
        host, port = value.rsplit(":", 1)
        return host or default_host, int(port)
    return default_host, int(value)


class ObsHTTPServer:
    """Daemon-thread HTTP server over one run's registries (see module
    docstring).  ``start()`` returns False — after one warning — instead of
    raising when the port is taken (or out of range); every handler catches
    its own serialization errors the same way."""

    def __init__(self, port, obs=None, host=None):
        try:
            if host is None:
                host, port = split_hostport(port)
            self.port = int(port)
        except (TypeError, ValueError):
            self.port = None  # start() warns and fails open
        self.host = host or "127.0.0.1"
        self.obs = obs  # RunObs (or any object with metrics/tracer/events)
        self._httpd = None
        self._thread = None
        self._stopped = False

    # -- payload builders (all registry snapshots, never JSONL replay) ----

    def snapshot_dict(self):
        """The ``/snapshot`` payload: shared headline sections + live-only
        extras."""
        from .report import headline_sections

        obs = self.obs
        out = {"ts": time.time(), "endpoint": "snapshot"}
        if obs is None:
            return out
        out["run_id"] = obs.run_id
        # dict() snapshots are C-level copies: the run thread keeps
        # adding phases/metrics while the HTTP thread serializes
        phases = {k: {"sec": v["sec"], "count": v["count"]}
                  for k, v in dict(obs.tracer.totals or {}).items()}
        metrics = obs.metrics.snapshot()["metrics"]
        device = get_metrics("device").snapshot()["metrics"]
        out["sections"] = headline_sections(phases, metrics, device)
        # headline scalars obs.top reads without digging into sections
        if "best_loss" in metrics:
            out["best_loss"] = metrics["best_loss"]
        out["trials_completed"] = metrics.get("trials.completed", 0)
        # live-only extras: what a report over a dead stream cannot know
        trial_events = obs.events.records()
        out["inflight_trials"] = _inflight(trial_events)
        wd = getattr(obs, "watchdog", None)
        if wd is not None:
            out["last_heartbeats"] = wd.last_beats()
        dm = getattr(obs, "devmem", None)
        if dm is not None:
            tail = dm.tail()
            if tail:
                out["devmem"] = tail[-1]
        return out

    # -- lifecycle ---------------------------------------------------------

    @property
    def url(self):
        if self._httpd is None:
            return None
        return f"http://{self.host}:{self._httpd.server_address[1]}"

    def start(self):
        """Bind + serve on a daemon thread.  False (after one warning) on
        any bind failure — an occupied port must never kill the run."""
        import http.server

        if self.port is None:
            logger.warning("obs scrape server: unparseable port/host value; "
                           "live observability disabled for this run")
            return False
        handler = _make_handler(self)
        try:
            self._httpd = http.server.ThreadingHTTPServer(
                (self.host, self.port), handler)
        # OverflowError: port out of [0, 65535] (e.g. a multihost
        # per-controller offset past the top) — fail open like a
        # collision, per the never-kill-the-run contract
        except (OSError, OverflowError, ValueError) as e:
            logger.warning(
                "obs scrape server: cannot bind %s:%d (%s); live "
                "observability disabled for this run — the JSONL stream "
                "and flight recorder are unaffected", self.host, self.port,
                e)
            self._httpd = None
            return False
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.25},
            name="hyperopt-obs-http", daemon=True)
        self._thread.start()
        _retain_tap()
        from .flight import get_flight

        get_flight().add_shutdown_hook(self.stop)
        logger.info("obs scrape server listening on %s "
                    "(/metrics /snapshot /events)", self.url)
        return True

    def stop(self):
        """Idempotent shutdown: close the listener, stop the serve loop,
        release the flight tap.  Runs on RunObs.finish(), fatal signals
        (flight shutdown hooks) and atexit."""
        if self._stopped:
            return
        self._stopped = True
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            try:
                httpd.shutdown()
                httpd.server_close()
            except Exception:
                pass
            _release_tap()
        from .flight import get_flight

        get_flight().remove_shutdown_hook(self.stop)


def _inflight(trial_events):
    """Claimed-or-queued-but-unfinished trials from the lifecycle ring."""
    from .events import (TRIAL_CANCELLED, TRIAL_CLAIMED, TRIAL_FINISHED,
                         TRIAL_NEW)

    timelines = {}
    for r in trial_events:
        t = timelines.setdefault(r["tid"], {})
        t.setdefault(r["event"], r["ts"])
    now = time.time()
    out = []
    for tid, t in sorted(timelines.items()):
        if TRIAL_FINISHED in t or TRIAL_CANCELLED in t:
            continue
        start = t.get(TRIAL_CLAIMED, t.get(TRIAL_NEW))
        out.append({"tid": tid,
                    "state": ("claimed" if TRIAL_CLAIMED in t else "queued"),
                    "age_sec": (now - start) if start is not None else None})
    return out


def _make_handler(server):
    import http.server

    class Handler(http.server.BaseHTTPRequestHandler):
        # the run's logger, not stderr-per-request
        def log_message(self, fmt, *args):
            logger.debug("obs http: " + fmt, *args)

        def _send(self, body, content_type):
            data = body.encode() if isinstance(body, str) else body
            self.send_response(200)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):  # noqa: N802 (stdlib handler contract)
            path, _, query = self.path.partition("?")
            try:
                if path == "/metrics":
                    self._send(prometheus_text(),
                               "text/plain; version=0.0.4; charset=utf-8")
                elif path == "/snapshot":
                    self._send(json.dumps(server.snapshot_dict(),
                                          default=str, sort_keys=True),
                               "application/json")
                elif path == "/events":
                    self._sse()
                elif path == "/profile":
                    self._profile(query)
                elif path == "/":
                    self._send(
                        "hyperopt_tpu obs: /metrics /snapshot /events "
                        "/profile?sec=N\n",
                        "text/plain")
                else:
                    self.send_error(404)
            except (BrokenPipeError, ConnectionResetError):
                pass  # client went away mid-write: normal for scrapers
            except Exception as e:
                # fail-open: a serialization bug answers 500 once per
                # request and never propagates into the run
                logger.warning("obs http: %s failed: %s", path, e)
                try:
                    self.send_error(500)
                except Exception:
                    pass

        def _profile(self, query):
            """``GET /profile?sec=N``: one bounded device capture
            (obs/profiler.py): recorded by the run's loop on its own
            thread while one is attached, else on this handler's thread;
            this handler waits for it.  Fail-open: a disarmed plane, a
            busy session or a backend without profiler support answer
            ``ok: false`` in-band (HTTP 200), never an exception into the
            run."""
            from urllib.parse import parse_qs

            params = parse_qs(query or "")
            sec = (params.get("sec") or ["3"])[0]
            prof = getattr(server.obs, "profiler", None)
            if prof is None:
                body = {"ok": False,
                        "error": "profiler plane not armed — set "
                                 "HYPEROPT_TPU_PROFILE=<dir> or "
                                 "fmin(profile=<dir>)"}
            else:
                body = prof.capture(sec, reason="http")
            self._send(json.dumps(body, default=str, sort_keys=True),
                       "application/json")

        def _sse(self):
            sub = _BROADCAST.subscribe()
            try:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                while not server._stopped:
                    recs, dropped = _BROADCAST.drain(sub, timeout=1.0)
                    if dropped:
                        recs = ([{"kind": "sse_overflow",
                                  "dropped": dropped}] + recs)
                    if not recs:
                        self.wfile.write(b": keepalive\n\n")
                        self.wfile.flush()
                        continue
                    for rec in recs:
                        data = json.dumps(rec, default=str)
                        self.wfile.write(f"data: {data}\n\n".encode())
                    self.wfile.flush()
            finally:
                _BROADCAST.unsubscribe(sub)

    return Handler
