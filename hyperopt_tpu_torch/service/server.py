"""HTTP ask/tell front end over the :class:`StudyScheduler` (counterpart
of ``hyperopt_tpu/service/server.py``, single-scheduler mode).

Endpoints, all JSON, with the JAX package's request and answer shapes:

* ``POST /study`` — ``{"space": <spec>}`` (``service/spacespec.py``) or
  ``{"zoo": "<zoo name>"}``, plus optional ``seed``, ``n_startup_jobs``,
  ``max_trials`` and the ``tpe.suggest`` tuning kwargs → ``{"study_id"}``.
* ``POST /ask`` — ``{"study_id", "n": 1, "req": <token>}`` →
  ``{"trials": [{"tid", "params"}, ...], "wave"}``.  Concurrent asks
  coalesce into one cohort tick per wave on the scheduler's device.
* ``POST /tell`` — ``{"study_id", "tid", "loss"}`` (or ``"results": [...]``).
* ``POST /close`` — ``{"study_id"}``.
* ``GET /studies``, ``GET /study/<id>/timeline``, ``GET /healthz``,
  ``GET /metrics`` (Prometheus text: the ``service.*`` family and the
  ``slo_*`` gauges), ``GET /snapshot``.

Errors are in-band and typed: 400 for a malformed request, 404 for an
unknown study, 409 for a duplicate tell, 410 for a quarantined study,
429 (+ ``Retry-After`` from the wave-time EWMA) for a shed or a quota,
503 while draining, 507 when the store is full, 501 for a plane that is
not ported, 500 for a handler fault (recorded in the flight ring).
Every request carries a trace id (``obs/reqtrace.py``) and feeds the SLO
plane (``obs/slo.py``); ``HYPEROPT_TPU_SERVICE_ACCESS_LOG`` adds a JSONL
access log.

Run it with ``python -m hyperopt_tpu_torch.service.server --port 0
--announce --store <root>``: the scheduler runs on the CUDA card unless
``--device cpu`` is given.  SIGTERM drains: stop admitting, finish the
waves in flight, compact and close the WAL, exit 0.

Not ported: the replicated fleet (``--fleet`` and its options, ROADMAP.md
queue 1, item 13b) and the prober, quality, load and tenant planes (item
14).  Asking for any of them raises ``not_ported``; over HTTP, a request
that names a tenant other than ``anon`` answers 501.
"""

from __future__ import annotations

import json
import logging
import math
import threading
import time

from .._env import (not_ported, parse_reqtrace, parse_service, parse_service_access_log,
                    parse_service_deadline_ms, parse_service_slo, refuse_armed_knobs)
from ..exceptions import StoreFullError
from ..obs import reqtrace
from ..obs.serve import prometheus_text, split_hostport
from ..obs.tenant import ANON, sanitize_tenant
from ..obs.trace import JsonlSink, Tracer
from .overload import AdmissionGuard, Deadline, OverloadError, StoreFullShed
from .scheduler import (DrainingError, DuplicateTellError, QuarantinedStudyError,
                        StudyQuotaError, StudyScheduler, UnknownStudyError)
from .spacespec import SpaceSpecError, space_from_spec

__all__ = ["ServiceHTTPServer", "main"]

logger = logging.getLogger(__name__)

_STUDY_KWARGS = ("n_startup_jobs", "max_trials", "prior_weight", "n_EI_candidates", "gamma",
                 "linear_forgetting", "ei_select", "ei_tau", "prior_eps", "canary", "tenant")

#: routes of the JAX package's planes that are not ported yet
_ITEM_14_ROUTES = {"/tenants": "the tenant plane", "/fleet/load": "the cost ledger",
                   "/probes": "the blackbox prober"}


class _RequestError(Exception):
    """Typed in-band failure: (HTTP status, message)."""

    def __init__(self, status, message):
        super().__init__(message)
        self.status = int(status)


def _timeline_study_id(path):
    """``/study/<id>/timeline`` → the study id, else None."""
    if not (path.startswith("/study/") and path.endswith("/timeline")):
        return None
    sid = path[len("/study/"):-len("/timeline")].rstrip("/")
    if not sid or "/" in sid:
        return None
    return sid


class ServiceHTTPServer:
    """Daemon-thread ask/tell server over one scheduler.  ``start()``
    warns and returns False on a bind failure instead of raising;
    ``stop()`` is idempotent.  Without ``scheduler`` it builds
    ``StudyScheduler(store_root=..., wave_window=0.005, device=device)``
    (the card unless ``device="cpu"``)."""

    def __init__(self, port, scheduler=None, host=None, store_root=None, guard=None,
                 trace=None, slo=None, access_log=None, fleet=None, device=None):
        if fleet is not None:
            raise not_ported("ServiceHTTPServer(fleet=...)", "13b")
        refuse_armed_knobs("ServiceHTTPServer")
        try:
            if host is None:
                host, port = split_hostport(port)
            self.port = int(port)
        except (TypeError, ValueError):
            self.port = None  # start() warns and fails open
        self.host = host or "127.0.0.1"
        self.scheduler = scheduler if scheduler is not None else StudyScheduler(
            store_root=store_root, wave_window=0.005, device=device)
        self.metrics = self.scheduler.metrics
        self.compile_plane = self.scheduler.compile_plane
        self.guard = guard if guard is not None else AdmissionGuard(metrics=self.metrics)
        if self.scheduler.overload is None:
            self.scheduler.overload = self.guard
        self.default_deadline_ms = parse_service_deadline_ms()
        self.trace_enabled = parse_reqtrace() if trace is None else bool(trace)
        self._tracer = Tracer()  # handler spans feed the flight ring
        self.slo = None
        if slo is not False:
            targets = parse_service_slo() if slo in (None, True) else slo
            if targets is not None:
                from ..obs.slo import SLOPlane

                self.slo = SLOPlane(targets, metrics=self.metrics,
                                    escalation=self._slo_escalation)
        log_path = parse_service_access_log() if access_log is None else (access_log or None)
        self.access_log = JsonlSink(log_path) if log_path else None
        self._httpd = None
        self._thread = None
        self._stopped = False

    # -- request handling --------------------------------------------------

    def handle(self, method, path, body, headers=None):
        """Route one request; returns ``(status, payload dict)``.  Pure (no
        socket I/O) so tests can drive it directly.  ``headers`` is a
        lower-cased mapping; a 429/503/507 payload carries ``retry_after``
        seconds, which the HTTP layer also sends as ``Retry-After``.  A
        valid inbound ``traceparent`` continues the caller's trace, a
        malformed one gets a fresh trace, and every answer carries the
        trace id."""
        headers = headers or {}
        observing = self.slo is not None or self.access_log is not None
        if not self.trace_enabled and not observing:
            status, payload = self._handle(method, path, body, headers)
            self._count_response(method, path, status)
            return status, payload
        t0 = time.perf_counter()
        req_id = reqtrace.sanitize_request_id(headers.get("x-request-id"))
        if self.trace_enabled:
            ctx = reqtrace.extract_or_mint(headers.get("traceparent"))
            with reqtrace.use(ctx):
                with self._tracer.span("service.handle", trace=ctx.trace_id, span=ctx.span_id,
                                       method=method, path=path):
                    status, payload = self._handle(method, path, body, headers)
            if isinstance(payload, dict):
                payload.setdefault("trace", ctx.trace_id)
        else:
            ctx = None
            status, payload = self._handle(method, path, body, headers)
        latency = time.perf_counter() - t0
        if req_id and isinstance(payload, dict):
            payload.setdefault("request_id", req_id)
        self._count_response(method, path, status)
        self._observe_response(method, path, status, latency, payload, ctx, req_id,
                               probe=headers.get("x-probe") == "1")
        return status, payload

    def _observe_response(self, method, path, status, latency_sec, payload, ctx, req_id,
                          probe=False):
        """Feed the SLO plane and write the access-log record; never
        raises."""
        ep = self._endpoint_label(method, path)
        shed = bool(status == 429 and isinstance(payload, dict)
                    and payload.get("retry_after") is not None)
        if self.slo is not None and not probe:
            try:
                self.slo.record_request(ep, status, latency_sec=latency_sec, shed=shed)
            except Exception:  # noqa: BLE001 - observability never fails a request
                if not self._slo_warned:
                    self._slo_warned = True
                    logger.warning("slo plane record failed (continuing)", exc_info=True)
        if self.access_log is None:
            return
        try:
            rec = {"kind": "access", "ts": time.time(), "method": method, "path": path,
                   "status": int(status), "latency_ms": round(latency_sec * 1e3, 3),
                   "trace": ctx.trace_id if ctx is not None else None}
            if probe:
                rec["probe"] = True
            if req_id:
                rec["request_id"] = req_id
            if isinstance(payload, dict):
                if status >= 400 and payload.get("error"):
                    rec["reason"] = str(payload["error"])[:200]
                if shed:
                    rec["shed"] = True
                if payload.get("degraded"):
                    rec["degraded"] = True
                if payload.get("study_id"):
                    rec["study_id"] = payload["study_id"]
                if payload.get("wave") is not None:
                    rec["wave"] = payload["wave"]
            self.access_log.write(rec)
            from ..obs.flight import get_flight

            get_flight().record(rec)
        except Exception:  # noqa: BLE001
            pass

    def _slo_escalation(self):
        """The SLO plane's fast-burn hook.  The JAX package takes one
        device capture here; the port's capture plane comes with item 14,
        so this logs."""
        logger.warning("SLO fast burn-rate alert: error budget burning hot")

    _slo_warned = False

    @staticmethod
    def _endpoint_label(method, path):
        """Metric-friendly endpoint label (unknown paths pooled)."""
        known = ("/study", "/ask", "/tell", "/close", "/studies", "/metrics", "/snapshot",
                 "/healthz", "/fleet/load", "/probes", "/tenants", "/")
        if path in known:
            return path.strip("/").replace("/", "_") or "root"
        if _timeline_study_id(path) is not None:
            return "timeline"
        return "other"

    def _count_response(self, method, path, status):
        ep = self._endpoint_label(method, path)
        self.metrics.counter(f"service.http.{ep}.{int(status) // 100}xx").inc()

    def _record_failure(self, method, path, exc):
        """A handler exception became a 500: record it in the flight ring."""
        try:
            from ..obs.flight import get_flight

            get_flight().record({"kind": "service_error", "ts": time.time(),
                                 "method": method, "path": path,
                                 "error": f"{type(exc).__name__}: {exc}"})
        except Exception:  # noqa: BLE001
            pass

    def healthz_dict(self):
        """``GET /healthz``: the JAX package's single-server shape (no
        shard table), drain state, WAL and store health."""
        sched = self.scheduler
        out = {"ok": True, "replica": None, "addr": self.url, "n_shards": None,
               "shards_held": [], "shards": {}, "draining": sched._draining,
               "wal_sync_errors": self.metrics.counter("service.wal.sync_errors").value,
               "ts": time.time()}
        if sched.journal is not None:
            out["wal"] = {"path": sched.journal.path, "appends": sched.journal.appends,
                          "syncs": sched.journal.syncs,
                          "compactions": sched.journal.compactions}
        store = sched.store_health()
        out["store"] = store
        if store.get("store_full"):
            out["ok"] = False
        out["ok"] = out["ok"] and not sched._draining
        return out

    def _handle(self, method, path, body, headers):
        try:
            tenant = sanitize_tenant(headers.get("x-tenant"))
            if tenant != ANON:
                raise not_ported(f"the x-tenant header ({tenant!r})", 14)
            if method == "GET":
                if path == "/studies":
                    return 200, self.scheduler.studies_status()
                if path == "/healthz":
                    return 200, self.healthz_dict()
                if path == "/snapshot":
                    return 200, self.snapshot_dict()
                if path in _ITEM_14_ROUTES:
                    raise not_ported(f"GET {path} ({_ITEM_14_ROUTES[path]})", 14)
                sid = _timeline_study_id(path)
                if sid is not None:
                    return 200, self.scheduler.study_timeline(sid)
                if path == "/":
                    return 200, {"ok": True,
                                 "endpoints": ["POST /study", "POST /ask", "POST /tell",
                                               "POST /close", "GET /studies",
                                               "GET /study/<id>/timeline", "GET /healthz",
                                               "GET /metrics", "GET /snapshot"]}
                raise _RequestError(404, f"no such endpoint: {path}")
            if method != "POST":
                raise _RequestError(405, f"{method} not supported")
            if path == "/study":
                return 200, self._create_study(body)
            if path == "/ask":
                study_id = self._required(body, "study_id")
                n = int(body.get("n", 1))
                # the client's ask-idempotency token, sanitized like
                # X-Request-Id
                req_id = body.get("req")
                if not isinstance(req_id, str) or not req_id or len(req_id) > 200:
                    req_id = None
                deadline = Deadline.from_request(headers.get("x-deadline-ms"),
                                                 self.default_deadline_ms)
                token = self.guard.admit_ask(deadline)
                try:
                    trials = self.scheduler.ask(study_id, n, deadline=deadline,
                                                req_id=req_id)
                finally:
                    self.guard.release(token)
                out = {"ok": True, "study_id": study_id,
                       "trials": [{k: t[k] for k in ("tid", "params", "degraded", "algo")
                                   if k in t} for t in trials]}
                wave = next((t.get("wave") for t in trials if t.get("wave") is not None),
                            None)
                if wave is not None:
                    out["wave"] = wave
                if any(t.get("degraded") for t in trials):
                    out["degraded"] = True
                return 200, out
            if path == "/tell":
                study_id = self._required(body, "study_id")
                token = self.guard.admit_tell()
                try:
                    results = body.get("results")
                    batch = results is not None
                    if not batch:
                        results = [{"tid": self._required(body, "tid"),
                                    "loss": body.get("loss"), "status": body.get("status")}]
                    told = dups = 0
                    for r in results:
                        if not isinstance(r, dict) or r.get("tid") is None:
                            raise _RequestError(400, f"each result needs a 'tid': {r!r}")
                        try:
                            self.scheduler.tell(study_id, r["tid"], loss=r.get("loss"),
                                                status=r.get("status"))
                            told += 1
                        except DuplicateTellError:
                            # a retried batch must not strand its untold
                            # tail; a single duplicate still answers 409
                            if not batch:
                                raise
                            dups += 1
                finally:
                    self.guard.release(token)
                return 200, {"ok": True, "study_id": study_id, "told": told,
                             "duplicates": dups}
            if path == "/close":
                study_id = self._required(body, "study_id")
                self.scheduler.close_study(study_id)
                return 200, {"ok": True, "study_id": study_id}
            raise _RequestError(404, f"no such endpoint: {path}")
        except _RequestError as e:
            return e.status, {"ok": False, "error": str(e)}
        except QuarantinedStudyError as e:
            return 410, {"ok": False, "error": str(e), "quarantined": True}
        except StoreFullShed as e:
            return 507, {"ok": False, "error": str(e), "retry_after": e.retry_after}
        except StoreFullError as e:
            return 507, {"ok": False, "error": str(e), "retry_after": 1.0}
        except UnknownStudyError as e:
            return 404, {"ok": False, "error": str(e)}
        except DuplicateTellError as e:
            return 409, {"ok": False, "error": str(e)}
        except DrainingError as e:
            return 503, {"ok": False, "error": str(e), "retry_after": 1.0}
        except OverloadError as e:
            return 429, {"ok": False, "error": str(e), "retry_after": e.retry_after}
        except StudyQuotaError as e:
            return 429, {"ok": False, "error": str(e)}
        except NotImplementedError as e:
            return 501, {"ok": False, "error": str(e)}
        except (SpaceSpecError, ValueError, TypeError) as e:
            return 400, {"ok": False, "error": f"{type(e).__name__}: {e}"}
        except Exception as e:  # noqa: BLE001 - fail-open contract
            logger.warning("service: %s %s failed: %s", method, path, e)
            self._record_failure(method, path, e)
            return 500, {"ok": False, "error": f"{type(e).__name__}: {e}"}

    @staticmethod
    def _required(body, key):
        v = body.get(key)
        if v is None:
            raise _RequestError(400, f"missing required field {key!r}")
        return v

    def _create_study(self, body):
        if "space" in body:
            space = space_from_spec(body["space"])
            space_spec = {"space": body["space"]}
        elif "zoo" in body:
            from ..zoo import ZOO

            rec = ZOO.get(str(body["zoo"]))
            if rec is None:
                raise _RequestError(400, f"unknown zoo domain {body['zoo']!r} "
                                         f"(one of {sorted(ZOO)})")
            space = rec.space
            space_spec = {"zoo": str(body["zoo"])}
        else:
            raise _RequestError(400, "POST /study needs 'space' or 'zoo'")
        kwargs = {k: body[k] for k in _STUDY_KWARGS if k in body}
        if "tenant" in kwargs:
            kwargs["tenant"] = sanitize_tenant(kwargs["tenant"])
        # the wire schema is the WAL registry entry: every HTTP-created
        # study is resumable
        study_id = self.scheduler.create_study(space, seed=int(body.get("seed", 0)),
                                               space_spec=space_spec, **kwargs)
        return {"ok": True, "study_id": study_id}

    def _refresh_compile_gauges(self):
        """The cohort-program cache counters as ``service.compile.*``."""
        from ..algos import tpe

        g = self.metrics.gauge
        stats = tpe.cohort_cache_stats()
        for k in ("hits", "misses", "size"):
            if k in stats:
                g(f"service.compile.cohort_cache.{k}").set(stats[k])

    def snapshot_dict(self):
        """``/snapshot``: the service metrics namespace, the study table,
        the SLO section and the degrade-ladder state."""
        out = {"ts": time.time(), "endpoint": "snapshot", "service": True}
        if self.slo is not None:
            out["slo"] = self.slo.publish()
        self._refresh_compile_gauges()
        out["sections"] = {"service": self.metrics.snapshot()["metrics"]}
        status = self.scheduler.studies_status()
        for key in ("studies", "cohorts", "slot_utilization", "cohort_cache"):
            out[key] = status[key]
        out["draining"] = status.get("draining", False)
        for key in ("degrade", "compile", "wal", "store", "quarantined"):
            if key in status:
                out[key] = status[key]
        return out

    def _refresh_store_gauges(self):
        """Scrape-time disk-watermark poll: a quiet service on a filling
        disk still sees (and sheds) it."""
        try:
            self.scheduler.store_health(force=True)
        except Exception:  # noqa: BLE001 - fail-open scrape
            pass

    # -- lifecycle ---------------------------------------------------------

    @property
    def url(self):
        if self._httpd is None:
            return None
        return f"http://{self.host}:{self._httpd.server_address[1]}"

    def start(self):
        """Bind and serve on a daemon thread; False (after one warning) on
        any bind failure."""
        import http.server

        if self.port is None:
            logger.warning("service: unparseable port/host value; ask/tell serving disabled")
            return False
        handler = _make_handler(self)

        class _Listener(http.server.ThreadingHTTPServer):
            # many clients connect at once: past the default backlog of 5
            # the kernel drops their SYNs, and each retransmits a second later
            request_queue_size = 1024

        try:
            self._httpd = _Listener((self.host, self.port), handler)
        except (OSError, OverflowError, ValueError) as e:
            logger.warning("service: cannot bind %s:%s (%s); ask/tell serving disabled",
                           self.host, self.port, e)
            self._httpd = None
            return False
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        kwargs={"poll_interval": 0.25},
                                        name="hyperopt-service-http", daemon=True)
        self._thread.start()
        logger.info("ask/tell service listening on %s", self.url)
        return True

    def drain(self, timeout=30.0):
        """Graceful shutdown: stop admitting, finish in-flight waves,
        compact and close the WAL, stop serving.  Returns True when the
        scheduler quiesced within ``timeout``."""
        quiesced = self.scheduler.drain(timeout=timeout)
        self.stop()
        return quiesced

    def stop(self):
        if self._stopped:
            return
        self._stopped = True
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            try:
                httpd.shutdown()
                httpd.server_close()
            except Exception:  # noqa: BLE001
                pass
        if self.access_log is not None:
            self.access_log.close()


def _make_handler(server):
    import http.server

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logger.debug("service http: " + fmt, *args)

        def _answer(self, status, payload, content_type="application/json"):
            data = (payload if isinstance(payload, bytes)
                    else json.dumps(payload, default=str, sort_keys=True).encode())
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            if isinstance(payload, dict) and payload.get("trace"):
                self.send_header("X-Trace-Id", str(payload["trace"]))
            if isinstance(payload, dict) and payload.get("request_id"):
                self.send_header("X-Request-Id", str(payload["request_id"]))
            if (status in (429, 503, 507) and isinstance(payload, dict)
                    and payload.get("retry_after") is not None):
                # RFC 7231 delta-seconds are integers: the header rounds
                # up, the JSON keeps the precise float for the client
                self.send_header("Retry-After",
                                 str(max(1, math.ceil(float(payload["retry_after"])))))
            self.end_headers()
            self.wfile.write(data)

        def _dispatch(self, method):
            path = self.path.partition("?")[0]
            try:
                if method == "GET" and path == "/metrics":
                    if server.slo is not None:
                        try:
                            server.slo.publish()
                        except Exception:  # noqa: BLE001 - fail-open scrape
                            pass
                    try:
                        server._refresh_compile_gauges()
                        if server.compile_plane is not None:
                            server.compile_plane.publish()
                    except Exception:  # noqa: BLE001 - fail-open scrape
                        pass
                    server._refresh_store_gauges()
                    server._count_response(method, path, 200)
                    self._answer(200, prometheus_text().encode(),
                                 "text/plain; version=0.0.4; charset=utf-8")
                    return
                body = {}
                if method == "POST":
                    length = int(self.headers.get("Content-Length") or 0)
                    raw = self.rfile.read(length) if length else b"{}"
                    try:
                        body = json.loads(raw or b"{}")
                    except ValueError:
                        self._answer(400, {"ok": False, "error": "body is not JSON"})
                        return
                    if not isinstance(body, dict):
                        self._answer(400, {"ok": False, "error": "body must be a JSON object"})
                        return
                headers = {k.lower(): v for k, v in self.headers.items()}
                status, payload = server.handle(method, path, body, headers=headers)
                self._answer(status, payload)
            except (BrokenPipeError, ConnectionResetError):
                pass  # the client went away mid-write
            except Exception as e:  # noqa: BLE001 - never kill the server
                logger.warning("service http: %s %s failed: %s", method, path, e)
                try:
                    self.send_error(500)
                except Exception:  # noqa: BLE001
                    pass

        def do_GET(self):  # noqa: N802 (stdlib handler contract)
            self._dispatch("GET")

        def do_POST(self):  # noqa: N802
            self._dispatch("POST")

    return Handler


#: the fleet's options (item 13b) and the prober's (item 14)
_FLEET_OPTIONS = ("fleet", "fleet_shards", "replica_id", "addr", "lease_ttl")


def main(argv=None):
    import argparse
    import signal

    p = argparse.ArgumentParser(
        prog="python -m hyperopt_tpu_torch.service.server",
        description="Serve ask/tell hyperparameter optimization over HTTP "
                    "(many concurrent studies batched onto one CUDA card).")
    p.add_argument("--port", default=None,
                   help="bind port or host:port (0 = ephemeral; default: $HYPEROPT_TPU_SERVICE)")
    p.add_argument("--device", default=None,
                   help="where the cohorts tick: the CUDA card by default, 'cpu' to run "
                        "on the CPU")
    p.add_argument("--store", default=None,
                   help="FileStore root: persist each study's trials under <store>/<study_id>")
    p.add_argument("--max-studies", type=int, default=None,
                   help="admission quota (default: $HYPEROPT_TPU_SERVICE_MAX_STUDIES or 4096)")
    p.add_argument("--max-pending", type=int, default=None,
                   help="per-study asked-but-untold quota (default: "
                        "$HYPEROPT_TPU_SERVICE_MAX_PENDING or 64)")
    p.add_argument("--idle-sec", type=float, default=None,
                   help="evict a study's cohort slot after this much inactivity "
                        "(default: $HYPEROPT_TPU_SERVICE_IDLE_SEC or 600)")
    p.add_argument("--wal", default=None,
                   help="write-ahead journal: 'auto' (default: under --store when given), "
                        "'off', or a path (default: $HYPEROPT_TPU_SERVICE_WAL)")
    p.add_argument("--compile-plane", default=None, choices=("on", "off"),
                   help="the signature census and the kernel build before the listener "
                        "opens (default: $HYPEROPT_TPU_COMPILE_PLANE or off)")
    p.add_argument("--bank-top-n", type=int, default=None,
                   help="census cohorts ticked once before the listener opens "
                        "(default: $HYPEROPT_TPU_COMPILE_BANK_TOP_N or 8)")
    p.add_argument("--fleet", action="store_true",
                   help="the replicated serving fleet (not ported: item 13b)")
    p.add_argument("--fleet-shards", type=int, default=None, help="(item 13b)")
    p.add_argument("--replica-id", default=None, help="(item 13b)")
    p.add_argument("--addr", default=None, help="(item 13b)")
    p.add_argument("--lease-ttl", type=float, default=None, help="(item 13b)")
    p.add_argument("--announce", action="store_true",
                   help="print 'SERVICE_URL <url>' once bound")
    p.add_argument("--probe", default=None, choices=("on", "off"),
                   help="the blackbox prober (not ported: item 14)")
    p.add_argument("--probe-period", type=float, default=None, help="(item 14)")
    args = p.parse_args(argv)

    for name in _FLEET_OPTIONS:
        if getattr(args, name) not in (None, False):
            raise not_ported(f"--{name.replace('_', '-')}", "13b")
    if args.probe == "on" or args.probe_period is not None:
        raise not_ported("--probe", 14)
    port = args.port if args.port is not None else parse_service()
    if port is None:
        p.error("no port: pass --port or set HYPEROPT_TPU_SERVICE")
    from .._env import parse_compile_plane

    plane = None
    if args.compile_plane == "on" or (args.compile_plane is None and parse_compile_plane()):
        from .compile_plane import CompilePlane, census_path_for

        plane = CompilePlane(census_path=census_path_for(args.store) if args.store else None,
                             device=args.device)
    wal = None  # resolved from the environment
    if args.wal is not None:
        raw = args.wal.strip().lower()
        if raw in ("auto", "", "1", "on", "true", "yes"):
            wal = None
        elif raw in ("off", "0", "false", "no"):
            wal = False
        else:
            wal = args.wal
    sched = StudyScheduler(max_studies=args.max_studies, max_pending=args.max_pending,
                           idle_sec=args.idle_sec, device=args.device, store_root=args.store,
                           wal=wal, wave_window=0.005,
                           compile_plane=plane if plane is not None else False)
    if plane is not None:
        # after the WAL resume, before the listener opens
        plane.warm_from_census(top_n=args.bank_top_n)
    server = ServiceHTTPServer(port, scheduler=sched)
    if not server.start():
        return 1
    if args.announce:
        print(f"SERVICE_URL {server.url}", flush=True)

    stop = threading.Event()
    prev = signal.signal(signal.SIGTERM, lambda _s, _f: stop.set())
    try:
        while not stop.is_set():
            stop.wait(0.5)
    except KeyboardInterrupt:
        pass
    finally:
        signal.signal(signal.SIGTERM, prev)
        quiesced = server.drain()
        logger.info("service: drained (quiesced=%s); exiting", quiesced)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
