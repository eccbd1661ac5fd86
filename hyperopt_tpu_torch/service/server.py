"""HTTP ask/tell front end over the :class:`StudyScheduler` or a fleet
replica (counterpart of ``hyperopt_tpu/service/server.py``).

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
  ``GET /metrics`` (Prometheus text: the ``service.*``, ``quality.*``,
  ``probe.*`` and ``slo_*`` families), ``GET /snapshot``, ``GET /tenants``
  (the tenant table), ``GET /fleet/load`` (this replica's cost view and
  the fleet-wide heat read from the store root's heat ledgers) and ``GET
  /probes`` (the blackbox prober's verdicts; ``{"armed": false}`` when it
  is off).

Errors are in-band and typed: 400 for a malformed request (a hostile
``x-tenant`` header included), 404 for an unknown study, 409 for a
duplicate tell, 410 for a quarantined study, 429 (+ ``Retry-After`` from
the wave-time EWMA) for a shed, a per-tenant budget or a quota, 503 while
draining, for a shard nobody serves yet and for a fenced shard, 507 when
the store is full, 500 for a handler fault, a kernel's build or launch
included (recorded in the flight ring).
Every request carries a trace id (``obs/reqtrace.py``) and feeds the SLO
plane (``obs/slo.py``), with the quality, load and per-tenant objectives
installed beside the armed planes; ``HYPEROPT_TPU_SERVICE_ACCESS_LOG``
adds a JSONL access log.

Fleet mode: ``--fleet`` (with ``--store``) joins the replicated serving
fleet (``service/fleet.py``): N replicas over one store root share the
study shards, each held shard served by its own scheduler and epoch WAL;
a study another replica owns answers 307 with the owner's address
(``Location`` and the JSON ``location``), which ``ServiceClient``
follows.

Run it with ``python -m hyperopt_tpu_torch.service.server --port 0
--announce --store <root> [--fleet]``: the schedulers run on the CUDA
card unless ``--device cpu`` is given.  SIGTERM drains: stop admitting,
finish the waves in flight, compact and close the WAL (in a fleet, hand
every held shard off), exit 0.

The blackbox prober (``--probe on`` or ``HYPEROPT_TPU_PROBE=1``, period
``--probe-period`` / ``HYPEROPT_TPU_PROBE_PERIOD``) drives a canary study
(``POST /study {"canary": true}``) through this server's own URL once
bound (``obs/prober.py``); its requests carry ``x-probe: 1`` and feed
neither the SLOs nor the tenant ledger.  Disarmed, ``prober`` is None.

The capture plane: with ``HYPEROPT_TPU_PROFILE=<dir>`` the server owns
one :class:`~hyperopt_tpu_torch.obs.profiler.DeviceProfiler` that every
scheduler it fronts serves at its waves.  An SLO fast burn takes one
capture (``reason="slo_burn"``) and a probe mismatch episode one
(``reason="probe_mismatch"``); each is asked for on a short-lived thread
and recorded by the leader of the next wave, the thread whose kernels the
session sees.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time

from .._env import (parse_load, parse_load_slo, parse_quality_slo, parse_reqtrace,
                    parse_service, parse_service_access_log, parse_service_deadline_ms,
                    parse_service_slo, parse_tenant_slo, parse_tenant_top_k,
                    refuse_armed_knobs)
from ..exceptions import StoreFullError
from ..obs import reqtrace
from ..obs.serve import prometheus_text, split_hostport
from ..obs.tenant import ANON, sanitize_tenant
from ..obs.trace import JsonlSink, Tracer
from .fleet import ShardNotOwned, ShardUnavailable
from .overload import AdmissionGuard, Deadline, OverloadError, StoreFullShed
from .scheduler import (DrainingError, DuplicateTellError, QuarantinedStudyError,
                        StaleOwnershipError, StudyQuotaError, StudyScheduler, UnknownStudyError)
from .spacespec import SpaceSpecError, space_from_spec

__all__ = ["ServiceHTTPServer", "main"]

logger = logging.getLogger(__name__)

_STUDY_KWARGS = ("n_startup_jobs", "max_trials", "prior_weight", "n_EI_candidates", "gamma",
                 "linear_forgetting", "ei_select", "ei_tau", "prior_eps", "canary", "tenant")



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
    """Daemon-thread ask/tell server over one scheduler, or over a
    :class:`~hyperopt_tpu_torch.service.fleet.FleetReplica` (``fleet``:
    study-scoped requests route through its shard table, and the replica's
    schedulers run on its device).  ``start()`` warns and returns False on
    a bind failure instead of raising; ``stop()`` is idempotent.  Without
    ``scheduler`` or ``fleet`` it builds ``StudyScheduler(store_root=...,
    wave_window=0.005, device=device)`` (the card unless
    ``device="cpu"``)."""

    def __init__(self, port, scheduler=None, host=None, store_root=None, guard=None,
                 trace=None, slo=None, access_log=None, fleet=None, device=None):
        refuse_armed_knobs("ServiceHTTPServer")
        try:
            if host is None:
                host, port = split_hostport(port)
            self.port = int(port)
        except (TypeError, ValueError):
            self.port = None  # start() warns and fails open
        self.host = host or "127.0.0.1"
        self.fleet = fleet
        if fleet is not None:
            self.scheduler = None
            self.metrics = fleet.metrics
            # fleet replicas share one compile plane through scheduler_kwargs
            self.compile_plane = fleet.scheduler_kwargs.get("compile_plane") or None
        else:
            self.scheduler = scheduler if scheduler is not None else StudyScheduler(
                store_root=store_root, wave_window=0.005, device=device)
            self.metrics = self.scheduler.metrics
            self.compile_plane = self.scheduler.compile_plane
        self.guard = guard if guard is not None else AdmissionGuard(metrics=self.metrics)
        if fleet is not None:
            # every held shard's scheduler feeds the one guard its wave times
            fleet.overload = self.guard
            for sched in fleet.schedulers.values():
                if sched.overload is None:
                    sched.overload = self.guard
        elif self.scheduler.overload is None:
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
        # the planes' objectives, installed beside an armed plane: the
        # stagnant fraction (fed one event per live tell by the quality
        # planes), the fleet imbalance (fed one judged event per load-gauge
        # refresh) and the per-tenant objectives (installed lazily per
        # tenant, at most top-K of them)
        self.load_skew_max = None
        self.tenant_slo = None
        self._tenant_objs = set()
        if self.slo is not None:
            q_targets = parse_quality_slo()
            if q_targets is not None and self._quality_planes():
                for name, spec in q_targets.items():
                    self.slo.add_objective(name, spec)
                for plane in self._quality_planes():
                    plane.slo = self.slo
            l_targets = parse_load_slo()
            # a fleet adopts its shards after this, so judge "a cost ledger
            # is armed" from the kwargs its schedulers will be built with
            kw_load = fleet.scheduler_kwargs.get("load") if fleet is not None else False
            armed = bool(self._load_planes()) or (
                fleet is not None and kw_load is not False
                and (kw_load is not None or parse_load()))
            if l_targets is not None and armed:
                for name, spec in l_targets.items():
                    self.slo.add_objective(name, spec)
                self.load_skew_max = l_targets.get("imbalance", {}).get("skew_max")
            self.tenant_slo = parse_tenant_slo()
            self._tenant_obj_bound = parse_tenant_top_k()
        log_path = parse_service_access_log() if access_log is None else (access_log or None)
        self.access_log = JsonlSink(log_path) if log_path else None
        # the capture plane (HYPEROPT_TPU_PROFILE=<dir>): one profiler whose
        # captures the schedulers' wave leaders record; None when unarmed
        self.profiler = self._arm_capture_plane()
        # the blackbox prober: None until arm_prober() (no thread, no
        # probe objective while disarmed)
        self.prober = None
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
        observing = (self.slo is not None or self.access_log is not None
                     or bool(self._tenant_planes()))
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
        try:
            # a hostile id answered 400 already and is charged to no one
            tenant = sanitize_tenant(headers.get("x-tenant"))
        except ValueError:
            tenant = None
        self._observe_response(method, path, status, latency, payload, ctx, req_id,
                               probe=headers.get("x-probe") == "1", tenant=tenant)
        return status, payload

    def _observe_response(self, method, path, status, latency_sec, payload, ctx, req_id,
                          probe=False, tenant=None):
        """Feed the SLO plane, the tenant ledger (a finished ask's latency
        or shed) and the access-log record; never raises.  Probe traffic
        (``x-probe: 1``) feeds neither the SLOs nor the tenant ledger."""
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
        if tenant is not None and not probe and ep == "ask":
            try:
                self._observe_tenant(tenant, payload, status, latency_sec, shed)
            except Exception:  # noqa: BLE001 - observability never fails a request
                pass
        if self.access_log is None:
            return
        try:
            rec = {"kind": "access", "ts": time.time(), "method": method, "path": path,
                   "status": int(status), "latency_ms": round(latency_sec * 1e3, 3),
                   "trace": ctx.trace_id if ctx is not None else None}
            if probe:
                rec["probe"] = True
            if tenant is not None and tenant != ANON:
                rec["tenant"] = tenant
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

    def _arm_capture_plane(self):
        """The server's :class:`DeviceProfiler` when ``HYPEROPT_TPU_PROFILE``
        names a capture directory, attached to every scheduler it fronts
        (a fleet's later shards get it through their kwargs); else None."""
        from ..obs.profiler import DeviceProfiler, split_profile_mode

        cap_dir, _full = split_profile_mode(os.environ.get("HYPEROPT_TPU_PROFILE"))
        if cap_dir is None:
            return None
        prof = DeviceProfiler(cap_dir)
        if self.fleet is not None:
            self.fleet.scheduler_kwargs["profiler"] = prof
        for sched in self._schedulers():
            sched.set_profiler(prof)
        return prof

    def _slo_escalation(self):
        """The SLO plane's fast-burn hook: one wave capture when the capture
        plane is armed (the plane's cooldown bounds how often), a warning
        either way."""
        if self.profiler is None:
            logger.warning("SLO fast burn-rate alert: error budget burning hot (no device "
                           "capture: arm HYPEROPT_TPU_PROFILE=<dir> to get one)")
            return
        logger.warning("SLO fast burn-rate alert: error budget burning hot; capturing a wave")
        # recorded by the next wave's leader: the hook fires on a handler
        # thread, which must neither wait for a wave nor record one
        from ..obs.profiler import ESCALATION_CAPTURE_SEC

        self.profiler.capture_async(ESCALATION_CAPTURE_SEC, "slo_burn")

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

    def _route(self, study_id):
        """The scheduler serving ``study_id``: ``self.scheduler``, or in a
        fleet the replica's shard table (which raises
        :class:`ShardNotOwned`, a 307, or :class:`ShardUnavailable`, a
        503)."""
        if self.fleet is None:
            return self.scheduler
        return self.fleet.scheduler_for(study_id)

    def healthz_dict(self):
        """``GET /healthz``: the replica's shard table in a fleet, else the
        same shape with no shards; drain state, WAL and store health."""
        if self.fleet is not None:
            out = self.fleet.healthz()
            if self.prober is not None:
                # fail-open: the verdict never flips `ok`
                out["probe"] = self.prober.healthz_fields()
            return out
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
        if sched.tenants is not None:
            try:
                ts = sched.tenants.status()
                out["tenants"] = {"tracked": ts["tenants"], "sheds": ts["sheds"],
                                  "evictions": ts["evictions"]}
            except Exception:  # noqa: BLE001 - fail-open roll-up
                pass
        out["ok"] = out["ok"] and not sched._draining
        if self.prober is not None:
            out["probe"] = self.prober.healthz_fields()
        return out

    def _studies_status(self):
        if self.fleet is not None:
            return self.fleet.studies_status()
        return self.scheduler.studies_status()

    def _handle(self, method, path, body, headers):
        try:
            # a malformed x-tenant answers 400 on every route
            tenant = sanitize_tenant(headers.get("x-tenant"))
            if method == "GET":
                if path == "/studies":
                    return 200, self._studies_status()
                if path == "/tenants":
                    return 200, self.tenants_dict()
                if path == "/healthz":
                    return 200, self.healthz_dict()
                if path == "/snapshot":
                    return 200, self.snapshot_dict()
                if path == "/fleet/load":
                    return 200, self.fleet_load_dict()
                if path == "/probes":
                    return 200, self.probes_dict()
                sid = _timeline_study_id(path)
                if sid is not None:
                    return 200, self._route(sid).study_timeline(sid)
                if path == "/":
                    return 200, {"ok": True,
                                 "endpoints": ["POST /study", "POST /ask", "POST /tell",
                                               "POST /close", "GET /studies",
                                               "GET /study/<id>/timeline", "GET /healthz",
                                               "GET /metrics", "GET /snapshot",
                                               "GET /fleet/load", "GET /tenants",
                                               "GET /probes"]}
                raise _RequestError(404, f"no such endpoint: {path}")
            if method != "POST":
                raise _RequestError(405, f"{method} not supported")
            if path == "/study":
                return 200, self._create_study(body, tenant)
            if path == "/ask":
                study_id = self._required(body, "study_id")
                sched = self._route(study_id)
                n = int(body.get("n", 1))
                # the client's ask-idempotency token, sanitized like
                # X-Request-Id
                req_id = body.get("req")
                if not isinstance(req_id, str) or not req_id or len(req_id) > 200:
                    req_id = None
                deadline = Deadline.from_request(headers.get("x-deadline-ms"),
                                                 self.default_deadline_ms)
                token = self.guard.admit_ask(deadline, tenant=tenant)
                try:
                    trials = sched.ask(study_id, n, deadline=deadline, req_id=req_id)
                finally:
                    self.guard.release(token, tenant=tenant)
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
                sched = self._route(study_id)
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
                            sched.tell(study_id, r["tid"], loss=r.get("loss"),
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
                self._route(study_id).close_study(study_id)
                return 200, {"ok": True, "study_id": study_id}
            raise _RequestError(404, f"no such endpoint: {path}")
        except _RequestError as e:
            return e.status, {"ok": False, "error": str(e)}
        except ShardNotOwned as e:
            # another replica serves the study's shard: the HTTP layer sends
            # Location and the client re-issues the same request there
            return 307, {"ok": False, "error": str(e), "location": e.location}
        except ShardUnavailable as e:
            return 503, {"ok": False, "error": str(e), "retry_after": e.retry_after}
        except StaleOwnershipError as e:
            # this replica lost the shard's lease at the fence: nothing
            # landed; the retry meets the new owner's 307
            return 503, {"ok": False, "error": str(e), "retry_after": 0.25}
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

    def _create_study(self, body, header_tenant=ANON):
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
        # a body tenant wins; the (sanitized) x-tenant header covers
        # clients that only set the ambient identity
        if "tenant" not in kwargs and header_tenant != ANON:
            kwargs["tenant"] = header_tenant
        # the wire schema is the WAL registry entry: every HTTP-created
        # study is resumable
        if self.fleet is not None:
            # a fleet mints an id landing in a held shard (creation cannot
            # redirect); the id already claimed its store directory
            study_id, sched = self.fleet.place_study()
            sched.create_study(space, seed=int(body.get("seed", 0)), study_id=study_id,
                               space_spec=space_spec, **kwargs)
            return {"ok": True, "study_id": study_id}
        study_id = self.scheduler.create_study(space, seed=int(body.get("seed", 0)),
                                               space_spec=space_spec, **kwargs)
        return {"ok": True, "study_id": study_id}

    def _schedulers(self):
        """Every scheduler this server fronts: the held shards' in a fleet."""
        if self.fleet is not None:
            return list(self.fleet.schedulers.values())
        return [self.scheduler] if self.scheduler is not None else []

    def _quality_planes(self):
        return [s.quality for s in self._schedulers() if s.quality is not None]

    def _load_planes(self):
        return [s.load for s in self._schedulers() if s.load is not None]

    def _tenant_planes(self):
        return [s.tenants for s in self._schedulers() if s.tenants is not None]

    def _refresh_quality_gauges(self):
        """Scrape-time ``quality.*`` refresh; the merged section, or None
        when disarmed."""
        from ..obs.quality import merge_status

        try:
            return merge_status([p.publish() for p in self._quality_planes()])
        except Exception:  # noqa: BLE001 - fail-open scrape
            return None

    def _refresh_load_gauges(self):
        """Scrape-time ``service.load.*`` refresh: each ledger's per-shard
        gauges, the replica's merged family (totals, busy fraction, heat
        skew) and one judged event for the ``imbalance`` objective.  The
        merged section, or None when disarmed."""
        from ..obs.load import merge_status

        try:
            merged = merge_status([p.publish() for p in self._load_planes()])
        except Exception:  # noqa: BLE001 - fail-open scrape
            return None
        if merged is None:
            return None
        try:
            g = self.metrics.gauge
            for k in ("device_ms", "heat_ms", "busy_frac", "heat_skew", "studies"):
                g(f"service.load.{k}").set(merged[k])
            if self.slo is not None and self.load_skew_max:
                self.slo.record_load(merged["heat_skew"] <= self.load_skew_max)
        except Exception:  # noqa: BLE001 - fail-open scrape
            pass
        return merged

    def _tenant_plane_for(self, payload):
        """The tenant ledger of the request's study (a routing miss falls
        back to the first armed ledger: the merge sums them)."""
        if self.fleet is None:
            return self.scheduler.tenants
        sid = payload.get("study_id") if isinstance(payload, dict) else None
        if sid:
            try:
                return self.fleet.scheduler_for(sid).tenants
            except Exception:  # noqa: BLE001 - not owned, or mid-handoff
                pass
        planes = self._tenant_planes()
        return planes[0] if planes else None

    def _observe_tenant(self, tenant, payload, status, latency_sec, shed):
        """One finished ask's tenant accounting: the ledger's latency or
        shed, and the per-tenant SLO events."""
        plane = self._tenant_plane_for(payload)
        if plane is not None:
            if shed or status == 429:
                plane.observe_request(tenant, shed=True)
            elif status == 200:
                plane.observe_request(tenant, latency_sec=latency_sec)
        if self.slo is None or not self.tenant_slo:
            return
        self._ensure_tenant_objectives(tenant)
        pre = f"tenant:{tenant}:"
        self.slo.record_event(pre + "availability", status < 500)
        self.slo.record_event(pre + "shed_rate", not (shed or status == 429))
        if status == 200:
            thr = float(self.tenant_slo.get("ask_p99", {}).get("threshold_ms") or 2000.0)
            self.slo.record_event(pre + "ask_p99", latency_sec * 1e3 <= thr)

    def _ensure_tenant_objectives(self, tenant):
        """Install a tenant's objectives once, for at most top-K tenants
        (past the bound a tenant still counts in the ledger's ``other``)."""
        if tenant in self._tenant_objs or len(self._tenant_objs) >= self._tenant_obj_bound:
            return
        for name, spec in self.tenant_slo.items():
            self.slo.add_objective(f"tenant:{tenant}:{name}", spec)
        self._tenant_objs.add(tenant)

    def _refresh_tenant_gauges(self):
        """Scrape-time ``service.tenant.*`` refresh from the merged ledgers
        (set once, so shards never overwrite each other), installing the
        merged tenants' objectives.  The merged section, or None when
        disarmed."""
        from ..obs.tenant import _metric_label, merge_status

        try:
            merged = merge_status([p.status() for p in self._tenant_planes()])
        except Exception:  # noqa: BLE001 - fail-open scrape
            return None
        if merged is None:
            return None
        try:
            g = self.metrics.gauge
            g("service.tenant.tracked").set(merged["tenants"])
            for k in ("evictions", "sheds", "device_ms"):
                g(f"service.tenant.{k}").set(merged[k])
            for tenant, row in merged["table"].items():
                base = f"service.tenant.{_metric_label(tenant)}"
                for k in ("device_ms", "asks", "tells", "sheds", "studies"):
                    g(f"{base}.{k}").set(row[k])
                if row.get("ask_p99_ms") is not None:
                    g(f"{base}.ask_p99_ms").set(row["ask_p99_ms"])
            if self.slo is not None and self.tenant_slo:
                for tenant in merged["table"]:
                    if tenant != "other":
                        self._ensure_tenant_objectives(tenant)
        except Exception:  # noqa: BLE001 - fail-open scrape
            pass
        return merged

    def tenants_dict(self):
        """``GET /tenants``: the bounded per-tenant table (merged across
        shards), or ``{"armed": false}`` when the ledger is disarmed."""
        out = {"ok": True, "ts": time.time(), "endpoint": "tenants"}
        merged = self._refresh_tenant_gauges()
        out["armed"] = merged is not None
        if merged is not None:
            out.update(merged)
        return out

    def fleet_load_dict(self):
        """``GET /fleet/load``: this replica's merged cost view, its
        tenant table, and the fleet-wide heat (and per-tenant heat) read
        from every replica's ledger under the store root."""
        out = {"ok": True, "ts": time.time(), "endpoint": "fleet_load"}
        merged = self._refresh_load_gauges()
        if merged is not None:
            out["local"] = merged
        ten = self._refresh_tenant_gauges()
        if ten is not None:
            out["tenants"] = ten
        if self.fleet is not None:
            out["replica"] = self.fleet.replica_id
            store_root = self.fleet.store_root
        else:
            store_root = self.scheduler.store_root
        if store_root is not None:
            from ..obs.load import read_heat
            from ..obs.tenant import read_tenant_heat

            try:
                out["fleet"] = read_heat(store_root)
            except Exception:  # noqa: BLE001 - fail-open read
                logger.warning("fleet/load: heat-ledger read failed", exc_info=True)
            try:
                heat = read_tenant_heat(store_root)["tenants"]
                if heat:
                    out["tenant_heat"] = heat
            except Exception:  # noqa: BLE001 - fail-open read
                pass
        return out

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
        for key, section in (("quality", self._refresh_quality_gauges()),
                             ("load", self._refresh_load_gauges()),
                             ("tenants", self._refresh_tenant_gauges())):
            if section is not None:
                out[key] = section
        self._refresh_compile_gauges()
        out["sections"] = {"service": self.metrics.snapshot()["metrics"]}
        status = self._studies_status()
        for key in ("studies", "cohorts", "slot_utilization", "cohort_cache"):
            out[key] = status[key]
        out["draining"] = status.get("draining", False)
        for key in ("fleet", "degrade", "compile", "wal", "store", "quarantined"):
            if key in status:
                out[key] = status[key]
        if self.prober is not None:
            out["probes"] = self.prober.status_dict()
        return out

    def probes_dict(self):
        """``GET /probes``: the prober's rolling verdict view, or
        ``{"armed": false}`` when it is disarmed."""
        out = {"ok": True, "ts": time.time(), "endpoint": "probes"}
        if self.prober is None:
            out["armed"] = False
            return out
        try:
            out.update(self.prober.status_dict())
        except Exception:  # noqa: BLE001 - fail-open scrape
            out["armed"] = True
            out["error"] = "probe status unavailable"
        return out

    def _refresh_store_gauges(self):
        """Scrape-time disk-watermark poll: a quiet service on a filling
        disk still sees (and sheds) it."""
        try:
            for sched in self._schedulers():
                sched.store_health(force=True)
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
        compact and close the WAL (in a fleet, hand every held shard off so
        a survivor adopts it), stop serving.  The prober stops first, so a
        drain renders no error verdict.  Returns True when everything
        quiesced within ``timeout``."""
        self._stop_prober()
        if self.fleet is not None:
            quiesced = self.fleet.drain(timeout=timeout)
        else:
            quiesced = self.scheduler.drain(timeout=timeout)
        self.stop()
        return quiesced

    def arm_prober(self, period=None, targets=None):
        """Arm the blackbox prober against this server once it is bound
        (it probes the bound URL through the real HTTP path): install the
        ``probe_*`` SLO objectives (only now), put the sealed verdict
        ledger under the store root when there is one, hand it the capture
        plane, and start its thread.  Idempotent; returns the prober, or
        None when the server is not bound."""
        if self.prober is not None:
            return self.prober
        if not targets and self.url is None:
            logger.warning("probe: server is not bound; prober stays disarmed")
            return None
        from .._env import parse_probe_period, parse_probe_slo
        from ..obs.prober import Prober, _backend_key, probes_path_for

        slo_targets = parse_probe_slo() if self.slo is not None else None
        if slo_targets:
            for name, spec in slo_targets.items():
                self.slo.add_objective(name, spec)
        if self.fleet is not None:
            replica, store_root = self.fleet.replica_id, self.fleet.store_root
            wal_path = None  # per-(shard, epoch) WALs; evidence skips it
            device = self.fleet.device
        else:
            replica, store_root = "single", self.scheduler.store_root
            j = self.scheduler.journal
            wal_path = j.path if j is not None else None
            device = self.scheduler.device
        self.prober = Prober(
            list(targets) if targets else [self.url],
            period=period if period is not None else parse_probe_period(),
            slo=self.slo if slo_targets else None, metrics=self.metrics,
            ledger_path=probes_path_for(store_root, replica) if store_root else None,
            replica=replica, wal_path=wal_path, backend=_backend_key(device),
            profiler=self.profiler)
        self.prober.start()
        logger.info("blackbox prober armed: %s every %.3gs", self.prober.targets,
                    self.prober.period)
        return self.prober

    def _stop_prober(self):
        if self.prober is not None:
            try:
                self.prober.stop()
            except Exception:  # noqa: BLE001
                pass

    def stop(self):
        if self._stopped:
            return
        self._stopped = True
        self._stop_prober()
        if self.profiler is not None:
            # a capture still waiting for a wave goes back to its caller
            for sched in self._schedulers():
                sched.set_profiler(None)
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
            if status == 307 and isinstance(payload, dict) and payload.get("location"):
                # the fleet's redirect to the owner (the JSON carries it too)
                self.send_header("Location", str(payload["location"]))
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
                    server._refresh_quality_gauges()
                    server._refresh_load_gauges()
                    server._refresh_tenant_gauges()
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
                   help="where the cohorts tick (every shard's, with --fleet): the CUDA "
                        "card by default, 'cpu' to run on the CPU")
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
                   help="join the replicated serving fleet on --store: leased study "
                        "shards, per-shard epoch WALs, 307 routing (needs --store)")
    p.add_argument("--fleet-shards", type=int, default=None,
                   help="study-shard count (write-once per store root; default: "
                        "$HYPEROPT_TPU_FLEET_SHARDS or 8)")
    p.add_argument("--replica-id", default=None,
                   help="this replica's fleet identity (default: <hostname>-<pid>)")
    p.add_argument("--addr", default=None,
                   help="the URL this replica advertises in the ownership table "
                        "(default: $HYPEROPT_TPU_FLEET_ADDR or the bound URL)")
    p.add_argument("--lease-ttl", type=float, default=None,
                   help="shard-lease reclaim TTL in seconds (default: "
                        "$HYPEROPT_TPU_FLEET_LEASE_TTL or 15)")
    p.add_argument("--announce", action="store_true",
                   help="print 'SERVICE_URL <url>' once bound")
    p.add_argument("--probe", default=None, choices=("on", "off"),
                   help="the blackbox prober: pinned-seed canary studies through this "
                        "server's HTTP path, verdicts on GET /probes (default: "
                        "$HYPEROPT_TPU_PROBE or off)")
    p.add_argument("--probe-period", type=float, default=None,
                   help="probe cycle period in seconds (default: "
                        "$HYPEROPT_TPU_PROBE_PERIOD or 30)")
    args = p.parse_args(argv)

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
    if args.fleet:
        if not args.store:
            p.error("--fleet needs --store (the shared store root is the fleet's "
                    "coordination plane)")
        if args.wal is not None:
            p.error("--wal does not compose with --fleet: each shard journals to its own "
                    "epoch WAL under <store>/fleet/wal/")
        from .._env import parse_fleet_addr
        from .fleet import FleetReplica

        replica = FleetReplica(
            args.store, n_shards=args.fleet_shards, replica_id=args.replica_id,
            lease_ttl=args.lease_ttl, device=args.device,
            scheduler_kwargs={"max_studies": args.max_studies,
                              "max_pending": args.max_pending, "idle_sec": args.idle_sec,
                              "wave_window": 0.005,
                              "compile_plane": plane if plane is not None else False})
        if plane is not None:
            plane.warm_from_census(top_n=args.bank_top_n)
        server = ServiceHTTPServer(port, fleet=replica)
        if not server.start():
            return 1
        # advertise after the bind (an ephemeral port has no address until
        # now), and claim shards only then, so every published ownership
        # entry routes somewhere reachable
        replica.set_addr(args.addr or parse_fleet_addr() or server.url)
        replica.start()
    else:
        sched = StudyScheduler(max_studies=args.max_studies, max_pending=args.max_pending,
                               idle_sec=args.idle_sec, device=args.device,
                               store_root=args.store, wal=wal, wave_window=0.005,
                               compile_plane=plane if plane is not None else False)
        if plane is not None:
            # after the WAL resume, before the listener opens
            plane.warm_from_census(top_n=args.bank_top_n)
        server = ServiceHTTPServer(port, scheduler=sched)
        if not server.start():
            return 1
    if args.announce:
        print(f"SERVICE_URL {server.url}", flush=True)
    from .._env import parse_probe

    if args.probe == "on" or (args.probe is None and parse_probe()):
        server.arm_prober(period=args.probe_period)

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
