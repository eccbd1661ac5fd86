"""Retry-aware HTTP client for the ask/tell service (counterpart of
``hyperopt_tpu/service/client.py``, copied: host-only).

The smoke scripts and tests used to drive the server with ad-hoc
``urllib`` calls and bare ``time.sleep`` loops; every harness
re-invented (differently) what to do about a 429, a draining 503 or a
connection reset.  This helper wires :class:`~hyperopt_tpu_torch.retry.RetryPolicy`
into one place:

* **Retryable**: 429, 503 and 507 responses (honoring the server's
  ``Retry-After`` as a FLOOR under the policy's jittered exponential
  backoff — ``RetryPolicy.delay_after``; 507 is the
  store-full shed — the disk is compacting/GCing and recovers),
  connection-level failures (refused / reset / timeout — the
  crash-restart window the WAL resume gate drives traffic through).
* **Not retryable**: every other status.  A 409 on ``tell`` deserves a
  special note: it means "already told" — for a client retrying a tell
  whose RESPONSE was lost, that is success, and :meth:`tell` reports it
  as such (``duplicate=True``) instead of raising.
* **Deterministic**: backoff jitter comes from the policy's
  ``(key, attempt)`` scheme — two clients hammering a shed server
  spread out, and tests replay exact schedules with an injected
  ``sleep``.

``ServiceClient`` is deliberately tiny — a serving-protocol helper for
harnesses, not an SDK.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
import urllib.error
import urllib.request

from ..obs import reqtrace
from ..obs.trace import Tracer
from ..retry import RetryPolicy

__all__ = ["ServiceClient", "ServiceUnavailable"]

#: client attempt spans feed the process flight ring (sink-less tracer):
#: the client half of the request-trace arc, visible in postmortems
_tracer = Tracer()


class ServiceUnavailable(RuntimeError):
    """Retries exhausted against a shedding/unreachable server; carries
    the last status code (or None for connection-level failures)."""

    def __init__(self, message, status=None):
        super().__init__(message)
        self.status = status


#: connection-level failures worth retrying: the server restarting
#: (refused), dying mid-response (reset/aborted — a SIGKILL between
#: the status line and the body surfaces as IncompleteRead/
#: BadStatusLine, i.e. http.client.HTTPException), or wedged
#: (timeout).  Retrying a possibly-served ask is safe: the per-ask
#: idempotency token answers the original trials.
_CONN_ERRORS = (ConnectionError, TimeoutError, urllib.error.URLError,
                OSError, http.client.HTTPException)


class ServiceClient:
    """One service endpoint + one retry policy.  ``retry`` coerces like
    every other retry knob in the repo (None/int/policy); the default
    absorbs a server restart (5 retries, 0.2s base ≈ 6s worst case).

    Fleet-aware: ``url`` may be a LIST of replica addresses —
    the first is the primary, the rest are failover seeds rotated to on
    connection-level errors.  A 307 answer (the study's shard is owned
    by another replica) is followed to its ``location`` with a bounded
    hop count (``max_hops``); the resolved owner is cached per study so
    steady-state traffic goes straight to the right replica.  A hop
    budget exhausted (redirect loop / stale ownership table) — or a
    retryable status from a cached route — drops the cache entry and
    degrades to plain retry-with-backoff from the seed list, so routing
    staleness is never worse than a 429."""

    #: bound on 307 redirects followed within one attempt: a loop or a
    #: stale-table ping-pong degrades to backoff instead of spinning
    max_hops = 4

    def __init__(self, url, retry=None, timeout=60.0, deadline_ms=None,
                 sleep=time.sleep, key=0, trace=None, headers=None,
                 tenant=None):
        from .._env import parse_reqtrace
        from ..obs.tenant import ANON, sanitize_tenant

        urls = [url] if isinstance(url, str) else list(url)
        self.urls = [str(u).rstrip("/") for u in urls]
        # static extra headers on EVERY request (the blackbox prober
        # stamps ``x-probe: 1`` so canary traffic stays out of the
        # server-side tenant SLO objectives); attempt-scoped headers
        # (traceparent) still layer on top
        self.headers = dict(headers or {})
        # tenant identity: sanitized client-side (same rules
        # the server enforces — fail fast at construction, not per
        # request) and stamped on EVERY request via the static headers,
        # so mid-study traffic (ask/tell/close), retries and 307 fleet
        # redirects all attribute to the same principal.  "anon" sends
        # no header, as a client without a tenant sends.
        self.tenant = sanitize_tenant(tenant)
        if self.tenant != ANON:
            self.headers.setdefault("x-tenant", self.tenant)
        self.retry = (RetryPolicy(max_retries=5, base_delay=0.2,
                                  max_delay=5.0)
                      if retry is None else RetryPolicy.coerce(retry))
        self.timeout = float(timeout)
        self.deadline_ms = deadline_ms
        self._sleep = sleep
        self._key = key
        self.retries = 0  # total backoffs taken (harness assertions)
        self.redirects = 0  # total 307 hops followed (harness assertions)
        self._routes = {}  # study_id -> owning replica base URL (fleet)
        # request tracing: ONE trace id per logical request —
        # every RetryPolicy attempt reuses it with a FRESH span id, so
        # the server (and the WAL) can tie a client's retries together
        self.trace_enabled = (parse_reqtrace() if trace is None
                              else bool(trace))
        # per-THREAD request-trace state: a shared client may serve
        # concurrent request() calls, and instance-level attempt headers
        # would cross-attribute traces between threads (the pre-trace
        # client built headers from immutable config only)
        self._tls = threading.local()

    # trace id of the calling thread's last logical request, and its
    # per-attempt span ids (harness assertions read these from the same
    # thread that issued the request)
    @property
    def last_trace(self):
        return getattr(self._tls, "last_trace", None)

    @last_trace.setter
    def last_trace(self, v):
        self._tls.last_trace = v

    @property
    def last_spans(self):
        if not hasattr(self._tls, "last_spans"):
            self._tls.last_spans = []
        return self._tls.last_spans

    @last_spans.setter
    def last_spans(self, v):
        self._tls.last_spans = v

    @property
    def _attempt_headers(self):
        return getattr(self._tls, "attempt_headers", None)

    @_attempt_headers.setter
    def _attempt_headers(self, v):
        self._tls.attempt_headers = v

    @property
    def url(self):
        """The attempt-scoped base URL (thread-local, set by
        :meth:`request` for redirect-following and seed rotation);
        outside a request, the primary seed."""
        return getattr(self._tls, "base", None) or self.urls[0]

    @url.setter
    def url(self, v):
        # back-compat: harnesses that retarget a client mid-test
        # (`client.url = new_url`) replace the whole seed list
        self.urls = [str(v).rstrip("/")]
        self._routes.clear()
        self._tls.base = None

    # -- transport ---------------------------------------------------------

    def _once(self, method, path, body):
        """One HTTP exchange → ``(status, payload, retry_after)``.
        Attempt-scoped headers (the ``traceparent`` of THIS attempt)
        ride in ``self._attempt_headers`` — the signature stays what
        every harness that monkeypatches ``_once`` expects."""
        headers = {"Content-Type": "application/json"}
        if self.headers:
            headers.update(self.headers)
        if self.deadline_ms is not None:
            headers["X-Deadline-Ms"] = str(self.deadline_ms)
        if self._attempt_headers:
            headers.update(self._attempt_headers)
        data = (json.dumps(body).encode()
                if method == "POST" else None)
        req = urllib.request.Request(self.url + path, data=data,
                                     headers=headers, method=method)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return r.status, json.loads(r.read()), None
        except urllib.error.HTTPError as e:
            retry_after = e.headers.get("Retry-After")
            try:
                payload = json.loads(e.read())
            except ValueError:
                payload = {"ok": False, "error": f"HTTP {e.code}"}
            return e.code, payload, retry_after

    def request(self, method, path, body=None,
                retryable=(429, 503, 507)):
        """One logical request with retry/backoff.  Returns
        ``(status, payload)`` for any non-retryable answer; raises
        :class:`ServiceUnavailable` when retries run out.  With tracing
        armed, all attempts share one trace id (fresh span id each) and
        the attempt span + ``traceparent`` header carry it.

        Fleet routing: the attempt base starts from the study's cached
        owner (else the seed list); a 307 answer re-issues at its
        ``location`` immediately (no backoff, no retry consumed, at most
        ``max_hops`` per attempt — past that the redirect is treated as
        retryable).  Connection-level failures rotate to the next seed
        URL and drop the study's cached route (the owner may have
        died — the survivor's table answers the next 307)."""
        body = body or {}
        sid = body.get("study_id") if isinstance(body, dict) else None
        last_status, last_err = None, None
        attempt = 0
        hops = 0
        seed_i = 0
        base = self._routes.get(sid) if sid is not None else None
        first = True
        root = reqtrace.mint() if self.trace_enabled else None
        if root is not None:
            self.last_trace = root.trace_id
            self.last_spans = []
        while True:
            ctx = None
            self._attempt_headers = None
            self._tls.base = base or self.urls[seed_i % len(self.urls)]
            if root is not None:
                # fresh span per ATTEMPT (and per redirect hop) under
                # the one logical trace
                ctx = (root if first else reqtrace.child(root))
                self.last_spans.append(ctx.span_id)
                self._attempt_headers = {
                    "traceparent": ctx.traceparent()}
            first = False
            try:
                if ctx is not None:
                    with _tracer.span("client.request",
                                      trace=ctx.trace_id,
                                      span=ctx.span_id, attempt=attempt,
                                      path=path):
                        status, payload, retry_after = self._once(
                            method, path, body)
                else:
                    status, payload, retry_after = self._once(
                        method, path, body)
            except _CONN_ERRORS as e:
                status, payload, retry_after = None, None, None
                last_err = e
                # this base is unreachable: forget any cached route
                # through it and rotate to the next seed
                if sid is not None:
                    self._routes.pop(sid, None)
                base = None
                seed_i += 1
            if (status == 307 and isinstance(payload, dict)
                    and payload.get("location")):
                hops += 1
                self.redirects += 1
                if hops <= self.max_hops:
                    base = str(payload["location"]).rstrip("/")
                    if sid is not None:
                        self._routes[sid] = base
                    continue  # immediate re-issue: no backoff consumed
                # hop budget exhausted: a redirect loop or a stale
                # ownership table — degrade to plain backoff from seeds
                if sid is not None:
                    self._routes.pop(sid, None)
                base = None
                hops = 0
            elif status is not None and status not in retryable:
                return status, payload
            elif status is not None:
                # retryable answer: drop any cached route (the shard may
                # be mid-migration; a seed will 307 to the new owner)
                # and rotate to the next seed — a draining/overloaded
                # replica must not eat the whole retry budget while a
                # healthy peer could serve (sid-less /study included)
                if sid is not None:
                    self._routes.pop(sid, None)
                if base is None:
                    seed_i += 1
                base = None
            last_status = status if status is not None else last_status
            if not self.retry.retries_left(attempt + 1):
                raise ServiceUnavailable(
                    f"{method} {path}: retries exhausted "
                    f"(last status {last_status}, last error {last_err})",
                    status=last_status)
            # the JSON payload carries the precise hint; the header is
            # RFC delta-seconds (integer, rounded up) — prefer precise
            if isinstance(payload, dict) \
                    and payload.get("retry_after") is not None:
                retry_after = payload["retry_after"]
            floor = 0.0
            if retry_after is not None:
                try:
                    floor = float(retry_after)
                except (TypeError, ValueError):
                    pass
            self._sleep(self.retry.delay_after(
                attempt, key=f"{self._key}:{path}", floor=floor))
            self.retries += 1
            attempt += 1
            hops = 0

    # -- protocol helpers --------------------------------------------------

    def create_study(self, space=None, zoo=None, **kwargs):
        body = dict(kwargs)
        if space is not None:
            body["space"] = space
        if zoo is not None:
            body["zoo"] = zoo
        if self.tenant != "anon":
            # explicit in the body too (the header already rides): the
            # admit record's tenant must survive any proxy that strips
            # unknown request headers
            body.setdefault("tenant", self.tenant)
        status, payload = self.request("POST", "/study", body)
        if status != 200:
            raise ServiceUnavailable(
                f"/study failed: {payload.get('error')}", status=status)
        return payload["study_id"]

    def ask(self, study_id, n=1):
        """Returns the response payload's ``trials`` list (each entry
        carries ``degraded``/``algo`` flags when the ladder served it).

        Every logical ask carries a fresh idempotency token (``req``):
        if the response is lost (server crash after the ask became
        durable, dropped connection, a 307 mid-migration) the retry
        answers the ORIGINAL trials instead of burning a new seed draw
        — without it, a retried ask would silently fork the study's
        proposal stream from its deterministic reference."""
        import os as _os

        status, payload = self.request(
            "POST", "/ask", {"study_id": study_id, "n": n,
                             "req": _os.urandom(8).hex()})
        if status != 200:
            raise ServiceUnavailable(
                f"/ask failed: {payload.get('error')}", status=status)
        return payload["trials"]

    def tell(self, study_id, tid, loss=None, status=None):
        """Returns ``{"duplicate": bool}`` — a 409 from a RETRIED tell
        means the first attempt landed and its response was lost, which
        is success, not an error."""
        code, payload = self.request(
            "POST", "/tell",
            {"study_id": study_id, "tid": tid, "loss": loss,
             "status": status})
        if code == 409:
            return {"duplicate": True}
        if code != 200:
            raise ServiceUnavailable(
                f"/tell failed: {payload.get('error')}", status=code)
        return {"duplicate": False}

    def close_study(self, study_id):
        status, payload = self.request("POST", "/close",
                                       {"study_id": study_id})
        return status == 200

    def studies(self):
        status, payload = self.request("GET", "/studies")
        if status != 200:
            raise ServiceUnavailable("/studies failed", status=status)
        return payload
