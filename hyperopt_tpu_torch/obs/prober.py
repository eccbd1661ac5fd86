"""Blackbox prober and continuous correctness audit (counterpart of
``hyperopt_tpu/obs/prober.py``).

Everything else in the observability plane is the server reporting on
itself.  The prober checks from the client's side of the socket that the
service proposes what it must: the determinism contract (same seed, same
proposal stream) gives a pinned-seed canary study exactly one right
stream, so one small synthetic study per cycle catches a silent wrong
answer (a mislabeled degrade floor, replica divergence, corruption past
the checksums) within a bounded number of cycles.

One :class:`Prober` is one rate-limited, deadline-bounded, fail-open
daemon thread.  Each cycle drives the canary (``zoo["quadratic1"]``,
pinned seed, random startup then TPE asks, ``n_EI_candidates=31`` so it
never shares a cohort slot with a tenant study) through the real
``ServiceClient``/HTTP path (admit, ask, tell, close) and seals one
verdict on three axes:

* **the golden stream**: the canary's digest (sha256 over the canonical
  JSON of ``[{tid, params}, ...]``) must equal the golden of its backend
  bit for bit.  The port keys the golden by the device of the scheduler
  that served the canary (``"cuda"`` or ``"cpu"``), not by jax's backend.
  ``probe_golden.json`` beside this module holds only the port's ``cpu``
  digest; the card has no committed entry and trusts its first clean
  stream (TOFU, ``golden_source: "tofu"``).  With several targets the
  digests cross-check (replica divergence);
* **client-view golden signals**: availability and ask latency as a user
  sees them, fed to the blackbox SLO objectives (``probe_avail``,
  ``probe_golden_match``, ``probe_ask_p99_ms``);
* **the response contract**: trace echo and the degraded flags against
  the study timeline (an honest flag demotes the verdict to ``degraded``,
  never ``mismatch``).

Verdicts append to a CRC32C-sealed, torn-line-tolerant
``fleet/probes/<replica>.jsonl`` ledger.  A mismatch writes a flight-ring
record and an evidence bundle, and escalates once per episode: with the
server's capture plane armed (``HYPEROPT_TPU_PROFILE``) it asks that
plane for one capture, which the leader of the next wave records on its
own thread (``obs/profiler.py``), so the trace holds the waves' kernels.
The prober never starts a session itself: its own thread runs no kernel.

Canary traffic is free: canary studies carry ``canary=True`` through
admission (kept out of the quality, load and tenant planes and the census
bank, ``service/scheduler.py``), and the disarmed prober is absent (the
server holds ``prober = None``: no thread, no objective).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from collections import deque

from .._env import DEFAULT_PROBE_PERIOD_SEC
from ..service import integrity
from .trace import Tracer

__all__ = ["Prober", "ProbeLedger", "CANARY", "DEFAULT_PROBE_PERIOD_SEC",
           "canary_key", "stream_digest", "load_golden", "local_digest",
           "regen_golden", "probes_path_for", "read_probes",
           "detection_stats", "main"]

logger = logging.getLogger(__name__)

#: the pinned canary study.  ``n_ei`` is deliberately not the default, so
#: the canary keeps a cohort of its own and never shares a cohort slot (or
#: a census row) with tenant studies of the same space.  Changing
#: ANY field invalidates the committed golden fixture — regen it
#: (``python -m hyperopt_tpu_torch.obs.prober --regen-golden``).
CANARY = {
    "zoo": "quadratic1",
    "seed": 20180621,
    "n_startup": 3,
    "asks": 6,
    "n_ei": 31,
}

#: verdict severity order (worst wins when axes disagree)
_VERDICTS = ("ok", "degraded", "contract", "mismatch", "error")

#: probe spans feed the process flight ring (sink-less tracer), so they
#: ride into postmortem dumps and the Perfetto export next to the waves
#: they probed
_tracer = Tracer()

#: subdirectory of a store root holding the per-replica probe ledgers
PROBES_DIR = os.path.join("fleet", "probes")


def probes_path_for(store_root, replica_id):
    """One append-only verdict ledger per replica (the heat-ledger
    layout): replicas never share a file, readers merge the dir."""
    return os.path.join(str(store_root), PROBES_DIR,
                        f"{replica_id}.jsonl")


def canary_key(canary=None):
    """The fixture key for a canary config — any drift in the pinned
    study invalidates the committed digest."""
    c = dict(CANARY, **(canary or {}))
    return (f"{c['zoo']}:s{c['seed']}:n{c['n_startup']}"
            f":a{c['asks']}:e{c['n_ei']}:v1")


def stream_digest(stream):
    """Bitwise digest of one canary proposal stream: sha256 (16 hex) of
    the canonical JSON of ``[{"tid": .., "params": {..}}, ...]``.
    Floats survive the HTTP JSON round trip exactly (shortest-repr), so
    the digest a blackbox probe computes equals the digest the same
    stream yields in-process."""
    body = json.dumps(
        [{"tid": int(e["tid"]), "params": e["params"]} for e in stream],
        sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(body.encode("utf-8")).hexdigest()[:16]


def _golden_path():
    return os.path.join(os.path.dirname(__file__), "probe_golden.json")


def _backend_key(device=None):
    """The golden is keyed by the device the canary was served on
    (``"cuda"`` or ``"cpu"``): the determinism contract pins streams per
    device, not across devices.  ``device=None`` (the standalone CLI,
    which serves nothing itself) keys ``"cuda"`` when a card is present."""
    import torch

    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device).type


def load_golden(canary=None, backend=None, path=None):
    """The committed golden digest for this canary and backend, or None
    (no entry: the prober pins its first clean stream, TOFU, flagged
    ``golden_source: "tofu"`` in every verdict)."""
    path = path or _golden_path()
    try:
        with open(path, encoding="utf-8") as f:
            fx = json.load(f)
        return fx["digests"][canary_key(canary)][backend or _backend_key()]
    except (OSError, ValueError, KeyError, TypeError):
        return None


# ---------------------------------------------------------------------------
# transports: how a probe cycle talks to a server
# ---------------------------------------------------------------------------


class _HTTPTransport:
    """The production transport: one :class:`ServiceClient` pinned to a
    SINGLE replica URL (fleet divergence checks need direct addressing,
    not seed failover), ``x-probe: 1`` on every request so the server
    keeps canary traffic out of the tenant SLO objectives."""

    def __init__(self, url, timeout=10.0):
        from ..retry import RetryPolicy
        from ..service.client import ServiceClient

        self.client = ServiceClient(
            url, timeout=timeout,
            retry=RetryPolicy(max_retries=2, base_delay=0.05,
                              max_delay=0.5),
            headers={"x-probe": "1"})

    def request(self, method, path, body=None):
        return self.client.request(method, path, body,
                                   retryable=(429, 503, 507))


class _LocalTransport:
    """In-process transport over ``ServiceHTTPServer.handle`` — the
    golden-fixture regen path and the tier-1 tests (no sockets).  The
    digest is transport-invariant: params round-trip through JSON here
    too, exactly like the wire."""

    def __init__(self, server):
        self.server = server

    def request(self, method, path, body=None):
        status, payload = self.server.handle(
            method, path, body or {}, headers={"x-probe": "1"})
        # the wire round trip: floats in params become JSON text and
        # back, so local and HTTP digests agree byte-for-byte
        return status, json.loads(json.dumps(payload, default=str))


# ---------------------------------------------------------------------------
# the sealed verdict ledger
# ---------------------------------------------------------------------------


class ProbeLedger:
    """Append-only sealed verdict lines for one replica (the
    ``HeatLedger`` idiom): O_APPEND single-line writes, CRC32C sealed,
    best-effort on ANY OSError with a warn-once latch — a full disk
    must cost verdict durability, never a probe cycle."""

    def __init__(self, path):
        self.path = str(path)
        self._warned = False

    def append(self, rec):
        line = (integrity.seal(rec) + "\n").encode()
        try:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            fd = os.open(self.path,
                         os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
            try:
                os.write(fd, line)
            finally:
                os.close(fd)
        except OSError as e:
            if not self._warned:
                self._warned = True
                logger.warning("probe ledger: cannot append to %s (%s); "
                               "verdicts will not survive a restart",
                               self.path, e)


def read_probes(path):
    """Classified read of one verdict ledger: returns ``(records,
    n_corrupt, n_torn)`` — CORRUPT lines are counted and skipped (a
    bit-flip costs one verdict, never the view), the TORN final line
    silently (the normal crash artifact)."""
    recs, corrupt, torn = [], 0, 0
    try:
        for c in integrity.iter_checked_jsonl(path):
            if c.rec is None:
                if c.status == integrity.CORRUPT:
                    corrupt += 1
                else:
                    torn += 1
                continue
            if c.status == integrity.CORRUPT:
                corrupt += 1
                continue
            if c.rec.get("kind") == "probe":
                recs.append(c.rec)
    except OSError:
        pass
    return recs, corrupt, torn


def detection_stats(recs):
    """Detection-latency statistics over a verdict sequence: for every
    green→red edge, the gap between the last green verdict and the
    first non-green one — the blackbox time-to-detect the obs.report
    section and the bench stage publish."""
    lats = []
    last_ok_ts = None
    was_ok = None
    for r in sorted(recs, key=lambda r: r.get("ts") or 0.0):
        ok = r.get("verdict") == "ok"
        ts = r.get("ts")
        if ts is None:
            continue
        if not ok and was_ok and last_ok_ts is not None:
            lats.append(ts - last_ok_ts)
        if ok:
            last_ok_ts = ts
        was_ok = ok
    if not lats:
        return {"episodes": 0}
    lats.sort()
    return {"episodes": len(lats),
            "min_sec": lats[0], "max_sec": lats[-1],
            "mean_sec": sum(lats) / len(lats)}


# ---------------------------------------------------------------------------
# the prober
# ---------------------------------------------------------------------------


class Prober:
    """One blackbox prober: N target replicas, one canary per target
    per cycle, one sealed verdict per target.  ``start()`` runs the
    daemon thread; tests call :meth:`run_cycle` directly (clock
    injectable, no sleeping).  Fail-open everywhere: a probe cycle can
    render an ``error`` verdict but never raise out of the thread."""

    def __init__(self, targets, period=None, slo=None, metrics=None,
                 ledger_path=None, replica="single", wal_path=None,
                 canary=None, golden=None, clock=time.time,
                 transport_factory=None, request_timeout=None,
                 escalation_cooldown=600.0, evidence_dir=None,
                 profile_capture=True, keep=64, backend=None, profiler=None):
        self.targets = [str(t).rstrip("/") for t in
                        ([targets] if isinstance(targets, str)
                         else list(targets))]
        if not self.targets:
            raise ValueError("prober needs at least one target")
        self.period = float(period if period is not None
                            else DEFAULT_PROBE_PERIOD_SEC)
        self.slo = slo
        self.metrics = metrics
        self.replica = str(replica)
        self.wal_path = wal_path
        self.canary = dict(CANARY, **(canary or {}))
        self.backend = str(backend) if backend is not None else _backend_key()
        # the server's capture plane (None: a mismatch only logs)
        self.profiler = profiler
        self.last_capture = None  # the newest escalation's capture record
        if golden is not None:
            self.golden, self.golden_source = str(golden), "pinned"
        else:
            g = load_golden(self.canary, backend=self.backend)
            # TOFU fallback for backends without a committed fixture:
            # the first clean un-flagged stream self-pins, later cycles
            # (and every cross-replica check) still compare bitwise
            self.golden = g
            self.golden_source = "fixture" if g is not None else "tofu"
        self._clock = clock
        self.ledger = (ProbeLedger(ledger_path) if ledger_path else None)
        self.evidence_dir = evidence_dir or (
            os.path.join(os.path.dirname(str(ledger_path)), "evidence")
            if ledger_path else None)
        # each cycle must finish well inside its period (rate-limited
        # AND deadline-bounded); per-request budget derives from it
        self.cycle_deadline = max(1.0, 0.8 * self.period)
        self._timeout = (request_timeout if request_timeout is not None
                         else max(0.5, self.cycle_deadline
                                  / max(1, self.canary["asks"] + 3)))
        self._transport_factory = (transport_factory
                                   or (lambda url: _HTTPTransport(
                                       url, timeout=self._timeout)))
        self.escalation_cooldown = float(escalation_cooldown)
        self.profile_capture = bool(profile_capture)
        self._lock = threading.Lock()
        self._thread = None
        self._stop = threading.Event()
        self.cycles = 0
        self.verdicts = {v: 0 for v in _VERDICTS}
        self.recent = deque(maxlen=int(keep))
        self.streak = 0          # consecutive golden-matching cycles
        self.last = None         # newest per-cycle summary record
        self._last_ok_ts = None
        self._was_ok = None
        self.detection_latencies = deque(maxlen=int(keep))
        # client-view ask latencies (retries and redirects included), ms
        self.ask_ms = deque(maxlen=1024)
        self._in_episode = False  # edge trigger for escalation
        self._last_escalation = None
        self.escalations = 0
        self.evidence_bundles = deque(maxlen=8)  # paths, for /probes

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        """Spawn the probe loop (daemon, one thread).  Idempotent."""
        with self._lock:
            if self._thread is not None:
                return self._thread
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="hyperopt-prober", daemon=True)
            self._thread.start()
            return self._thread

    def stop(self, timeout=5.0):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
        self._thread = None

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.run_cycle()
            except Exception:  # noqa: BLE001 - the fail-open contract
                logger.warning("probe cycle failed (continuing)",
                               exc_info=True)
            self._stop.wait(self.period)

    # -- one probe cycle ---------------------------------------------------

    def run_cycle(self, now=None):
        """Drive the canary against every target, cross-check digests,
        render + seal one verdict per target and roll the summary.
        Returns the cycle record (the last entry of ``recent``)."""
        now = self._clock() if now is None else now
        self.cycles += 1
        cycle = self.cycles
        deadline = time.monotonic() + self.cycle_deadline
        results = []
        with _tracer.span("probe.cycle", cycle=cycle,
                          targets=len(self.targets)):
            for url in self.targets:
                results.append(self._probe_target(url, cycle, deadline))
        # fleet divergence: every clean un-flagged stream must agree
        # bitwise across replicas — a diverging replica is corrupt even
        # when no golden fixture exists for this backend (TOFU mode)
        digests = {r["target"]: r.get("digest") for r in results
                   if r.get("digest") and not r.get("flagged")}
        diverged = len(set(digests.values())) > 1
        # each target's stream judged against the golden, before the
        # cross-replica check below can turn its verdict
        golden_ok = [r["verdict"] != "mismatch" for r in results]
        if self.golden is None and self.golden_source == "tofu":
            clean = [r for r in results
                     if r["verdict"] == "ok" and r.get("digest")]
            if clean and not diverged:
                self.golden = clean[0]["digest"]
                logger.warning(
                    "prober: no committed golden for backend %r — "
                    "self-pinned digest %s (TOFU); commit it via "
                    "--regen-golden to detect cross-restart drift",
                    self.backend, self.golden)
        worst = "ok"
        for r in results:
            if diverged and r.get("digest") and not r.get("flagged"):
                r["diverged"] = True
                if _VERDICTS.index(r["verdict"]) \
                        < _VERDICTS.index("mismatch"):
                    r["verdict"] = "mismatch"
                    r["why"] = "replica stream divergence"
            if _VERDICTS.index(r["verdict"]) > _VERDICTS.index(worst):
                worst = r["verdict"]
        # a target is judged against the golden; with no golden (TOFU, no
        # clean agreement yet) the replicas' divergence is the only judge.
        # An evidence bundle, and the SLO feed below, follow that judge: a
        # replica whose stream equals the golden writes none (ROADMAP queue
        # 3, item 14)
        for r, ok in zip(results, golden_ok):
            ev = r.pop("_evidence", None)
            if r["verdict"] == "mismatch" and ev is not None and (
                    self.golden is None or not ok):
                r["evidence"] = self._evidence_bundle(r, *ev) or None
        # SLO feed: golden_match burns on mismatch only (an honest degrade
        # is the ladder doing its job; availability burned already if
        # requests failed)
        if self.slo is not None:
            for r, ok in zip(results, golden_ok):
                try:
                    self.slo.record_probe(
                        "probe_golden_match",
                        ok if self.golden is not None else r["verdict"] != "mismatch",
                        now=self._clock())
                except Exception:  # noqa: BLE001
                    pass
        for r in results:
            r["ts"] = now
            r["verdict_cycle"] = worst
            self._seal_and_count(r)
        summary = {"cycle": cycle, "ts": now, "verdict": worst,
                   "diverged": diverged,
                   "targets": {r["target"]: r["verdict"]
                               for r in results}}
        self._roll(summary, results, now)
        return summary

    def _probe_target(self, url, cycle, deadline):
        """One canary study against one replica → one verdict record."""
        c = self.canary
        rec = {"kind": "probe", "cycle": cycle, "replica": self.replica,
               "target": url, "backend": self.backend,
               "golden": self.golden, "golden_source": self.golden_source,
               "canary": canary_key(c)}
        stream, flags, lat_ms, traces, err = [], [], [], [], None
        responses = []
        timeline = None
        sid = None
        t = self._transport_factory(url)
        try:
            status, payload = self._probe_req(
                t, "POST", "/study",
                {"zoo": c["zoo"], "seed": c["seed"],
                 "n_startup_jobs": c["n_startup"],
                 "n_EI_candidates": c["n_ei"], "canary": True},
                responses, lat_ms, deadline)
            if status != 200:
                raise RuntimeError(f"canary admit failed: HTTP {status} "
                                   f"{payload.get('error')}")
            sid = payload["study_id"]
            from ..zoo import ZOO

            objective = ZOO[c["zoo"]].objective
            for i in range(c["asks"]):
                status, payload = self._probe_req(
                    t, "POST", "/ask",
                    {"study_id": sid, "n": 1,
                     "req": f"probe-{self.replica}-{cycle}-{i}"},
                    responses, lat_ms, deadline, is_ask=True)
                if status != 200:
                    raise RuntimeError(
                        f"canary ask failed: HTTP {status} "
                        f"{payload.get('error')}")
                for tr in payload["trials"]:
                    stream.append({"tid": tr["tid"],
                                   "params": tr["params"]})
                    flags.append({
                        "algo": tr.get("algo"),
                        "degraded": bool(tr.get("degraded")
                                         or payload.get("degraded")),
                        "warming": bool(tr.get("warming")
                                        or payload.get("warming"))})
                if payload.get("trace"):
                    traces.append(payload["trace"])
                loss = float(objective(dict(
                    payload["trials"][0]["params"])))
                status, _ = self._probe_req(
                    t, "POST", "/tell",
                    {"study_id": sid,
                     "tid": payload["trials"][0]["tid"], "loss": loss},
                    responses, lat_ms, deadline)
                if status not in (200, 409):
                    raise RuntimeError(f"canary tell failed: "
                                       f"HTTP {status}")
            status, timeline = self._probe_req(
                t, "GET", f"/study/{sid}/timeline", None,
                responses, lat_ms, deadline)
            if status != 200:
                timeline = None
        except Exception as e:  # noqa: BLE001 - becomes the verdict
            err = f"{type(e).__name__}: {e}"
        finally:
            if sid is not None:
                try:
                    self._probe_req(t, "POST", "/close",
                                    {"study_id": sid},
                                    responses, lat_ms, deadline)
                except Exception:  # noqa: BLE001 - best-effort close
                    pass
        rec["study_id"] = sid
        rec["trace_ids"] = traces
        rec["asks"] = len(stream)
        if lat_ms:
            s = sorted(lat_ms)
            rec["latency_ms"] = {
                "p50": s[len(s) // 2], "max": s[-1],
                "mean": sum(s) / len(s)}
        flagged = any(f["degraded"] or f["warming"] for f in flags)
        rec["flagged"] = flagged
        violations = self._lint_contract(responses, flags, timeline,
                                         traces)
        if err is not None:
            rec["verdict"], rec["why"] = "error", err
        else:
            rec["digest"] = stream_digest(stream)
            if flagged:
                # honest degrade/warming: detected and reported, but a
                # flagged floor is NOT silent corruption — the stream
                # legitimately differs from golden
                rec["verdict"] = "degraded"
                rec["why"] = "degraded/warming-flagged proposals"
            elif self.golden is not None \
                    and rec["digest"] != self.golden:
                rec["verdict"] = "mismatch"
                rec["why"] = (f"stream digest {rec['digest']} != "
                              f"golden {self.golden}")
            elif violations:
                rec["verdict"] = "contract"
                rec["why"] = "; ".join(violations[:3])
            else:
                rec["verdict"] = "ok"
        if violations:
            rec["violations"] = violations
        if rec["verdict"] == "mismatch":
            rec["evidence"] = self._evidence_bundle(
                rec, responses, timeline) or None
        else:  # the cross-replica check may still turn it (run_cycle)
            rec["_evidence"] = (responses, timeline)
        return rec

    def _probe_req(self, transport, method, path, body, responses,
                   lat_ms, deadline, is_ask=False):
        """One client-view exchange: measured wall latency (retries and
        hops included), availability + ask-latency SLO feed, bounded by
        the cycle deadline."""
        if time.monotonic() > deadline:
            raise TimeoutError("probe cycle deadline exceeded")
        t0 = time.perf_counter()
        ok = False
        try:
            status, payload = transport.request(method, path, body)
            ok = status < 500
            return status, payload
        finally:
            dt_ms = (time.perf_counter() - t0) * 1e3
            lat_ms.append(dt_ms)
            if is_ask and ok:
                self.ask_ms.append(dt_ms)
            if len(responses) < 64:
                responses.append({"method": method, "path": path,
                                  "latency_ms": round(dt_ms, 3),
                                  "ok": ok})
            if self.slo is not None:
                try:
                    now = self._clock()
                    self.slo.record_probe("probe_avail", ok, now=now)
                    if is_ask and ok:
                        obj = self.slo.objectives.get("probe_ask_p99_ms")
                        thr = (obj.threshold_ms if obj is not None
                               else None)
                        self.slo.record_probe(
                            "probe_ask_p99_ms",
                            thr is None or dt_ms <= thr, now=now)
                except Exception:  # noqa: BLE001
                    pass

    @staticmethod
    def _lint_contract(responses, flags, timeline, traces):
        """Response-contract lint: schema fields already enforced by
        the drive (KeyError → error verdict); here the cross-checks —
        trace echo, and flags consistent with the timeline record each
        probe trace id landed in."""
        violations = []
        if timeline is None or not isinstance(timeline, dict):
            return violations  # timeline fetch failed: availability's job
        events = timeline.get("events")
        if not isinstance(events, list):
            violations.append("timeline carries no events list")
            return violations
        asks = {e.get("trace"): e for e in events
                if e.get("event") == "ask" and e.get("trace")}
        for i, (trace, f) in enumerate(zip(traces, flags)):
            ev = asks.get(trace)
            if ev is None:
                violations.append(
                    f"ask #{i}: trace {trace} not on the study timeline")
                continue
            if ev.get("algo") == "rand" and f["algo"] == "tpe":
                violations.append(
                    f"ask #{i}: response says tpe, WAL says rand "
                    "(mislabeled floor)")
            if bool(ev.get("degraded")) != bool(f["degraded"]):
                violations.append(
                    f"ask #{i}: degraded flag disagrees with the "
                    f"timeline record (resp={f['degraded']})")
        return violations

    # -- verdict plumbing --------------------------------------------------

    def _seal_and_count(self, rec):
        self.verdicts[rec["verdict"]] = (
            self.verdicts.get(rec["verdict"], 0) + 1)
        if self.ledger is not None:
            self.ledger.append(dict(rec))
        if self.metrics is not None:
            try:
                self.metrics.counter(
                    f"probe.verdict.{rec['verdict']}").inc()
            except Exception:  # noqa: BLE001
                pass

    def _roll(self, summary, results, now):
        """Fold one cycle into the rolling state: streak, detection
        latency, gauges, escalation edge."""
        ok = summary["verdict"] == "ok"
        with self._lock:
            self.streak = self.streak + 1 if ok else 0
            if not ok and self._was_ok and self._last_ok_ts is not None:
                lat = now - self._last_ok_ts
                summary["detection_latency_sec"] = lat
                self.detection_latencies.append(lat)
            if ok:
                self._last_ok_ts = now
                self._in_episode = False
            self._was_ok = ok
            self.last = summary
            self.recent.append(summary)
        if self.metrics is not None:
            try:
                g = self.metrics.gauge
                g("probe.cycles").set(float(self.cycles))
                g("probe.last_verdict_code").set(
                    float(_VERDICTS.index(summary["verdict"])))
                g("probe.golden_match_streak").set(float(self.streak))
                g("probe.last_cycle_ts").set(float(now))
                g("probe.targets").set(float(len(self.targets)))
                if summary.get("detection_latency_sec") is not None:
                    g("probe.detection_latency_sec").set(
                        summary["detection_latency_sec"])
            except Exception:  # noqa: BLE001
                pass
        if summary["verdict"] == "mismatch":
            self._escalate(summary, now)

    def _escalate(self, summary, now):
        """Once-per-episode escalation on a golden mismatch: a flight
        ring record always; one bounded capture when the server's capture
        plane is armed, edge-triggered with a cooldown, so a red streak
        produces one capture, not one per cycle.  The capture is asked for
        on a short-lived thread and recorded by the next wave's leader: the
        prober's thread must keep probing, and its canary's waves are what
        the capture records."""
        try:
            from .flight import get_flight

            get_flight().record({"kind": "probe_mismatch",
                                 "ts": now, "cycle": summary["cycle"],
                                 "targets": summary["targets"]})
        except Exception:  # noqa: BLE001
            pass
        fire = False
        with self._lock:
            if not self._in_episode:
                self._in_episode = True
                if (self._last_escalation is None
                        or now - self._last_escalation
                        >= self.escalation_cooldown):
                    self._last_escalation = now
                    self.escalations += 1
                    fire = True
        if not fire:
            return
        if self.metrics is not None:
            try:
                self.metrics.counter("probe.escalations").inc()
            except Exception:  # noqa: BLE001
                pass
        logger.warning("prober: GOLDEN MISMATCH on cycle %d (%s) — "
                       "the fleet is serving wrong proposals",
                       summary["cycle"], summary["targets"])
        if self.profile_capture and self.profiler is not None:
            from .profiler import ESCALATION_CAPTURE_SEC

            self.profiler.capture_async(ESCALATION_CAPTURE_SEC, "probe_mismatch",
                                        on_record=lambda rec: setattr(self, "last_capture", rec))

    def _evidence_bundle(self, rec, responses, timeline):
        """Write the mismatch evidence bundle: the raw responses, the
        canary's timeline, the trace ids, and the WAL segment the
        canary landed in (when a WAL path is known).  Best-effort —
        evidence must never fail the verdict."""
        if self.evidence_dir is None:
            return None
        try:
            d = os.path.join(
                self.evidence_dir,
                f"c{rec['cycle']}-{rec['replica']}-"
                f"{int(self._clock())}")
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "bundle.json"), "w",
                      encoding="utf-8") as f:
                json.dump({"verdict": rec.get("verdict"),
                           "why": rec.get("why"),
                           "digest": rec.get("digest"),
                           "golden": rec.get("golden"),
                           "golden_source": rec.get("golden_source"),
                           "target": rec.get("target"),
                           "study_id": rec.get("study_id"),
                           "trace_ids": rec.get("trace_ids"),
                           "responses": responses,
                           "timeline": timeline}, f, indent=1,
                          default=str)
            sid = rec.get("study_id")
            if self.wal_path and sid:
                try:
                    with open(self.wal_path, encoding="utf-8",
                              errors="replace") as src, \
                            open(os.path.join(d, "wal_segment.jsonl"),
                                 "w", encoding="utf-8") as dst:
                        for line in src:
                            if sid in line:
                                dst.write(line)
                except OSError:
                    pass
            self.evidence_bundles.append(d)
            return d
        except Exception:  # noqa: BLE001
            return None

    # -- surfaces ----------------------------------------------------------

    def green(self, now=None, max_age=None):
        """Blackbox-green: the newest cycle verdict is ``ok`` AND fresh
        (within ``max_age``, default 3 periods).  The rolling-restart
        gate and /healthz consume this."""
        now = self._clock() if now is None else now
        max_age = (3.0 * self.period) if max_age is None else max_age
        last = self.last
        return (last is not None and last["verdict"] == "ok"
                and now - last["ts"] <= max_age)

    def healthz_fields(self, now=None):
        now = self._clock() if now is None else now
        last = self.last
        return {
            "last_verdict": last["verdict"] if last else None,
            "age_sec": (now - last["ts"]) if last else None,
            "golden_match_streak": self.streak,
            "cycles": self.cycles,
            "green": self.green(now=now),
        }

    def status_dict(self, now=None):
        """The ``GET /probes`` payload (also the /snapshot section)."""
        now = self._clock() if now is None else now
        with self._lock:
            recent = list(self.recent)
            det = list(self.detection_latencies)
        out = {"armed": True, "replica": self.replica,
               "targets": list(self.targets), "period_sec": self.period,
               "canary": canary_key(self.canary),
               "backend": self.backend, "golden": self.golden,
               "golden_source": self.golden_source,
               "cycles": self.cycles, "verdicts": dict(self.verdicts),
               "golden_match_streak": self.streak,
               "green": self.green(now=now),
               "escalations": self.escalations,
               "capture": self.last_capture,
               "evidence_bundles": list(self.evidence_bundles),
               "last": self.last, "recent": recent[-20:]}
        if det:
            s = sorted(det)
            out["detection"] = {"episodes": len(s), "min_sec": s[0],
                                "max_sec": s[-1],
                                "mean_sec": sum(s) / len(s)}
        asks = sorted(self.ask_ms)
        if asks:
            out["ask_latency_ms"] = {
                "n": len(asks), "p50": asks[len(asks) // 2],
                "p99": asks[min(len(asks) - 1, int(0.99 * len(asks)))],
                "max": asks[-1]}
        return out


# ---------------------------------------------------------------------------
# golden fixture: local drive + regen
# ---------------------------------------------------------------------------


def local_digest(canary=None, compile_plane=False, device=None):
    """Drive the canary against a fresh in-process server on ``device``
    (the card unless ``device="cpu"``; the real handler path, JSON
    round-tripped as on the wire) and return ``(digest, flagged)``.  The
    golden tests and the regen CLI share this drive."""
    from ..service.scheduler import StudyScheduler
    from ..service.server import ServiceHTTPServer

    c = dict(CANARY, **(canary or {}))
    sched = StudyScheduler(wal=False, quality=False, load=False, device=device,
                           compile_plane=False if not compile_plane else None)
    srv = ServiceHTTPServer(0, scheduler=sched, trace=False, slo=False)
    p = Prober(["local"], period=3600.0, canary=c, golden="_",
               backend=_backend_key(sched.device),
               transport_factory=lambda url: _LocalTransport(srv))
    rec = p._probe_target("local", 1, time.monotonic() + 600.0)
    if rec["verdict"] == "error":
        raise RuntimeError(f"canary drive failed: {rec.get('why')}")
    return rec["digest"], rec["flagged"]


def regen_golden(path=None, canary=None, device=None):
    """Recompute the canary digest on ``device`` (the card unless
    ``device="cpu"``) and rewrite its fixture entry (``--regen-golden``).
    Refuses a flagged stream: a golden pins a clean full-quality stream."""
    from .._env import resolve_device

    path = path or _golden_path()
    device = resolve_device(device)
    digest, flagged = local_digest(canary, device=device)
    if flagged:
        raise RuntimeError(
            "canary stream was degraded/warming-flagged; a golden "
            "fixture must pin a clean full-quality stream (disarm the "
            "degrade ladder / compile plane and retry)")
    try:
        with open(path, encoding="utf-8") as f:
            fx = json.load(f)
    except (OSError, ValueError):
        fx = {}
    fx.setdefault("version", 1)
    fx.setdefault("canary", dict(CANARY, **(canary or {})))
    fx.setdefault("digests", {}).setdefault(
        canary_key(canary), {})[_backend_key(device)] = digest
    with open(path, "w", encoding="utf-8") as f:
        json.dump(fx, f, indent=1, sort_keys=True)
        f.write("\n")
    return digest


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m hyperopt_tpu_torch.obs.prober",
        description="Blackbox prober: synthetic canary studies against "
                    "live ask/tell replicas, golden-stream divergence "
                    "detection, sealed verdict ledger.")
    p.add_argument("--targets", default=None,
                   help="comma-separated replica base URLs (>=2 arms "
                        "the cross-replica divergence check)")
    p.add_argument("--period", type=float, default=None,
                   help="probe cycle period in seconds (default: "
                        "$HYPEROPT_TPU_PROBE_PERIOD or 30)")
    p.add_argument("--cycles", type=int, default=0,
                   help="run N cycles then exit non-zero unless all "
                        "green (0 = run forever)")
    p.add_argument("--ledger", default=None,
                   help="verdict ledger path (sealed JSONL)")
    p.add_argument("--replica", default="standalone",
                   help="identity stamped on verdicts/ledger")
    p.add_argument("--regen-golden", action="store_true",
                   help="recompute the canary digest on --device and rewrite "
                        "hyperopt_tpu_torch/obs/probe_golden.json")
    p.add_argument("--device", default=None,
                   help="where --regen-golden serves the canary: the CUDA card "
                        "by default, 'cpu' for the CPU")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    if args.regen_golden:
        from .._env import resolve_device

        device = resolve_device(args.device)
        digest = regen_golden(device=device)
        print(f"probe_golden.json: pinned {canary_key()} "
              f"[{_backend_key(device)}] = {digest}")
        return 0
    if not args.targets:
        p.error("--targets is required (or use --regen-golden)")
    from .._env import parse_probe_period

    prober = Prober(
        [u for u in args.targets.split(",") if u.strip()],
        period=(args.period if args.period is not None
                else parse_probe_period()),
        ledger_path=args.ledger, replica=args.replica)
    if args.cycles > 0:
        bad = 0
        for _ in range(args.cycles):
            rec = prober.run_cycle()
            print(json.dumps(rec, default=str))
            if rec["verdict"] != "ok":
                bad += 1
            time.sleep(min(prober.period, 1.0))
        return 1 if bad else 0
    prober.start()
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        prober.stop()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
