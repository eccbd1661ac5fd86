"""Tenant ids and the tenant ledger (counterpart of
``hyperopt_tpu/obs/tenant.py``, copied: host-only).

**The tenant id** is opaque, bounded and sanitized
(:func:`sanitize_tenant`), default ``"anon"``; a hostile value raises
``ValueError`` (HTTP 400).  ``ServiceClient(tenant=...)`` stamps it on
every request as ``x-tenant``; a study carries it on its registry entry
and in the WAL admit record's ``kwargs`` (only when it is not ``anon``,
so tenantless journals stay byte-identical).

**The tenant ledger** (:class:`TenantLedger`, one per scheduler, the cost
ledger's sibling) is fed the wave's measured dispatch+readback share,
every settled tell and the server's finished asks.  Its rows are bounded:
at most ``top_k`` named tenants plus an ``other`` roll-up, into which the
least active row is evicted (totals conserved).  The scheduler packs a
wave's asks by deficit-round-robin over tenants
(:meth:`TenantLedger.drr_order`).  Packing order only: per-id keys derive
from the id and the study seed, never from slot position or wave
composition, so armed and disarmed schedulers propose the same streams
bit for bit.  Disarmed (``HYPEROPT_TPU_TENANT=off``) means
``scheduler.tenants is None``.  The ledger lives on the host and
allocates no device memory.

A fleet replica's heat records carry the ledger's cumulative per-tenant
table (``tenants``); :func:`read_tenant_heat` MAX-merges it per (shard,
tenant) and sums across shards.
"""

from __future__ import annotations

import logging
import threading
from collections import deque

__all__ = ["ANON", "OTHER", "MAX_TENANT_LEN", "DEFAULT_TOP_K", "sanitize_tenant", "TenantRow",
           "TenantLedger", "merge_status", "read_tenant_heat"]

logger = logging.getLogger(__name__)

#: the default principal: requests and studies that never named one
ANON = "anon"

#: the roll-up bucket evicted tenants charge into (reserved: a client
#: cannot claim it)
OTHER = "other"

#: hard length bound on a tenant id
MAX_TENANT_LEN = 128

#: default named-row bound (``HYPEROPT_TPU_TENANT_TOP_K``)
DEFAULT_TOP_K = 64

#: activity-EWMA weight, the cost ledger's
DEFAULT_ALPHA = 0.3

#: latency ring bound per tenant row (the most recent observations)
SKETCH_LEN = 256


def sanitize_tenant(value, default=ANON):
    """Validate one tenant id and return its canonical string, or raise
    ``ValueError`` (the HTTP layer answers 400).  ``None`` and ``""`` give
    ``default``; an id must be a ``str`` of at most
    :data:`MAX_TENANT_LEN` characters with no control bytes, and not the
    reserved ``other``."""
    if value is None:
        return default
    if not isinstance(value, str):
        raise ValueError(f"tenant id must be a string, got {type(value).__name__}")
    if value == "":
        return default
    if len(value) > MAX_TENANT_LEN:
        raise ValueError(f"tenant id too long ({len(value)} > {MAX_TENANT_LEN})")
    for ch in value:
        o = ord(ch)
        if o < 32 or o == 127:
            raise ValueError(f"tenant id contains control byte 0x{o:02x}")
    if value == OTHER:
        raise ValueError(f"tenant id {OTHER!r} is reserved for the roll-up bucket")
    return value


def _metric_label(tenant):
    """Metric-name-safe tenant label."""
    return "".join(c if c.isalnum() or c == "_" else "_" for c in str(tenant))


class TenantRow:
    """One tenant's accumulated attribution; every mutator is O(1)
    arithmetic on measured quantities."""

    __slots__ = ("tenant", "studies", "asks", "tells", "sheds", "device_ms", "hbm_bytes",
                 "ewma_ms", "deficit", "_lat")

    def __init__(self, tenant):
        self.tenant = tenant
        self.studies = 0
        self.asks = 0
        self.tells = 0
        self.sheds = 0
        self.device_ms = 0.0
        self.hbm_bytes = 0.0
        self.ewma_ms = 0.0   # activity EWMA of attributed ms per tick
        self.deficit = 0.0   # deficit-round-robin credit (the packer)
        self._lat = deque(maxlen=SKETCH_LEN)  # ask latencies (ms)

    def charge(self, share_ms, k, hbm_bytes, alpha):
        """Fold this tenant's row share of one cohort tick."""
        self.device_ms += share_ms
        self.asks += k
        self.hbm_bytes += hbm_bytes
        self.ewma_ms = alpha * share_ms + (1.0 - alpha) * self.ewma_ms

    def observe_latency(self, latency_ms):
        self._lat.append(float(latency_ms))

    def absorb(self, other):
        """Fold an evicted row's totals into this one (the latency ring is
        not merged: a percentile over mixed tenants means nothing)."""
        self.studies += other.studies
        self.asks += other.asks
        self.tells += other.tells
        self.sheds += other.sheds
        self.device_ms += other.device_ms
        self.hbm_bytes += other.hbm_bytes
        self.ewma_ms = max(self.ewma_ms, other.ewma_ms)

    def _lat_pct(self, p):
        ring = sorted(self._lat)
        if not ring:
            return None
        return ring[min(len(ring) - 1, int(p * (len(ring) - 1) + 0.5))]

    def status_dict(self):
        out = {
            "studies": self.studies,
            "asks": self.asks,
            "tells": self.tells,
            "sheds": self.sheds,
            "device_ms": round(self.device_ms, 3),
            "hbm_bytes": round(self.hbm_bytes, 1),
            "ewma_ms": round(self.ewma_ms, 3),
        }
        p50, p99 = self._lat_pct(0.5), self._lat_pct(0.99)
        if p50 is not None:
            out["ask_p50_ms"] = round(p50, 3)
            out["ask_p99_ms"] = round(p99, 3)
        return out


class TenantLedger:
    """Per-scheduler tenant attribution (no threads).  Wave and tell
    mutations arrive under the scheduler's lock; the ledger's lock guards
    only row admission and eviction; scrape-side reads take no lock.

    At most ``top_k`` named rows plus ``other``: a charge for a new tenant
    past the bound evicts the least active named row (minimum activity
    EWMA, ties by name) into ``other``."""

    def __init__(self, metrics=None, top_k=None, alpha=DEFAULT_ALPHA):
        self.metrics = metrics
        self.top_k = DEFAULT_TOP_K if top_k is None else max(1, int(top_k))
        self.alpha = float(alpha)
        self._rows = {}
        self._lock = threading.Lock()
        self.evictions = 0
        self.device_ms = 0.0
        self.asks = 0
        self.tells = 0
        self.sheds = 0

    def _row(self, tenant):
        row = self._rows.get(tenant)
        if row is not None:
            return row
        with self._lock:
            row = self._rows.get(tenant)
            if row is not None:
                return row
            named = [t for t in self._rows if t != OTHER]
            if len(named) >= self.top_k and tenant != OTHER:
                victim = min(named, key=lambda t: (self._rows[t].ewma_ms, t))
                other = self._rows.get(OTHER)
                if other is None:
                    other = self._rows[OTHER] = TenantRow(OTHER)
                other.absorb(self._rows.pop(victim))
                self.evictions += 1
            row = self._rows[tenant] = TenantRow(tenant)
            return row

    def note_study(self, tenant):
        """One study admitted (created, or replayed from the WAL: the
        tables rebuild from the admit records on resume)."""
        self._row(tenant).studies += 1

    def observe_tick(self, entries, device_sec, hbm_bytes=0.0):
        """Attribute one measured cohort tick: ``entries`` is
        ``[(tenant, k_rows), ...]``, each charged ``k_i / sum(k)``."""
        total_k = 0
        for _, k in entries:
            total_k += k
        if total_k <= 0:
            return
        ms = float(device_sec) * 1e3
        inv = 1.0 / total_k
        for tenant, k in entries:
            share = k * inv
            self._row(tenant).charge(ms * share, k, hbm_bytes * share, self.alpha)
        self.device_ms += ms
        self.asks += total_k

    def observe_tell(self, tenant):
        """One settled tell (replayed tells count: replay is the rebuild)."""
        self.tells += 1
        self._row(tenant).tells += 1

    def observe_request(self, tenant, latency_sec=None, shed=False):
        """One finished HTTP ask, from the server's response path."""
        row = self._row(tenant)
        if shed:
            self.sheds += 1
            row.sheds += 1
        elif latency_sec is not None:
            row.observe_latency(float(latency_sec) * 1e3)

    def forget_study(self, tenant):
        """One study closed: the studies count tracks live studies; the
        accumulated cost stays."""
        row = self._rows.get(tenant)
        if row is not None and row.studies > 0:
            row.studies -= 1

    def drr_order(self, tenants):
        """Deficit-round-robin serving order over ``tenants`` (duplicates
        ignored): each earns credit inversely proportional to its EWMA'd
        device time, so a light tenant outranks a noisy one until the
        noisy one's history decays.  Returns the tenants most deserving
        first and moves the rows' bounded deficit counters; never reads
        the RNG or a proposal."""
        uniq, seen = [], set()
        for t in tenants:
            if t not in seen:
                seen.add(t)
                uniq.append(t)
        if len(uniq) <= 1:
            return uniq
        rows = {t: self._row(t) for t in uniq}
        mean_ms = sum(r.ewma_ms for r in rows.values()) / len(rows)
        for t in uniq:
            # an evenly loaded set earns 1.0 each (plain round-robin)
            r = rows[t]
            r.deficit += (mean_ms + 1e-6) / (r.ewma_ms + 1e-6)
        order = sorted(uniq, key=lambda t: (-rows[t].deficit, t))
        # the served tenant spends one unit; deficits are clamped so an
        # idle tenant cannot bank unbounded priority
        rows[order[0]].deficit -= 1.0
        for t in uniq:
            r = rows[t]
            r.deficit = min(64.0, max(-64.0, r.deficit))
        return order

    def status(self):
        """The tenant roll-up (``GET /tenants`` and ``/snapshot``): totals
        and the bounded table, most active first."""
        rows = list(self._rows.values())
        table = {r.tenant: r.status_dict()
                 for r in sorted(rows, key=lambda r: (-r.device_ms, r.tenant))}
        return {
            "tenants": len(rows),
            "top_k": self.top_k,
            "evictions": self.evictions,
            "device_ms": round(self.device_ms, 3),
            "asks": self.asks,
            "tells": self.tells,
            "sheds": self.sheds,
            "table": table,
        }

    def publish(self):
        """Refresh the ``service.tenant.*`` gauges and return :meth:`status`."""
        st = self.status()
        if self.metrics is not None:
            g = self.metrics.gauge
            g("service.tenant.tracked").set(st["tenants"])
            g("service.tenant.evictions").set(st["evictions"])
            g("service.tenant.sheds").set(st["sheds"])
            for tenant, row in st["table"].items():
                base = f"service.tenant.{_metric_label(tenant)}"
                for k in ("device_ms", "asks", "tells", "sheds", "studies"):
                    g(f"{base}.{k}").set(row[k])
                if row.get("ask_p99_ms") is not None:
                    g(f"{base}.ask_p99_ms").set(row["ask_p99_ms"])
        return st

    def heat_table(self):
        """The per-tenant cumulative device_ms table a heat record carries."""
        return {row.tenant: round(row.device_ms, 3) for row in self._rows.values()}

    def study_status(self, tenant):
        row = self._rows.get(tenant)
        return None if row is None else row.status_dict()


def merge_status(statuses):
    """Merge per-scheduler :meth:`TenantLedger.status` dicts (one ledger
    per held shard) into the replica's view: summed totals and the merged
    table."""
    statuses = [s for s in statuses if s]
    if not statuses:
        return None
    out = {"tenants": 0, "evictions": 0, "device_ms": 0.0, "asks": 0, "tells": 0, "sheds": 0,
           "table": {}}
    top_k = 0
    for s in statuses:
        top_k = max(top_k, int(s.get("top_k") or 0))
        for k in ("evictions", "asks", "tells", "sheds"):
            out[k] += int(s.get(k) or 0)
        out["device_ms"] += float(s.get("device_ms") or 0.0)
        for tenant, row in (s.get("table") or {}).items():
            cur = out["table"].setdefault(tenant, {
                "studies": 0, "asks": 0, "tells": 0, "sheds": 0, "device_ms": 0.0,
                "hbm_bytes": 0.0, "ewma_ms": 0.0})
            for k in ("studies", "asks", "tells", "sheds"):
                cur[k] += int(row.get(k) or 0)
            for k in ("device_ms", "hbm_bytes"):
                cur[k] += float(row.get(k) or 0.0)
            cur["ewma_ms"] = max(cur["ewma_ms"], float(row.get("ewma_ms") or 0.0))
            # shards tick independently: report the worst tail seen
            if row.get("ask_p99_ms") is not None:
                cur["ask_p99_ms"] = max(float(cur.get("ask_p99_ms") or 0.0),
                                        float(row["ask_p99_ms"]))
                cur.setdefault("ask_p50_ms", row.get("ask_p50_ms"))
    out["tenants"] = len(out["table"])
    out["top_k"] = top_k
    out["device_ms"] = round(out["device_ms"], 3)
    for cur in out["table"].values():
        cur["device_ms"] = round(cur["device_ms"], 3)
        cur["hbm_bytes"] = round(cur["hbm_bytes"], 1)
        cur["ewma_ms"] = round(cur["ewma_ms"], 3)
    return out


def read_tenant_heat(store_root):
    """The fleet-merged per-tenant heat from the heat ledgers: the MAX per
    (shard, tenant) over the records' cumulative ``tenants`` tables,
    summed across shards.  Records without the field are skipped; an
    unreadable ledger gives what parsed."""
    from .load import _iter_heat_records

    per_shard = {}
    try:
        for _fname, rec, _status in _iter_heat_records(store_root):
            if rec is None or rec.get("kind") != "heat":
                continue
            table = rec.get("tenants")
            if not isinstance(table, dict):
                continue
            shard = rec.get("shard")
            for tenant, ms in table.items():
                try:
                    ms = float(ms)
                except (TypeError, ValueError):
                    continue
                key = (shard, str(tenant))
                if ms > per_shard.get(key, 0.0):
                    per_shard[key] = ms
    except Exception:  # noqa: BLE001 - fail-open read
        logger.warning("tenant heat: ledger read failed (continuing with what parsed)",
                       exc_info=True)
    tenants = {}
    for (_shard, tenant), ms in per_shard.items():
        tenants[tenant] = round(tenants.get(tenant, 0.0) + ms, 3)
    return {"tenants": tenants}
