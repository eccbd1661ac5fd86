"""The cost ledger and the durable heat ledger (counterpart of
``hyperopt_tpu/obs/load.py``, copied: host-only).

**The cost ledger** (:class:`CostLedger`, one per
:class:`~hyperopt_tpu_torch.service.scheduler.StudyScheduler`) is fed at
the wave chokepoint with each cohort tick's measured dispatch+readback
seconds, candidate count and history bytes, and attributes them across
the tick's studies by their share of the tick's asked rows.  It keeps
``{device_ms, asks, tells, waves, cand, hbm_bytes}`` per study plus an
activity EWMA, and a per-scheduler roll-up (shard heat, a busy-fraction
duty EWMA).  It never reads the RNG or a proposal: armed and disarmed
schedulers propose the same streams bit for bit, and disarmed
(``HYPEROPT_TPU_LOAD=off``) means ``scheduler.load is None``.

On the card a tick's dispatch returns before its kernels finish and the
readback's host copy waits for them, so the bracketed sum is the tick's
wall, as it is on the TPU; no synchronisation is added for the ledger.

**The durable heat ledger**: fleet replicas append their per-shard heat
to ``fleet/heat/<replica>.jsonl`` under the shared store root, one
CRC32C-sealed line per record (``service/integrity.py``), torn-line
tolerant on read.  Records are cumulative snapshots that include the
inherited baseline, so the merged per-shard heat is the MAX across every
replica's records: heat survives restarts, and an adoption inherits the
shard's heat through :func:`inherited_heat`.  The lines are the JAX
package's, so replicas of both packages can share one store root.
"""

from __future__ import annotations

import logging
import os
import threading
import time

__all__ = ["DEFAULT_BUSY_ALPHA", "StudyCost", "CostLedger", "HeatLedger", "merge_status",
           "heat_skew", "heat_dir_for", "heat_path_for", "read_heat", "inherited_heat"]

logger = logging.getLogger(__name__)

#: activity-EWMA weight (per-study attributed ms per tick, and the
#: scheduler's busy-fraction duty cycle)
DEFAULT_BUSY_ALPHA = 0.3

#: heat-ledger directory under a store root
HEAT_DIR = os.path.join("fleet", "heat")


class StudyCost:
    """One study's accumulated attributed cost; ``charge`` is O(1)
    arithmetic on the measured tick."""

    __slots__ = ("study_id", "cohort", "device_ms", "asks", "tells", "waves", "cand",
                 "hbm_bytes", "ewma_ms")

    def __init__(self, study_id, cohort=None):
        self.study_id = study_id
        self.cohort = cohort
        self.device_ms = 0.0
        self.asks = 0
        self.tells = 0
        self.waves = 0
        self.cand = 0.0
        self.hbm_bytes = 0.0
        self.ewma_ms = 0.0

    def charge(self, share_ms, k, cand, hbm_bytes, alpha):
        """Fold this study's row share of one cohort tick."""
        self.device_ms += share_ms
        self.asks += k
        self.waves += 1
        self.cand += cand
        self.hbm_bytes += hbm_bytes
        self.ewma_ms = alpha * share_ms + (1.0 - alpha) * self.ewma_ms

    def status_dict(self):
        """The per-study cost section (``GET /studies``)."""
        return {
            "cohort": self.cohort,
            "device_ms": round(self.device_ms, 3),
            "asks": self.asks,
            "tells": self.tells,
            "waves": self.waves,
            "cand": round(self.cand, 1),
            "hbm_bytes": round(self.hbm_bytes, 1),
            "ewma_ms": round(self.ewma_ms, 3),
        }


class CostLedger:
    """Per-scheduler device-time attribution (no threads).

    ``metrics`` is the registry the ``service.load.*`` gauges publish into
    at scrape time (:meth:`publish`).  Wave and tell mutations arrive
    under the scheduler's lock; the ledger's own lock guards only row
    admission, and scrape-side reads take no lock (a scrape racing a
    wave sees the tick one charge early or late).

    A fleet replica sets the (shard, replica) identity (:meth:`bind`) and
    the inherited baseline heat (:meth:`inherit`) at adoption, so
    ``heat_ms`` is the shard's cumulative heat, not this owner's share."""

    def __init__(self, metrics=None, alpha=DEFAULT_BUSY_ALPHA):
        self.metrics = metrics
        self.alpha = float(alpha)
        self.shard = None
        self.replica = None
        self._studies = {}
        self._lock = threading.Lock()
        # scheduler totals (attributed: they sum to the measured ticks)
        self.device_ms = 0.0
        self.inherited_ms = 0.0  # baseline adopted from the heat ledger
        self.asks = 0
        self.tells = 0
        self.waves = 0
        self.cand = 0.0
        self.hbm_bytes = 0.0
        self.busy = 0.0          # duty-cycle EWMA (device sec / wall sec)
        self._last_tick = None   # monotonic time of the previous tick

    def bind(self, shard=None, replica=None):
        """Attach the (shard, replica) identity the fleet rows carry."""
        self.shard = None if shard is None else int(shard)
        self.replica = None if replica is None else str(replica)

    def inherit(self, heat_ms):
        """Adopt a baseline heat (the shard's heat under previous owners);
        a max, so a re-adoption never doubles it."""
        self.inherited_ms = max(self.inherited_ms, float(heat_ms or 0.0))

    @property
    def heat_ms(self):
        """The shard's cumulative heat: inherited baseline plus what this
        scheduler attributed."""
        return self.inherited_ms + self.device_ms

    def _row(self, study_id, cohort=None):
        row = self._studies.get(study_id)
        if row is None:
            with self._lock:
                row = self._studies.get(study_id)
                if row is None:
                    row = StudyCost(study_id, cohort=cohort)
                    self._studies[study_id] = row
        return row

    def observe_tick(self, entries, device_sec, cand=0.0, hbm_bytes=0.0, cohort=None):
        """Attribute one measured cohort tick.  ``entries`` is
        ``[(study_id, k_rows), ...]``: each study is charged
        ``k_i / sum(k)`` of the tick's ``device_sec``, ``cand`` and
        ``hbm_bytes``."""
        total_k = 0
        for _, k in entries:
            total_k += k
        if total_k <= 0:
            return
        ms = float(device_sec) * 1e3
        inv = 1.0 / total_k
        for study_id, k in entries:
            row = self._row(study_id, cohort)
            if row.cohort is None and cohort is not None:
                row.cohort = cohort  # the first device tick names the cohort
            share = k * inv
            row.charge(ms * share, k, cand * share, hbm_bytes * share, self.alpha)
        self.device_ms += ms
        self.asks += total_k
        self.waves += 1
        self.cand += float(cand)
        self.hbm_bytes += float(hbm_bytes)
        # duty EWMA: device seconds over the wall since the previous tick
        # (a tick is never busier than its own interval)
        now = time.monotonic()
        if self._last_tick is not None:
            wall = now - self._last_tick
            duty = float(device_sec) / max(wall, float(device_sec), 1e-9)
            self.busy = self.alpha * duty + (1.0 - self.alpha) * self.busy
        self._last_tick = now

    def observe_tell(self, study_id):
        """Count one live settled tell (replayed tells are not recounted:
        adopted heat arrives through :meth:`inherit`)."""
        self.tells += 1
        self._row(study_id).tells += 1

    def forget(self, study_id):
        with self._lock:
            self._studies.pop(study_id, None)

    def study_status(self, study_id):
        """Cost section of one study, or None if never charged."""
        row = self._studies.get(study_id)
        return None if row is None else row.status_dict()

    def status(self):
        """The load roll-up (``/snapshot`` and ``/fleet/load``): the
        scheduler's totals and the per-cohort table."""
        rows = list(self._studies.values())
        cohorts = {}
        for row in rows:
            c = cohorts.setdefault(row.cohort or "unticked", {
                "studies": 0, "device_ms": 0.0, "asks": 0, "tells": 0, "waves": 0})
            c["studies"] += 1
            c["device_ms"] += row.device_ms
            c["asks"] += row.asks
            c["tells"] += row.tells
            c["waves"] += row.waves
        for c in cohorts.values():
            c["device_ms"] = round(c["device_ms"], 3)
        return {
            "shard": self.shard,
            "replica": self.replica,
            "studies": len(rows),
            "device_ms": round(self.device_ms, 3),
            "inherited_ms": round(self.inherited_ms, 3),
            "heat_ms": round(self.heat_ms, 3),
            "busy_frac": round(self.busy, 4),
            "asks": self.asks,
            "tells": self.tells,
            "waves": self.waves,
            "cand": round(self.cand, 1),
            "hbm_bytes": round(self.hbm_bytes, 1),
            "cohorts": cohorts,
        }

    def publish(self):
        """Refresh the per-shard ``service.load.shard.*`` gauges (bound
        schedulers only) and return :meth:`status`."""
        st = self.status()
        if self.metrics is not None and self.shard is not None:
            base = f"service.load.shard.{self.shard}"
            g = self.metrics.gauge
            g(f"{base}.heat_ms").set(st["heat_ms"])
            g(f"{base}.busy_frac").set(st["busy_frac"])
            g(f"{base}.device_ms").set(st["device_ms"])
            g(f"{base}.waves").set(st["waves"])
        return st

    def heat_record(self):
        """One cumulative heat-ledger snapshot of this scheduler (it
        includes the inherited baseline, so the MAX over every replica's
        records is the shard's lifetime heat)."""
        return {
            "kind": "heat",
            "replica": self.replica,
            "shard": self.shard,
            "heat_ms": round(self.heat_ms, 3),
            "device_ms": round(self.device_ms, 3),
            "busy_frac": round(self.busy, 4),
            "studies": len(self._studies),
            "asks": self.asks,
            "tells": self.tells,
            "waves": self.waves,
            "cand": round(self.cand, 1),
            "hbm_bytes": round(self.hbm_bytes, 1),
            "ts": time.time(),
        }


def heat_skew(values):
    """Max over mean of the per-shard heats: 1.0 is balanced, and 1.0
    when there is nothing to compare (at most one shard, or no heat)."""
    vals = [float(v) for v in values if v is not None]
    if len(vals) < 2:
        return 1.0
    mean = sum(vals) / len(vals)
    if mean <= 0.0:
        return 1.0
    return max(vals) / mean


def merge_status(statuses):
    """Merge per-scheduler :meth:`CostLedger.status` dicts (a fleet
    replica runs one ledger per held shard): summed totals, the per-shard
    table and the heat skew over it."""
    statuses = [s for s in statuses if s]
    if not statuses:
        return None
    out = {"studies": 0, "device_ms": 0.0, "heat_ms": 0.0, "asks": 0, "tells": 0,
           "waves": 0, "cand": 0.0, "hbm_bytes": 0.0, "busy_frac": 0.0, "shards": {}}
    for s in statuses:
        for k in ("studies", "asks", "tells", "waves"):
            out[k] += int(s.get(k) or 0)
        for k in ("device_ms", "heat_ms", "cand", "hbm_bytes"):
            out[k] += float(s.get(k) or 0.0)
        # shards tick one after another in one process: the replica's
        # duty cycle is the sum of its schedulers'
        out["busy_frac"] += float(s.get("busy_frac") or 0.0)
        if s.get("shard") is not None:
            out["shards"][str(s["shard"])] = {
                k: s.get(k) for k in ("heat_ms", "busy_frac", "device_ms", "studies",
                                      "asks", "tells", "waves")}
    for k in ("device_ms", "heat_ms", "cand", "hbm_bytes"):
        out[k] = round(out[k], 3)
    out["busy_frac"] = round(out["busy_frac"], 4)
    out["heat_skew"] = round(heat_skew([v["heat_ms"] for v in out["shards"].values()]), 4)
    return out


def heat_dir_for(store_root):
    return os.path.join(str(store_root), HEAT_DIR)


def heat_path_for(store_root, replica_id):
    """One append-only file per replica: no two writers share a file."""
    return os.path.join(heat_dir_for(store_root), f"{replica_id}.jsonl")


class HeatLedger:
    """Append-only heat records of one replica, each line sealed; best
    effort on any ``OSError`` (a full disk costs heat durability, never a
    request), with one warning."""

    def __init__(self, path):
        self.path = str(path)
        self._warned = False

    def append(self, rec):
        from ..service import integrity

        line = (integrity.seal(rec) + "\n").encode()
        try:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            fd = os.open(self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
            try:
                os.write(fd, line)
            finally:
                os.close(fd)
        except OSError as e:
            if not self._warned:
                self._warned = True
                logger.warning("heat ledger: cannot append to %s (%s); shard heat will "
                               "not survive a restart", self.path, e)


def _iter_heat_records(store_root):
    """Every heat record under the root as ``(file, rec, status)``; a
    corrupt or torn line yields ``rec=None`` (corrupt ones are logged)."""
    from ..service import integrity

    d = heat_dir_for(store_root)
    try:
        names = sorted(os.listdir(d))
    except (FileNotFoundError, NotADirectoryError):
        return
    for fname in names:
        if not fname.endswith(".jsonl"):
            continue
        path = os.path.join(d, fname)
        for chk in integrity.iter_checked_jsonl(path):
            if chk.status == integrity.CORRUPT:
                logger.warning("heat ledger: %s:%d corrupt record skipped", path, chk.lineno)
                yield fname, None, chk.status
                continue
            yield fname, chk.rec, chk.status


def read_heat(store_root):
    """The fleet-wide heat view from every replica's ledger: per-shard
    cumulative heat (the MAX over records), each replica's latest
    snapshot, and the heat skew."""
    from ..service import integrity

    shards, replicas, files = {}, {}, set()
    corrupt = torn = 0
    for fname, rec, status in _iter_heat_records(store_root):
        files.add(fname)
        if rec is None:
            if status == integrity.CORRUPT:
                corrupt += 1
            else:
                torn += 1
            continue
        if rec.get("kind") != "heat":
            continue
        shard = rec.get("shard")
        if shard is not None:
            k = str(int(shard))
            cur = shards.get(k)
            if cur is None or float(rec.get("heat_ms") or 0.0) > cur["heat_ms"]:
                shards[k] = {"heat_ms": float(rec.get("heat_ms") or 0.0),
                             "replica": rec.get("replica"), "waves": rec.get("waves"),
                             "asks": rec.get("asks"), "tells": rec.get("tells"),
                             "ts": rec.get("ts")}
        rid = rec.get("replica")
        if rid is not None:
            cur = replicas.get(rid)
            if cur is None or float(rec.get("ts") or 0.0) >= float(cur.get("ts") or 0.0):
                replicas[rid] = {"busy_frac": rec.get("busy_frac"), "shard": rec.get("shard"),
                                 "ts": rec.get("ts")}
    return {
        "shards": shards,
        "replicas": replicas,
        "heat_skew": round(heat_skew([v["heat_ms"] for v in shards.values()]), 4),
        "files": len(files),
        "corrupt": corrupt,
        "torn": torn,
    }


def inherited_heat(store_root, shard):
    """The heat an adopter of ``shard`` inherits: the MAX ``heat_ms`` any
    replica recorded for it; 0.0 for a never-heated shard or an
    unreadable ledger (adoption never fails on observability)."""
    best = 0.0
    try:
        k = int(shard)
        for _, rec, _status in _iter_heat_records(store_root):
            if rec is None or rec.get("kind") != "heat":
                continue
            if rec.get("shard") is not None and int(rec["shard"]) == k:
                best = max(best, float(rec.get("heat_ms") or 0.0))
    except Exception:  # noqa: BLE001 - fail-open read
        logger.warning("heat ledger: inherited-heat read failed for shard %s (continuing "
                       "cold)", shard, exc_info=True)
    return best
