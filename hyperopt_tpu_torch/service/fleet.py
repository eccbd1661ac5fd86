"""The replicated serving fleet: N server replicas over one store root, one
logical ask/tell service (counterpart of ``hyperopt_tpu/service/fleet.py``).

* The study keyspace partitions into M study-shards: :func:`shard_of`
  buckets a study id by CRC32, and the shard count is a write-once
  property of the store root (``fleet/params.json``, verified by every
  joiner).
* Each shard is owned through an epoch lease
  (:class:`~hyperopt_tpu_torch.parallel.membership.EpochLeases`: ``O_EXCL``
  claim, mtime heartbeat, rename-first stale reclaim) and served by its own
  :class:`~hyperopt_tpu_torch.service.scheduler.StudyScheduler`, whose WAL
  is the (shard, epoch) journal
  ``fleet/wal/shard<k>/e<epoch>.<replica>.jsonl``.  Epochs bump on every
  claim, so two owners' journals never interleave.
* An ownership table (``fleet/owners/shard<k>.json``, CRC32C-sealed) maps
  each shard to its owner's advertised address; a request for a study
  another replica owns raises :class:`ShardNotOwned` (HTTP 307 to the
  owner), which ``ServiceClient`` follows with a bounded hop count.
* Migration is WAL replay: adopting a shard (a stale reclaim after a
  SIGKILL, or the handoff of a drain or a rebalance) replays its epoch-WAL
  chain oldest first through :meth:`StudyScheduler.resume`, whose replay
  proposes as the undisturbed run did.  The adoption compacts the chain
  into one snapshot-led file of the new epoch and deletes the ancestors
  only once the compaction and its directory entry are durable.  The
  asks a replay regenerates run the cohort kernels at whatever slot count
  the adopted cohort has.
* A steward thread per replica reclaims stale leases and rebalances
  toward ``ceil(M / live replicas)`` shards, handing off its hottest shard
  first (the cost ledger's heat); a separate heartbeat thread keeps the
  replica's own leases fresh even while the steward replays an adoption.
* Ownership mutations are fenced by the lease: each shard's scheduler
  re-verifies it at every durability point (``StudyScheduler.fence``), and
  every acknowledged mutation is fsynced into the shard's epoch WAL before
  the client unblocks, so a SIGKILL loses nothing acknowledged.

Every file here (params, owners, replica records, leases, epoch WALs, heat
ledger lines) has the JAX package's layout, so replicas of both packages
can share one store root.  A replica's schedulers run on its ``device``:
the CUDA card unless ``device="cpu"``.
"""

from __future__ import annotations

import json
import logging
import math
import os
import re
import threading
import time
import zlib

from .._env import parse_fleet_lease_ttl, parse_fleet_shards, resolve_device
from ..filestore import _atomic_write, new_run_id
from ..obs.metrics import get_metrics
from ..parallel.membership import EpochLeases, publish_params_once, rotate_for_owner
from . import integrity
from .journal import StudyJournal, _fsync_dir

__all__ = ["FleetReplica", "ShardNotOwned", "ShardUnavailable", "shard_of", "FLEET_DIR"]

logger = logging.getLogger(__name__)

#: fleet metadata directory under a store root
FLEET_DIR = "fleet"


class ShardNotOwned(RuntimeError):
    """Another replica owns the study's shard; ``location`` is its
    advertised address (HTTP 307)."""

    def __init__(self, message, location):
        super().__init__(message)
        self.location = str(location)


class ShardUnavailable(RuntimeError):
    """No replica serves the shard right now (its owner died and no
    survivor adopted it yet, the fleet is rebalancing, or this replica is
    starting): retryable, HTTP 503 with ``Retry-After``."""

    def __init__(self, message, retry_after=0.5):
        super().__init__(message)
        self.retry_after = float(retry_after)


def shard_of(study_id, n_shards):
    """Study id to shard bucket by CRC32: stable across processes, Python
    versions and the two packages (re-bucketing would strand every stored
    study behind redirects to the wrong owner)."""
    return zlib.crc32(str(study_id).encode()) % int(n_shards)


def _shard_name(shard):
    return f"shard{int(shard):04d}"


def _safe_id(rid):
    """Replica ids become path components: keep them one component."""
    return re.sub(r"[^A-Za-z0-9._-]", "-", str(rid))


class FleetReplica:
    """One replica's membership in the serving fleet: its held shard
    leases, the per-shard schedulers and epoch WALs behind them, and the
    steward that keeps ownership balanced and reclaims the shards of dead
    replicas.  The HTTP layer routes every study-scoped request through
    :meth:`scheduler_for` and creates studies through :meth:`place_study`.

    ``device`` is where every shard's scheduler runs (the CUDA card unless
    ``device="cpu"``; without a card the default raises before the store
    is touched); it is passed to the schedulers with ``scheduler_kwargs``."""

    def __init__(self, store_root, n_shards=None, replica_id=None, addr=None,
                 lease_ttl=None, poll=None, scheduler_kwargs=None, device=None):
        self.scheduler_kwargs = dict(scheduler_kwargs or {})
        self.device = resolve_device(device if device is not None
                                     else self.scheduler_kwargs.get("device"))
        self.scheduler_kwargs["device"] = self.device
        self.store_root = str(store_root)
        self.n_shards = parse_fleet_shards() if n_shards is None else int(n_shards)
        if self.n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.replica_id = _safe_id(replica_id or f"{os.uname().nodename}-{os.getpid()}")
        self.addr = str(addr).rstrip("/") if addr else None
        self.lease_ttl = parse_fleet_lease_ttl() if lease_ttl is None else float(lease_ttl)
        #: steward sweep period and lease heartbeat cadence: four beats per
        #: TTL keep one lost sweep from looking like a death
        self.poll = max(0.05, self.lease_ttl / 4.0) if poll is None else float(poll)
        self.member_ttl = 3.0 * self.lease_ttl
        self.metrics = get_metrics("service")
        self.overload = None  # the AdmissionGuard, wired by the HTTP server

        self._fleet = os.path.join(self.store_root, FLEET_DIR)
        for d in ("owners", "replicas", "wal", "heat"):
            os.makedirs(os.path.join(self._fleet, d), exist_ok=True)
        # the durable heat ledger: one append-only file per replica under
        # the shared root, so shard heat survives restarts and an adoption
        # inherits it (appends only for schedulers with a cost ledger)
        from ..obs.load import HeatLedger, heat_path_for

        self.heat = HeatLedger(heat_path_for(self.store_root, self.replica_id))
        self._heat_last = 0.0  # monotonic time of the last roll-up
        self.leases = EpochLeases(os.path.join(self._fleet, "shardleases"),
                                  owner=self.replica_id, lease_ttl=self.lease_ttl,
                                  metrics=self.metrics)
        publish_params_once(os.path.join(self._fleet, "params.json"),
                            {"n_shards": self.n_shards},
                            what=f"serving-fleet store {self.store_root}")

        self._lock = threading.RLock()
        self.schedulers = {}  # shard -> StudyScheduler (held shards only)
        self.epochs = {}      # shard -> the lease epoch naming its WAL
        self._verified = {}   # shard -> monotonic time of the last lease check
        #: how stale a lease check may get before a study-scoped request
        #: re-reads the lease (bounds a stalled holder's window)
        self._verify_every = max(0.05, self.lease_ttl / 4.0)
        self._draining = False
        self._stop = threading.Event()
        self._hb_stop = threading.Event()
        self._thread = None
        self._hb_thread = None
        self.adoptions = 0
        self.handoffs = 0
        self.leases_lost = 0

    # -- shard-epoch WAL naming --------------------------------------------

    def _wal_dir(self, shard):
        return os.path.join(self._fleet, "wal", _shard_name(shard))

    def _wal_path(self, shard, epoch):
        return os.path.join(self._wal_dir(shard), f"e{int(epoch):05d}.{self.replica_id}.jsonl")

    def wal_chain(self, shard):
        """The shard's epoch WAL files, oldest epoch first: what an
        adoption replays.  Longer than one only after a crash between a
        compaction and the ancestors' deletion, which replays
        idempotently."""
        try:
            names = os.listdir(self._wal_dir(shard))
        except FileNotFoundError:
            return []
        out = []
        for fname in names:
            m = re.match(r"e(\d+)\..+\.jsonl$", fname)
            if m:
                out.append((int(m.group(1)), os.path.join(self._wal_dir(shard), fname)))
        return [p for _, p in sorted(out)]

    # -- ownership table (routing only: the lease is ownership) ------------

    def _owner_path(self, shard):
        return os.path.join(self._fleet, "owners", f"{_shard_name(shard)}.json")

    def read_owner(self, shard):
        """The shard's published owner entry ``{replica, addr, epoch}``, or
        None; a corrupt entry reads as absent (a retryable 503 until the
        owner republishes)."""
        try:
            with open(self._owner_path(shard)) as f:
                rec = json.loads(f.read())
            if not isinstance(rec, dict):
                return None
            if integrity.verify_obj(rec) == integrity.CORRUPT:
                logger.warning("fleet: ownership entry for shard %s is corrupt; treating "
                               "as unowned", shard)
                return None
            return rec
        except (OSError, ValueError):
            return None

    def _publish_ownership(self, shard, epoch):
        _atomic_write(self._owner_path(shard), json.dumps(
            integrity.seal_obj({"shard": int(shard), "replica": self.replica_id,
                                "addr": self.addr, "epoch": int(epoch), "ts": time.time()}),
            sort_keys=True).encode())

    def _clear_ownership(self, shard):
        """Remove our routing entry (drain), never one a new owner
        published."""
        rec = self.read_owner(shard)
        if rec is not None and rec.get("replica") != self.replica_id:
            return
        try:
            os.remove(self._owner_path(shard))
        except FileNotFoundError:
            pass

    # -- replica records (liveness by mtime; size the balance target) ------

    def _replica_path(self, rid=None):
        return os.path.join(self._fleet, "replicas", _safe_id(rid or self.replica_id))

    def join(self):
        _atomic_write(self._replica_path(), json.dumps(
            {"replica": self.replica_id, "addr": self.addr, "pid": os.getpid(),
             "joined": time.time()}, sort_keys=True).encode())
        self.metrics.counter("service.fleet.joins").inc()

    def heartbeat_replica(self):
        try:
            os.utime(self._replica_path(), None)
        except FileNotFoundError:
            self.join()

    def leave(self):
        try:
            os.remove(self._replica_path())
        except FileNotFoundError:
            pass

    def live_replicas(self):
        """Replica ids whose record heartbeated within ``member_ttl``."""
        d = os.path.join(self._fleet, "replicas")
        now = time.time()
        out = []
        for fname in sorted(os.listdir(d)):
            try:
                age = now - os.path.getmtime(os.path.join(d, fname))
            except FileNotFoundError:
                continue
            if age <= self.member_ttl:
                out.append(fname)
        return out

    def target_shards(self):
        """How many shards this replica should hold, ``ceil(M / live)``:
        every member computes it from the same records, so the fleet
        converges without a coordinator."""
        live = max(1, len(self.live_replicas()))
        return min(self.n_shards, math.ceil(self.n_shards / live))

    # -- adoption (the migration path) -------------------------------------

    def adopt(self, shard):
        """Claim ``shard`` and rebuild its studies by replaying its epoch-WAL
        chain into a fresh scheduler.  True on success, False when a racing
        replica won the claim."""
        name = _shard_name(shard)
        epoch = self.leases.try_claim(name)
        if epoch is None:
            return False
        t0 = time.perf_counter()
        from .scheduler import StudyScheduler

        os.makedirs(self._wal_dir(shard), exist_ok=True)
        new_path = self._wal_path(shard, epoch)
        chain = [p for p in self.wal_chain(shard) if p != new_path]
        try:
            sched = StudyScheduler(store_root=self.store_root, wal=new_path, auto_resume=False,
                                   **self.scheduler_kwargs)
            if self.overload is not None:
                sched.overload = self.overload
            # the durability fence: a stalled holder whose lease was
            # reclaimed refuses the mutation (503) instead of landing state
            # the new owner's replay never saw
            sched.fence = lambda: self._fence(shard, epoch)
            for path in chain:
                sched.resume(StudyJournal(path))
        except Exception:
            # never serve a half-replayed shard: free the claim for a retry
            logger.warning("fleet: replay of %s epoch chain failed; releasing the claim",
                           name, exc_info=True)
            self.leases.release(name)
            raise
        if chain and sched._maybe_compact():
            # the chain is one snapshot-led file now: drop the ancestors
            # only once it and its directory entry are durable
            _fsync_dir(new_path)
            for path in chain:
                try:
                    os.remove(path)
                except FileNotFoundError:
                    pass
            _fsync_dir(new_path)
        if sched.load is not None:
            # the shard's heat under earlier owners comes from the durable
            # ledger, not from replay (replayed tells are not recounted);
            # adoption never fails on observability
            try:
                from ..obs.load import inherited_heat

                sched.load.bind(shard=shard, replica=self.replica_id)
                sched.load.inherit(inherited_heat(self.store_root, shard))
            except Exception:  # noqa: BLE001
                logger.warning("fleet: heat inheritance for %s failed; adopting cold", name,
                               exc_info=True)
        with self._lock:
            self.schedulers[shard] = sched
            self.epochs[shard] = epoch
            self._verified[shard] = time.monotonic()
        self._publish_ownership(shard, epoch)
        self.adoptions += 1
        self.metrics.counter("service.fleet.adoptions").inc()
        self.metrics.histogram("service.fleet.adopt_sec").observe(time.perf_counter() - t0)
        self.metrics.gauge("service.fleet.shards_held").set(len(self.schedulers))
        return True

    def handoff(self, shard, timeout=30.0):
        """Release one shard (drain, rebalance): quiesce its scheduler (the
        waves in flight finish, the WAL compacts and closes), flush its
        heat, clear our routing entry, release the lease.  The next owner
        replays one compacted file."""
        with self._lock:
            sched = self.schedulers.pop(shard, None)
            self.epochs.pop(shard, None)
            self._verified.pop(shard, None)
        if sched is None:
            return False
        try:
            sched.drain(timeout=timeout)
        except Exception:  # noqa: BLE001 - the lease must still be freed
            logger.warning("fleet: drain of %s failed mid-handoff", _shard_name(shard),
                           exc_info=True)
        # the last heat snapshot lands before the lease is released, so the
        # next owner inherits all of it
        if sched.load is not None:
            try:
                self.heat.append(self._heat_rec(sched))
            except Exception:  # noqa: BLE001
                logger.warning("fleet: heat flush for %s failed", _shard_name(shard),
                               exc_info=True)
        self._clear_ownership(shard)
        self.leases.release(_shard_name(shard))
        self.handoffs += 1
        self.metrics.counter("service.fleet.handoffs").inc()
        self.metrics.gauge("service.fleet.shards_held").set(len(self.schedulers))
        return True

    def _drop_shard(self, shard):
        """Our lease was reclaimed (we stalled past the TTL): stop serving
        the shard at once, with no drain and no compaction (rewriting the
        fenced epoch file could resurrect a journal the adopter already
        replayed and deleted).  Every acknowledged mutation is fsynced in
        the epoch WAL the reclaimer replays.  The journal handle stays
        open: closing it here would race an append under the scheduler's
        own lock."""
        sched = self.schedulers.pop(shard, None)
        self.epochs.pop(shard, None)
        self._verified.pop(shard, None)
        if sched is None:
            return
        self.leases_lost += 1
        self.metrics.counter("service.fleet.leases_lost").inc()
        self.metrics.gauge("service.fleet.shards_held").set(len(self.schedulers))
        logger.warning("fleet: lost lease on %s (reclaimed by a survivor); dropping the "
                       "shard un-drained", _shard_name(shard))

    # -- request routing ---------------------------------------------------

    def _fence(self, shard, epoch):
        """The durability-point check of the shard's scheduler of lease
        ``epoch``: a fresh read of the lease body.  A lost lease drops the
        shard at once.  The epoch is part of the check: a scheduler this
        replica handed off stays fenced when the replica claims the shard
        again (the JAX package's fence checks the lease alone, so a
        request that reached the handed-off scheduler before the handoff
        could land a tell the new scheduler never sees)."""
        name = _shard_name(shard)
        if self.leases.held.get(name) == epoch and self.leases.verify_held(name):
            return True
        with self._lock:
            if self.epochs.get(shard) == epoch:
                self._drop_shard(shard)
        return False

    def scheduler_for(self, study_id):
        """The scheduler serving ``study_id``'s shard.  Raises
        :class:`ShardNotOwned` (307) when another replica owns it and
        :class:`ShardUnavailable` (503) when nobody does yet.  Held leases
        are re-verified at most every ``lease_ttl / 4``."""
        shard = shard_of(study_id, self.n_shards)
        with self._lock:
            sched = self.schedulers.get(shard)
            if sched is not None:
                now = time.monotonic()
                if now - self._verified.get(shard, 0.0) > self._verify_every:
                    if self.leases.verify_held(_shard_name(shard)):
                        self._verified[shard] = now
                    else:
                        self._drop_shard(shard)
                        sched = None
            if sched is not None:
                return sched
        owner = self.read_owner(shard)
        if owner is not None and owner.get("addr") and owner.get("replica") != self.replica_id:
            raise ShardNotOwned(f"study {study_id} (shard {shard}) is served by "
                                f"{owner['replica']}", owner["addr"])
        raise ShardUnavailable(f"shard {shard} has no live owner yet (owner died or fleet "
                               "is rebalancing); retry",
                               retry_after=max(0.05, self.lease_ttl / 4.0))

    def place_study(self):
        """Mint a study id that lands in a shard this replica holds (ids
        are minted server-side, so a creation cannot redirect): redraw
        until the CRC32 bucket is held.  Each id claims its store
        directory atomically, so two replicas never mint the same id.
        Returns ``(study_id, scheduler)``."""
        with self._lock:
            held = dict(self.schedulers)
        if not held or self._draining:
            raise ShardUnavailable("replica holds no study shards (starting up, draining, "
                                   "or every shard is owned elsewhere); retry",
                                   retry_after=max(0.05, self.poll))
        bound = max(64, 32 * self.n_shards // max(1, len(held)))
        for _ in range(bound):
            sid = new_run_id("study", unique_dir=self.store_root)
            sched = held.get(shard_of(sid, self.n_shards))
            if sched is not None:
                return sid, sched
            try:  # release the claimed (empty) directory and redraw
                os.rmdir(os.path.join(self.store_root, sid))
            except OSError:
                pass
        raise ShardUnavailable(f"could not mint a study id landing in a held shard in "
                               f"{bound} draws", retry_after=max(0.05, self.poll))

    # -- the steward (heartbeat, reclaim, rebalance) -----------------------

    def start(self):
        """Join, run one steward sweep (so a lone replica serves at once),
        then keep two daemon threads: the heartbeat (lease and member
        mtimes only) and the steward (reclaim, claim, rebalance).  They are
        separate because an adoption's replay runs the cohort kernels (the
        first one on the card also loads the CUDA context), and a steward
        blocked there must not starve this replica's own lease
        heartbeats: that is how a live replica loses its other shards."""
        self.join()
        self.steward_once()
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, name=f"hyperopt-fleet-heartbeat-{self.replica_id}",
            daemon=True)
        self._hb_thread.start()
        self._thread = threading.Thread(
            target=self._steward_loop, name=f"hyperopt-fleet-steward-{self.replica_id}",
            daemon=True)
        self._thread.start()
        return self

    def _heartbeat_loop(self):
        # its own stop event: the heartbeat outlives the steward during a
        # drain, so a lease waiting in the handoff queue is not reclaimed
        while not self._hb_stop.wait(self.poll):
            try:
                self.heartbeat_once()
            except Exception:  # noqa: BLE001 - heartbeats must survive
                logger.warning("fleet: heartbeat sweep failed (continuing)", exc_info=True)

    def _steward_loop(self):
        while not self._stop.wait(self.poll):
            try:
                self.manage_once()
            except Exception:  # noqa: BLE001 - the steward must survive
                logger.warning("fleet: steward sweep failed (continuing)", exc_info=True)

    def steward_once(self):
        """One full sweep (heartbeat and manage)."""
        self.heartbeat_once()
        self.manage_once()

    def heartbeat_once(self):
        """Refresh the member record and every held lease; drop leases
        reclaimed from under us.  It runs while draining too, over the
        lease plane's held set: a shard mid-handoff keeps its lease fresh
        until the handoff releases it."""
        self.heartbeat_replica()
        for name in list(self.leases.held):
            if not self.leases.heartbeat(name):
                with self._lock:
                    self._drop_shard(int(name[len("shard"):]))
        self._roll_heat()

    def _shard_heat(self, sched):
        """One scheduler's cumulative shard heat in ms (0.0 without a cost
        ledger: every shard ties and the shard number decides)."""
        return 0.0 if sched is None or sched.load is None else sched.load.heat_ms

    def _roll_heat(self, force=False):
        """Append one cumulative heat snapshot per held scheduler with a
        cost ledger to this replica's ledger, at most once a steward
        period (``force`` bypasses); best effort."""
        now = time.monotonic()
        if not force and now - self._heat_last < max(1.0, self.poll):
            return
        self._heat_last = now
        with self._lock:
            scheds = dict(self.schedulers)
        for shard, sched in scheds.items():
            if sched.load is None:
                continue
            try:
                self.heat.append(self._heat_rec(sched))
            except Exception:  # noqa: BLE001
                logger.warning("fleet: heat roll-up for %s failed", _shard_name(shard),
                               exc_info=True)

    @staticmethod
    def _heat_rec(sched):
        """One scheduler's heat record, with the tenant ledger's per-tenant
        table (``tenants``) when it has one."""
        rec = sched.load.heat_record()
        if sched.tenants is not None:
            try:
                table = sched.tenants.heat_table()
                if table:
                    rec["tenants"] = table
            except Exception:  # noqa: BLE001 - the record stays load-only
                pass
        return rec

    def manage_once(self):
        """Reclaim stale leases fleet-wide (adopting what we freed at
        once), claim toward the balance target, hand off one excess shard,
        the hottest first."""
        if self._draining:
            return
        freed = self.leases.reclaim([_shard_name(s) for s in range(self.n_shards)])
        if freed:
            self.metrics.counter("service.fleet.reclaims").inc(len(freed))
            # a reclaimed shard's owner is dead (graceful handoffs remove
            # their lease file), so adopt it now whatever the balance
            # target: availability first, the later rebalance spreads it
            for name in freed:
                self.adopt(int(name[len("shard"):]))
        target = self.target_shards()
        with self._lock:
            n_held = len(self.schedulers)
        if n_held < target:
            for shard in rotate_for_owner(range(self.n_shards), self.replica_id):
                if n_held >= target:
                    break
                with self._lock:
                    if shard in self.schedulers:
                        continue
                if not os.path.exists(self.leases._lease_path(_shard_name(shard))):
                    if self.adopt(shard):
                        n_held += 1
        elif n_held > target and len(self.live_replicas()) > 1:
            # one handoff per sweep keeps a rebalance gradual; the hottest
            # held shard goes first, so a rebalance sheds load, not count
            with self._lock:
                excess = max(self.schedulers,
                             key=lambda k: (self._shard_heat(self.schedulers[k]), k),
                             default=None)
            if excess is not None:
                self.handoff(excess)

    # -- lifecycle and views -----------------------------------------------

    @property
    def draining(self):
        return self._draining

    def set_addr(self, addr):
        """Advertise ``addr`` (known only after the HTTP bind for an
        ephemeral port) and republish every held ownership entry."""
        self.addr = str(addr).rstrip("/") if addr else None
        with self._lock:
            held = dict(self.epochs)
        for shard, epoch in held.items():
            self._publish_ownership(shard, epoch)

    def drain(self, timeout=30.0):
        """The SIGTERM path: stop stewarding, hand off every held shard
        (survivors adopt one snapshot-led WAL each), leave the fleet.
        True when every handoff quiesced in time."""
        self._draining = True
        self._stop.set()  # the steward stops; heartbeats keep running
        if self._thread is not None:
            self._thread.join(timeout=max(1.0, self.poll * 2))
        ok = True
        deadline = time.monotonic() + float(timeout)
        with self._lock:
            held = sorted(self.schedulers)
        for shard in held:
            ok = self.handoff(shard, timeout=max(0.5, deadline - time.monotonic())) and ok
        # every lease is released: the heartbeat may stop now
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=max(1.0, self.poll * 2))
        self.leave()
        return ok

    def healthz(self):
        """The ``GET /healthz`` body: the replica, its held leases and
        epochs, drain state, WAL health, heat and tenant roll-ups, and the
        replica addresses the ownership table names."""
        with self._lock:
            shards = {}
            heat_ms = busy = 0.0
            any_load = False
            for shard, sched in self.schedulers.items():
                j = sched.journal
                shards[str(shard)] = {
                    "epoch": self.epochs.get(shard),
                    "studies": len(sched._studies),
                    "wal": None if j is None else {
                        "path": j.path, "appends": j.appends, "syncs": j.syncs,
                        "compactions": j.compactions},
                }
                if sched.load is not None:
                    any_load = True
                    h, b = sched.load.heat_ms, sched.load.busy
                    heat_ms += h
                    busy += b
                    shards[str(shard)]["heat_ms"] = round(h, 3)
                    shards[str(shard)]["busy_frac"] = round(b, 4)
        out = {
            "ok": not self._draining,
            "replica": self.replica_id,
            "addr": self.addr,
            "n_shards": self.n_shards,
            "shards_held": sorted(int(k) for k in shards),
            "shards": shards,
            "draining": self._draining,
            "wal_sync_errors": self.metrics.counter("service.wal.sync_errors").value,
            "replicas": self.live_replicas(),
            "adoptions": self.adoptions,
            "handoffs": self.handoffs,
            "leases_lost": self.leases_lost,
            "lease_ttl": self.lease_ttl,
            "ts": time.time(),
        }
        if any_load:
            out["load"] = {"heat_ms": round(heat_ms, 3), "busy_frac": round(busy, 4)}
        tracked = sheds = evictions = 0
        any_tenants = False
        with self._lock:
            for sched in self.schedulers.values():
                if sched.tenants is None:
                    continue
                any_tenants = True
                try:
                    ts = sched.tenants.status()
                    tracked = max(tracked, ts["tenants"])
                    sheds += ts["sheds"]
                    evictions += ts["evictions"]
                except Exception:  # noqa: BLE001 - fail-open roll-up
                    pass
        if any_tenants:
            out["tenants"] = {"tracked": tracked, "sheds": sheds, "evictions": evictions}
        addrs = {self.replica_id: self.addr} if self.addr else {}
        for shard in range(self.n_shards):
            rec = self.read_owner(shard)
            if rec and rec.get("replica") and rec.get("addr"):
                addrs.setdefault(str(rec["replica"]), rec["addr"])
        out["replica_addrs"] = addrs
        return out

    def studies_status(self):
        """The replica's ``GET /studies`` body: every held shard's study
        table merged, and the fleet block."""
        with self._lock:
            scheds = dict(self.schedulers)
        studies, cohorts, tenant_stats = [], [], []
        n_slots = n_live = 0
        wal = None
        for shard in sorted(scheds):
            st = scheds[shard].studies_status()
            studies.extend(st["studies"])
            cohorts.extend(st["cohorts"])
            for c in st["cohorts"]:
                n_slots += c["n_slots"]
                n_live += c["n_live"]
            if st.get("wal"):
                wal = st["wal"]  # representative; /healthz has them all
            if st.get("tenants"):
                tenant_stats.append(st["tenants"])
        from ..algos import tpe

        out = {
            "ts": time.time(),
            "n_studies": len(studies),
            "slot_utilization": (n_live / n_slots) if n_slots else 0.0,
            "cohort_cache": tpe.cohort_cache_stats(),
            "cohorts": cohorts,
            "studies": studies,
            "draining": self._draining,
            "fleet": self.healthz(),
        }
        if tenant_stats:
            from ..obs.tenant import merge_status

            try:
                out["tenants"] = merge_status(tenant_stats)
            except Exception:  # noqa: BLE001 - fail-open roll-up
                pass
        if wal is not None:
            out["wal"] = wal
        return out
