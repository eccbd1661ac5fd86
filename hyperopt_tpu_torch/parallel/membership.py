"""Leased work shards: elastic generation ownership over a shared filesystem
(counterpart of ``hyperopt_tpu/parallel/membership.py``, with the same
on-disk layout, so a store either package writes is read by the other).

Parity target: the MongoWorker/SparkTrials durability role of
``hyperopt/mongoexp.py`` §L4 — N processes racing to claim work items from
one durable store — applied to the SPMD driver's *generation shards*
instead of individual trial docs.  ``fmin_multihost``'s collective path
buckets trials positionally (``j % process_count == process_index``), which
welds fleet membership to the ``torch.distributed`` process group: one
controller lost mid-generation leaves every survivor waiting in an
all-gather.  This module moves generation ownership into
filestore-style **leases** so membership becomes elastic:

* a generation's ``B`` trials split into ``n_shards`` fixed shards —
  trial ``j`` belongs to shard ``j % n_shards``, and its id re-buckets
  deterministically from ``(seed, generation, shard)`` alone: the shard
  structure is pinned in the run params, NOT derived from the fleet size,
  so a fleet of any size (including a resumed fleet of a *different*
  size) evaluates the identical trial→shard map and folds the identical
  history;
* a controller **claims** a shard by exclusive-create of a lease file
  (the ``os.rename`` atomic-claim idiom of ``filestore.reserve``, with
  ``O_EXCL`` in place of rename because there is no source doc to move);
* the claim is **heartbeated** by mtime while the shard evaluates, and a
  lease older than ``lease_ttl`` with no published result is **reclaimed**
  by any survivor (rename-to-private-name first, so two reclaimers cannot
  double-free — the same claim-the-claim discipline as
  ``filestore._sweep_orphan_claims``);
* the shard's **result** is published by one atomic write; result
  presence is the terminal state.  Because proposals and evaluation are
  deterministic, a lost-lease double evaluation publishes byte-identical
  blobs — at-least-once execution composes with last-write-wins into
  exactly-once *semantics*, no fencing needed.

Layout under a store root (the store's ``attachments/`` also collects
flight dumps from every controller via ``FileStore.arm_flight``, so a
killed controller's last moments stay readable through
``FileStore.read_flight_dumps()``)::

    <root>/fleet/
      params.json            run params, write-once (joiners verify equality)
      members/<owner>        membership heartbeat files (mtime = liveness)
      gen00000/
        shard3.lease         exclusive-create claim; mtime heartbeat
        shard3.result.pkl    published result rows (atomic write, terminal)
        checksum.<owner>     per-controller fold digest (divergence audit)

Clocks: lease/member aging uses file **mtime** (wall clock — the only
clock processes on a shared filesystem share; same tradeoff as
``filestore`` heartbeats), while every in-process wait uses monotonic
deadlines.  Fake-clock tests age leases with ``os.utime``.
"""

from __future__ import annotations

import json
import logging
import os
import time

from ..filestore import FileStore, _atomic_write, _claim_suffix
from ..obs import get_metrics

__all__ = ["FleetMembership", "EpochLeases", "shard_trials",
           "n_occupied_shards", "publish_params_once", "rotate_for_owner"]

logger = logging.getLogger(__name__)

_FLEET_DIR = "fleet"
_MEMBERS_DIR = "members"
_LEASE_SUFFIX = ".lease"
_RESULT_SUFFIX = ".result.pkl"


def shard_trials(B, n_shards, shard):
    """Global batch positions owned by ``shard`` in a ``B``-trial
    generation: ``{j : j % n_shards == shard}``.  The trial id of position
    ``j`` in generation ``g`` is ``g * batch + j`` — both maps depend only
    on pinned run params, never on fleet size (the re-bucketing
    invariant)."""
    return [j for j in range(int(B)) if j % int(n_shards) == int(shard)]


def n_occupied_shards(B, n_shards):
    """How many shards of a ``B``-trial generation are non-empty (a short
    final generation occupies only the first ``B`` shards)."""
    return min(int(n_shards), int(B))


def _safe(owner):
    return str(owner).replace(":", "-").replace(os.sep, "-")


def publish_params_once(path, params, what="store"):
    """Write-once params file: the first caller publishes ``params`` at
    ``path`` atomically-exclusively, every later caller verifies
    equality.  Atomic-exclusive publish: write a private tmp
    COMPLETELY, then ``os.link`` it into place — exactly one linker
    wins, and a loser (or any concurrent joiner) can only ever read a
    fully-written file.  A bare O_EXCL-create-then-write would let a
    simultaneous joiner read the empty/partial file and die on a false
    params mismatch.  Returns True for the first writer, False for a
    verified joiner; raises ValueError on a mismatch (params are
    write-once — every joiner must present identical params)."""
    blob = json.dumps(params, sort_keys=True, default=str)
    tmp = f"{path}.tmp.{_claim_suffix()}"
    with open(tmp, "w") as f:
        f.write(blob)
    try:
        os.link(tmp, path)
        return True
    except FileExistsError:
        with open(path) as f:
            existing = f.read()
        if existing != blob:
            raise ValueError(
                f"{what} was created with params {existing}; this "
                f"process has {blob} — every joiner must present "
                "identical params")
        return False
    finally:
        try:
            os.remove(tmp)
        except FileNotFoundError:
            pass


def rotate_for_owner(items, owner):
    """Deterministic per-owner rotation of ``items`` so concurrent
    claimers start at different offsets (less contention) while any
    single survivor still visits every item.  Stable across processes
    for one owner; NOT Python ``hash()`` (salted)."""
    items = list(items)
    if not items:
        return items
    h = sum(ord(c) for c in str(owner)) % len(items)
    return items[h:] + items[:h]


class FleetMembership:
    """One controller's handle on the lease plane of a fleet store."""

    def __init__(self, root, owner=None, lease_ttl=15.0, metrics=None,
                 member_ttl=None):
        self.store = FileStore(root)
        self.owner = owner or f"{os.uname().nodename}:{os.getpid()}"
        self.lease_ttl = float(lease_ttl)
        self.member_ttl = float(member_ttl if member_ttl is not None
                                else max(3 * self.lease_ttl, self.lease_ttl))
        self.metrics = metrics if metrics is not None else get_metrics("fleet")
        self._fleet = os.path.join(self.store.root, _FLEET_DIR)
        os.makedirs(os.path.join(self._fleet, _MEMBERS_DIR), exist_ok=True)
        self._held = set()  # (gen, shard) leases this member currently holds

    # -- run params (write-once, joiners verify) --------------------------

    def ensure_params(self, params):
        """First member writes ``params.json``; every later (or resumed,
        possibly differently-sized) fleet must present IDENTICAL params —
        the lease plane's analog of the checkpoint run-params check, and
        the guard behind bitwise replay at any fleet size."""
        return publish_params_once(
            os.path.join(self._fleet, "params.json"), params,
            what=f"fleet store {self.store.root}")

    # -- membership records (observability; liveness by mtime) ------------

    def _member_path(self, owner=None):
        return os.path.join(self._fleet, _MEMBERS_DIR,
                            _safe(owner or self.owner))

    def join(self):
        """Register this controller (and arm its flight recorder into the
        store, so a chaos kill leaves forensics behind)."""
        _atomic_write(self._member_path(),
                      json.dumps({"owner": self.owner,
                                  "joined": time.time()}).encode())
        self.store.arm_flight(self.owner)
        self.metrics.counter("fleet.joins").inc()
        self.metrics.gauge("fleet.members").set(len(self.live_members()))

    def heartbeat_member(self):
        try:
            os.utime(self._member_path(), None)
        except FileNotFoundError:  # swept or never joined: re-join
            _atomic_write(self._member_path(),
                          json.dumps({"owner": self.owner,
                                      "joined": time.time()}).encode())

    def leave(self):
        try:
            os.remove(self._member_path())
        except FileNotFoundError:
            pass
        self.metrics.gauge("fleet.members").set(len(self.live_members()))

    def live_members(self):
        """Owners whose member record heartbeated within ``member_ttl``
        (a dead controller simply ages out — leaving is optional)."""
        d = os.path.join(self._fleet, _MEMBERS_DIR)
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

    # -- shard leases ------------------------------------------------------

    def _gen_dir(self, gen):
        path = os.path.join(self._fleet, f"gen{int(gen):05d}")
        os.makedirs(path, exist_ok=True)
        return path

    def _lease_path(self, gen, shard):
        return os.path.join(self._gen_dir(gen),
                            f"shard{int(shard)}{_LEASE_SUFFIX}")

    def _result_path(self, gen, shard):
        return os.path.join(self._gen_dir(gen),
                            f"shard{int(shard)}{_RESULT_SUFFIX}")

    def try_claim(self, gen, shard):
        """Atomically claim one shard: ``O_CREAT|O_EXCL`` — exactly one
        creator wins (the ``reserve`` rename analog).  A shard whose
        result already exists is never claimed."""
        if os.path.exists(self._result_path(gen, shard)):
            return False
        path = self._lease_path(gen, shard)
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            self.metrics.counter("lease.contention").inc()
            return False
        with os.fdopen(fd, "w") as f:
            f.write(f"{self.owner}\n{time.time()}\n")
        self._held.add((int(gen), int(shard)))
        self.metrics.counter("lease.claims").inc()
        return True

    def heartbeat_shard(self, gen, shard):
        """Refresh a held lease's mtime (called between trial evaluations;
        a lease older than ``lease_ttl`` is fair game for reclaim).  The
        touch is best-effort: a reclaimed-from-under-us lease means a
        survivor took over — our eventual publish is byte-identical."""
        try:
            os.utime(self._lease_path(gen, shard), None)
            self.metrics.counter("lease.heartbeats").inc()
        except FileNotFoundError:
            pass

    def lease_mtimes(self, gen, shards):
        """Current lease mtime per shard (None when unleased) — the fleet
        barrier's liveness signal: an advancing mtime means a live holder
        is heartbeating through a long evaluation and the barrier must
        keep waiting rather than degrade."""
        out = []
        for s in shards:
            try:
                out.append(os.path.getmtime(self._lease_path(gen, s)))
            except FileNotFoundError:
                out.append(None)
        return out

    def release(self, gen, shard):
        self._held.discard((int(gen), int(shard)))
        try:
            os.remove(self._lease_path(gen, shard))
        except FileNotFoundError:
            pass

    def reclaim_stale(self, gen, n_shards):
        """Free leases older than ``lease_ttl`` whose shard has no result
        (the holder died mid-evaluation, or stalled past the TTL — either
        way a survivor may re-run the shard; determinism makes the re-run
        idempotent).  Claim-the-claim first: rename to a private name so
        two concurrent reclaimers cannot both free one lease.  Returns the
        number of shards freed."""
        n = 0
        now = time.time()
        for shard in range(int(n_shards)):
            path = self._lease_path(gen, shard)
            if os.path.exists(self._result_path(gen, shard)):
                # published: the lease (if any) is a leftover, not a claim
                if os.path.exists(path):
                    self.release(gen, shard)
                continue
            try:
                age = now - os.path.getmtime(path)
            except FileNotFoundError:
                continue
            if age < self.lease_ttl:
                continue
            mine = f"{path}.reclaim.{_claim_suffix()}"
            try:
                os.rename(path, mine)
            except FileNotFoundError:
                continue  # another reclaimer (or the holder's release) won
            try:
                with open(mine) as f:
                    dead_owner = f.readline().strip()
            except OSError:
                dead_owner = "?"
            os.remove(mine)
            n += 1
            self.metrics.counter("lease.reclaims").inc()
            logger.warning(
                "reclaimed stale shard lease gen=%s shard=%s (holder %s, "
                "%.1fs old)", gen, shard, dead_owner, age)
            self.store.events.emit(
                "shard_reclaimed", f"g{gen}s{shard}", gen=int(gen),
                shard=int(shard), holder=dead_owner, age_sec=age)
        return n

    # -- shard results (terminal state) ------------------------------------

    def publish(self, gen, shard, blob):
        """Atomically publish a shard's result and drop the lease.  Safe
        under duplicate evaluation: deterministic evaluation ⇒ identical
        ``blob`` ⇒ last-write-wins is a no-op."""
        _atomic_write(self._result_path(gen, shard), blob)
        self.metrics.counter("shard.published").inc()
        self.release(gen, shard)

    def read_result(self, gen, shard):
        path = self._result_path(gen, shard)
        try:
            with open(path, "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def missing_shards(self, gen, n_shards):
        """Occupied shards of ``gen`` that have no published result yet."""
        gen_dir = self._gen_dir(gen)
        have = {fname for fname in os.listdir(gen_dir)
                if fname.endswith(_RESULT_SUFFIX)}
        return [s for s in range(int(n_shards))
                if f"shard{s}{_RESULT_SUFFIX}" not in have]

    def claim_order(self, shards):
        """Deterministic per-owner rotation of ``shards`` so a fleet's
        members start claiming at different offsets (less contention)
        while any single survivor still visits every shard."""
        return rotate_for_owner(shards, self.owner)

    # -- divergence audit --------------------------------------------------

    def write_checksum(self, gen, digest_hex):
        _atomic_write(os.path.join(self._gen_dir(gen),
                                   f"checksum.{_safe(self.owner)}"),
                      str(digest_hex).encode())

    def read_checksums(self, gen):
        """{owner: digest} for every controller that folded ``gen``."""
        d = self._gen_dir(gen)
        out = {}
        for fname in sorted(os.listdir(d)):
            if not fname.startswith("checksum."):
                continue
            try:
                with open(os.path.join(d, fname)) as f:
                    out[fname[len("checksum."):]] = f.read().strip()
            except OSError:
                continue
        return out


# ---------------------------------------------------------------------------
# long-lived epoch leases
# ---------------------------------------------------------------------------


class EpochLeases:
    """Long-lived, epoch-fenced leases over one directory — the
    generalization of the per-generation shard lease above for ownership
    that OUTLIVES any single unit of work (the serving fleet's
    study-shard keyspace).  Three differences from the ``gen/shard``
    lease:

    * **no terminal state** — there is no ``result.pkl`` that retires a
      lease; ownership ends only by explicit :meth:`release` or by
      stale :meth:`reclaim`;
    * **a durable per-name epoch counter** — every successful claim
      bumps ``<name>.epoch`` (atomically, under the just-won ``O_EXCL``
      exclusivity, so bumps never race) and the claim returns the new
      epoch.  The epoch is the fencing token downstream state is named
      by: the serving fleet writes one WAL file per (shard, epoch), so
      a reclaimed-from-under-us holder's late appends land in a file no
      replay will ever read — journals never interleave;
    * **owner-verified mutation** — :meth:`heartbeat` and
      :meth:`release` verify the lease body still names THIS owner and
      epoch before touching the file, so a holder that lost its lease
      to reclaim can never refresh (or free) the new holder's claim.

    The claim/reclaim discipline itself is unchanged: ``O_CREAT|O_EXCL``
    claim (exactly one creator wins), mtime heartbeat, rename-first
    stale reclaim (claim-the-claim — two reclaimers cannot double-free).
    Clocks follow the module convention: aging uses file mtime (the
    only clock a shared filesystem gives every process), fake-clock
    tests age leases with ``os.utime``.
    """

    def __init__(self, root, owner, lease_ttl=15.0, metrics=None):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self.owner = str(owner)
        self.lease_ttl = float(lease_ttl)
        self.metrics = metrics if metrics is not None else get_metrics("fleet")
        self.held = {}  # name -> epoch this owner currently holds

    def _lease_path(self, name):
        return os.path.join(self.root, f"{name}{_LEASE_SUFFIX}")

    def _epoch_path(self, name):
        return os.path.join(self.root, f"{name}.epoch")

    def read_epoch(self, name):
        """The last epoch ever claimed for ``name`` (0 = never)."""
        try:
            with open(self._epoch_path(name)) as f:
                return int(f.read().strip() or 0)
        except (OSError, ValueError):
            return 0

    def holder(self, name):
        """The lease body ``{owner, epoch, ts}`` of ``name``'s current
        claim, or None (unleased / torn mid-claim)."""
        try:
            with open(self._lease_path(name)) as f:
                rec = json.loads(f.read())
            return rec if isinstance(rec, dict) else None
        except (OSError, ValueError):
            return None

    def try_claim(self, name):
        """Atomically claim ``name``: exactly one ``O_EXCL`` creator
        wins and gets the bumped epoch back (None = lost the race).
        The epoch bump is serialized BY the claim itself — nobody else
        can win the O_EXCL while this lease file exists, and reclaim
        renames it away before the next claim — so epochs are strictly
        monotonic per name across any claim/crash/reclaim history."""
        path = self._lease_path(name)
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            self.metrics.counter("lease.contention").inc()
            return None
        epoch = self.read_epoch(name) + 1
        _atomic_write(self._epoch_path(name), str(epoch).encode())
        with os.fdopen(fd, "w") as f:
            f.write(json.dumps({"owner": self.owner, "epoch": epoch,
                                "ts": time.time()}))
        self.held[name] = epoch
        self.metrics.counter("lease.claims").inc()
        return epoch

    def verify_held(self, name):
        """True while the on-disk lease still names this owner at the
        epoch it claimed.  False means the lease was reclaimed (or
        released) from under us — the caller must stop serving the
        name; its epoch-named state is already fenced off."""
        want = self.held.get(name)
        if want is None:
            return False
        rec = self.holder(name)
        if (rec is None or rec.get("owner") != self.owner
                or rec.get("epoch") != want):
            self.held.pop(name, None)
            return False
        return True

    def heartbeat(self, name):
        """Refresh a held lease's mtime; returns False (and forgets the
        hold) when the lease was reclaimed from under us — unlike the
        gen/shard lease, a long-lived holder MUST notice, because it is
        still serving."""
        if not self.verify_held(name):
            return False
        try:
            os.utime(self._lease_path(name), None)
            self.metrics.counter("lease.heartbeats").inc()
        except FileNotFoundError:
            self.held.pop(name, None)
            return False
        return True

    def release(self, name):
        """Drop a held lease (the graceful-drain path).  Owner-verified:
        releasing a lease someone else re-claimed would free THEIR
        ownership.  The verify-then-remove pair is not atomic — a holder
        stalled PAST the TTL could, in the instant between the two,
        lose a reclaim race and delete the next claimant's file; the
        epoch fence self-heals it (the claimant's next verification
        fails and the shard re-adopts one epoch later), and making it
        atomic would need a cross-process lock on every lease op."""
        if not self.verify_held(name):
            return False
        self.held.pop(name, None)
        try:
            os.remove(self._lease_path(name))
        except FileNotFoundError:
            pass
        return True

    def reclaim(self, names):
        """Free leases older than ``lease_ttl`` (holder stopped
        heartbeating: dead, or stalled past the TTL — its epoch fences
        its late writes either way).  Rename-first, exactly as
        :meth:`FleetMembership.reclaim_stale`: two concurrent reclaimers
        free each lease at most once.  Returns the freed names — the
        caller claims them (bumping the epoch) before adopting any
        state."""
        freed = []
        now = time.time()
        for name in names:
            path = self._lease_path(name)
            try:
                age = now - os.path.getmtime(path)
            except FileNotFoundError:
                continue
            if age < self.lease_ttl:
                continue
            mine = f"{path}.reclaim.{_claim_suffix()}"
            try:
                os.rename(path, mine)
            except FileNotFoundError:
                continue  # another reclaimer (or the holder) won
            try:
                with open(mine) as f:
                    dead = (json.loads(f.read() or "{}") or {}).get(
                        "owner", "?")
            except (OSError, ValueError):
                dead = "?"
            os.remove(mine)
            freed.append(name)
            self.metrics.counter("lease.reclaims").inc()
            logger.warning("reclaimed stale epoch lease %s (holder %s, "
                           "%.1fs old)", name, dead, age)
        return freed

    def unleased(self, names):
        """The subset of ``names`` with no live lease file (claimable)."""
        return [n for n in names
                if not os.path.exists(self._lease_path(n))]
