"""Durable cross-process trial store + driver-side Trials backend
(counterpart of ``hyperopt_tpu/filestore.py``; the on-disk layout is the
reference's, so a store either package writes reads in the other).

Parity target: ``hyperopt/mongoexp.py`` (sym: MongoJobs ≈L150-500 — atomic
``reserve`` via find_one_and_update, ``new_trial_ids`` via counter doc;
MongoTrials ≈L500-800 — asynchronous=True, exp_key scoping, attachments).
The reference gets durability and single-claim semantics from MongoDB; here
both come from the filesystem, which a cluster's hosts already share via
NFS/GCS-fuse mounts:

* **Durability** — every trial document is its own pickle file; a crashed
  driver or worker loses nothing that was written.
* **Atomic claim** — claiming NEW→RUNNING is ``os.rename(new/<tid>.pkl,
  running/<tid>.pkl)``: POSIX rename is atomic, exactly one claimant wins
  (the ``find_one_and_update`` analog).  No daemon required.
* **Heartbeats & reclaim** — workers rewrite their RUNNING doc's
  ``refresh_time`` periodically (MongoWorker's heartbeat thread); anyone may
  move a RUNNING doc whose heartbeat is older than ``reserve_timeout`` back
  to NEW (stale-claim recovery, which upstream leaves as a manual query).
* **Counter** — trial ids come from a byte-length-encoded counter file under
  an ``fcntl`` lock (the atomic counter-doc increment).

Layout of a store directory::

    store/
      counter           monotonically increasing tid allocator (fcntl-locked)
      attachments/      named blobs: FMinIter_Domain is the cloudpickled Domain
      new/<tid>.pkl     queued trial documents
      running/<tid>.pkl claimed documents (owner, book_time, refresh_time set)
      done/<tid>.pkl    finished documents (result filled in)
      error/<tid>.pkl   crashed documents (misc['error'] set)

Workers are real processes: ``python -m hyperopt_tpu_torch.worker --store
DIR``, the ``hyperopt-mongo-worker`` analog — see ``worker.py``.
"""

from __future__ import annotations

import errno
import fcntl
import logging
import os
import pickle
import threading
import time

from . import chaos
from .exceptions import StoreFullError
from .retry import RetryPolicy
from .base import (
    JOB_STATE_CANCEL,
    JOB_STATE_DONE,
    JOB_STATE_ERROR,
    JOB_STATE_NEW,
    JOB_STATE_RUNNING,
    Trials,
    coarse_utcnow,
)
from .obs import get_metrics
from .obs.events import (
    TRIAL_CANCELLED,
    TRIAL_CLAIMED,
    TRIAL_FINISHED,
    TRIAL_HEARTBEAT,
    TRIAL_NEW,
    TRIAL_RECLAIMED,
    EventLog,
    FileEventSink,
    load_events,
)

__all__ = ["FileStore", "FileTrials", "ReserveTimeout", "StoreFullError",
           "new_run_id"]

logger = logging.getLogger(__name__)

#: "no space" errnos translated to the typed, retryable StoreFullError
_ENOSPC_ERRNOS = {errno.ENOSPC, getattr(errno, "EDQUOT", errno.ENOSPC)}

_STATE_DIRS = {
    JOB_STATE_NEW: "new",
    JOB_STATE_RUNNING: "running",
    JOB_STATE_DONE: "done",
    JOB_STATE_ERROR: "error",
    JOB_STATE_CANCEL: "cancel",
}


class ReserveTimeout(Exception):
    """No job could be reserved within the allotted time
    (hyperopt/mongoexp.py sym: ReserveTimeout)."""


# seconds below which a transition claim is assumed to be a LIVE in-flight
# transition regardless of the sweep's max_age (see _sweep_orphan_claims)
_CLAIM_GRACE = 5.0

# reserve-contention backoff: when a rename loses the
# claim race, back off a jittered-exponential beat before trying the next
# candidate instead of storming the directory — with many workers the old
# tight loop showed up as pure reserve.contention churn.  Micro-scale
# delays (1ms base, 50ms cap): contention means *other workers are making
# progress*, not that the store is down.
_RESERVE_BACKOFF = RetryPolicy(max_retries=0, base_delay=0.001,
                               max_delay=0.05, jitter=0.5)


def _atomic_write(path, payload: bytes):
    # deterministic fault injection (HYPEROPT_TPU_CHAOS ioerr@io:<p> /
    # enospc@io:<p>): every durable write in the store — docs,
    # heartbeats, attachments, checkpoints, fleet results — shares this
    # one failure point, which is exactly the surface a flaky
    # NFS/GCS-fuse mount (or a full disk) presents
    chaos.io_point("io")
    # pid AND thread id: two same-process threads writing the same target
    # (a heartbeat thread racing the claim path, concurrent reclaim+cancel)
    # would otherwise share one tmp name — the loser's os.replace then
    # crashes on the winner's already-consumed tmp file
    tmp = f"{path}.tmp.{_claim_suffix()}"
    try:
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)
    except OSError as e:
        _remove_quiet(tmp)
        if getattr(e, "errno", None) in _ENOSPC_ERRNOS:
            # typed + retryable: a full disk is a transient
            # STATE, not a store bug — the serving plane sheds with 507,
            # the worker/executor backs off and retries
            raise StoreFullError(
                e.errno, f"store write failed, disk full: {path}") from e
        raise


def _touch(path):
    """Reset a claim file's mtime to NOW.  ``os.rename`` preserves the
    source's mtime (the doc's last heartbeat write — arbitrarily old), and
    the orphan sweep ages claims by mtime; without the touch a LIVE
    finish/reclaim transition could be swept mid-flight."""
    try:
        os.utime(path, None)
    except FileNotFoundError:
        pass


def _remove_quiet(path):
    """Remove a claim, tolerating its theft by the orphan sweep (possible
    only if this process stalled longer than the sweep's max_age between
    rename and remove — the terminal doc is already written either way and
    state precedence dedupes)."""
    try:
        os.remove(path)
    except FileNotFoundError:
        pass


def _claim_suffix():
    """pid AND thread id: same-process threads (a heartbeat thread beside
    the worker loop, concurrent reclaim+cancel) would otherwise compute the
    SAME claim/tmp name for one trial, and ``os.rename`` silently clobbers
    an existing destination — one thread's live claim file would vanish
    under the other."""
    return f"{os.getpid()}.{threading.get_ident()}"


def new_run_id(prefix="run", unique_dir=None):
    """Auth-agnostic opaque run/study id: ``<prefix>-<12 hex>`` from
    ``os.urandom``.  Collision-safe across processes with no coordination
    (the ask/tell service mints study ids with this — the id doubles as
    the store subdirectory name when studies persist through a
    :class:`FileStore`), and unguessable enough that knowing one study's
    id never reveals a neighbor's.

    ``unique_dir`` makes the allocation collision-PROOF instead of
    merely collision-unlikely: the id is claimed by ``os.mkdir`` of
    ``<unique_dir>/<id>`` — atomic-exclusive on every filesystem the
    store runs on — and a lost race simply redraws.  N fleet replicas
    minting study ids against one shared store root use this; the
    claimed directory IS the study's store subdirectory, so the claim
    costs nothing extra."""
    import binascii

    for _ in range(64):
        run_id = f"{prefix}-{binascii.hexlify(os.urandom(6)).decode()}"
        if unique_dir is None:
            return run_id
        try:
            os.makedirs(unique_dir, exist_ok=True)
            os.mkdir(os.path.join(unique_dir, run_id))
            return run_id
        except FileExistsError:
            continue  # another replica drew the same 48 bits: redraw
    raise RuntimeError(
        f"could not mint a unique id under {unique_dir} in 64 draws "
        "(exhausted 48-bit space, or the directory is not writable)")


# the durable trial-lifecycle event log rides the attachments namespace so
# it shares the store's durability story and is readable as an attachment
_EVENTS_ATTACHMENT = "obs_events.jsonl"

# flight-recorder crash dumps ride the same namespace: one per dying
# process (driver or worker), named flight.<owner>.jsonl — a worker killed
# mid-trial leaves its last moments inside the store it was serving
_FLIGHT_PREFIX = "flight."


class FileStore:
    """Low-level durable job store (hyperopt/mongoexp.py sym: MongoJobs).

    Obs: every state transition (new/claimed/heartbeat/finished/cancelled/
    reclaimed) appends one line to the ``obs_events.jsonl`` attachment —
    O_APPEND writes, so driver and worker processes interleave whole
    records and a post-mortem survives every process on the store dying
    (``read_events()``).  Contention and reclaim counters land in the
    process-global "filestore" metrics namespace."""

    def __init__(self, root):
        self.root = str(root)
        for d in ("attachments", *_STATE_DIRS.values()):
            os.makedirs(os.path.join(self.root, d), exist_ok=True)
        counter = os.path.join(self.root, "counter")
        if not os.path.exists(counter):
            _atomic_write(counter, b"0")
        self.events = EventLog(sink=FileEventSink(
            os.path.join(self.root, "attachments", _EVENTS_ATTACHMENT)))
        self.metrics = get_metrics("filestore")
        self._sleep = time.sleep  # injectable for backoff tests

    def read_events(self):
        """The durable lifecycle log, parsed — every event any process on
        this store ever emitted (the post-mortem entry point)."""
        return load_events(
            os.path.join(self.root, "attachments", _EVENTS_ATTACHMENT))

    # -- flight-recorder dumps (obs/flight.py) ----------------------------

    def flight_dump_path(self, owner):
        """Attachment path for ``owner``'s crash dump (``:`` is swapped out
        so the hostname:pid owner string stays one path component)."""
        safe = str(owner).replace(":", "-").replace(os.sep, "-")
        return os.path.join(self.root, "attachments",
                            f"{_FLIGHT_PREFIX}{safe}.jsonl")

    def arm_flight(self, owner):
        """Arm the process-global flight recorder to dump into this store's
        attachments when THIS process dies (worker processes call this at
        startup — the store then holds the forensics for every process
        that ever served it).  Returns the dump path."""
        from .obs.flight import get_flight

        path = self.flight_dump_path(owner)
        get_flight().install(path)
        return path

    def read_flight_dumps(self):
        """``{owner: records}`` for every flight dump any process left in
        the store (render one with ``obs.report --postmortem <path>``)."""
        from .obs.trace import read_jsonl

        d = os.path.join(self.root, "attachments")
        out = {}
        for fname in sorted(os.listdir(d)):
            if (not fname.startswith(_FLIGHT_PREFIX)
                    or not fname.endswith(".jsonl")):
                continue
            owner = fname[len(_FLIGHT_PREFIX):-len(".jsonl")]
            out[owner] = read_jsonl(os.path.join(d, fname))
        return out

    # -- tid allocation (counter-doc analog) ------------------------------

    @staticmethod
    def _write_counter(f, old, value):
        """Overwrite the counter file ``f`` (holding the text ``old``) with
        ``value`` so that it never reads empty: the new digits, padded with
        spaces to the old length, land before the file is trimmed.  (The
        JAX package truncates first, so a process killed between its
        truncate and its write leaves an empty counter, which reads as 0:
        the next ask would reuse every id of the study.)"""
        text = str(value)
        f.seek(0)
        f.write(text.ljust(len(old)))
        f.flush()
        f.truncate(len(text))
        f.flush()
        os.fsync(f.fileno())

    def new_trial_ids(self, n):
        path = os.path.join(self.root, "counter")
        with open(path, "r+") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            try:
                old = f.read()
                start = int(old.strip() or "0")
                self._write_counter(f, old, start + n)
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)
        return list(range(start, start + n))

    def reset_counter(self, value):
        """Set the tid allocator to ``value``: down, to reclaim ids an ask
        consumed before dying un-journaled mid-wave (the TPE kernel keys
        per-trial PRNG streams off the id VALUE, so a counter gap would
        make every post-restart proposal diverge from the uninterrupted
        run the crash-resume pin compares against), and up when the
        counter reads below ``value`` (a counter a killed process left
        empty; the JAX package only clamps down).  Only safe when the
        caller owns the store exclusively (the service scheduler does;
        worker fleets never call this)."""
        path = os.path.join(self.root, "counter")
        value = int(value)
        with open(path, "r+") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            try:
                old = f.read()
                if value != int(old.strip() or "0"):
                    self._write_counter(f, old, value)
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)

    # -- attachments ------------------------------------------------------

    def set_attachment(self, name, blob: bytes):
        _atomic_write(os.path.join(self.root, "attachments", name), blob)

    def get_attachment(self, name):
        path = os.path.join(self.root, "attachments", name)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return f.read()

    def attachment_names(self):
        return sorted(os.listdir(os.path.join(self.root, "attachments")))

    # -- doc IO -----------------------------------------------------------

    def _path(self, state, tid):
        return os.path.join(self.root, _STATE_DIRS[state], f"{tid}.pkl")

    def write_doc(self, doc):
        """Write (or overwrite) a doc in the directory matching its state."""
        fresh = (doc["state"] == JOB_STATE_NEW
                 and not os.path.exists(self._path(JOB_STATE_NEW, doc["tid"])))
        _atomic_write(self._path(doc["state"], doc["tid"]), pickle.dumps(doc))
        if fresh:
            self.events.emit(TRIAL_NEW, doc["tid"])

    def settle(self, doc):
        """Write a TERMINAL doc and drop its superseded ``new``/``running``
        copies.  The ask/tell service's tell path: a served trial goes
        NEW → DONE without ever being worker-claimed, so the
        reserve/finish lifecycle (and its claim files) never applies —
        but leaving the stale ``new/`` copy behind would make every
        ``load_all`` lean on state precedence forever."""
        self.write_doc(doc)
        for state in (JOB_STATE_NEW, JOB_STATE_RUNNING):
            if state != doc["state"]:
                _remove_quiet(self._path(state, doc["tid"]))

    def _read(self, path):
        try:
            with open(path, "rb") as f:
                return pickle.loads(f.read())
        except (FileNotFoundError, EOFError, pickle.UnpicklingError):
            return None  # raced with a rename / partial write: skip this scan

    # residual cross-process races (e.g. a heartbeat re-creating running/
    # in the instant a cancel renames it away) can leave one tid in two
    # directories; readers resolve by precedence so a trial is never
    # double-counted.  DONE over CANCEL: if the work finished anyway,
    # keeping the result is strictly better than discarding it.
    _STATE_PRECEDENCE = {
        JOB_STATE_DONE: 4,
        JOB_STATE_ERROR: 3,
        JOB_STATE_CANCEL: 2,
        JOB_STATE_RUNNING: 1,
        JOB_STATE_NEW: 0,
    }

    def load_all(self):
        """Every doc in the store, state taken from its directory (a doc
        mid-rename can appear in neither — the next scan sees it).  A tid
        present in several directories yields ONE doc, by state precedence."""
        by_tid = {}
        for state, d in _STATE_DIRS.items():
            dirpath = os.path.join(self.root, d)
            for fname in os.listdir(dirpath):
                if not fname.endswith(".pkl"):
                    continue
                doc = self._read(os.path.join(dirpath, fname))
                if doc is None:
                    continue
                doc["state"] = state
                prev = by_tid.get(doc["tid"])
                if (prev is None or self._STATE_PRECEDENCE[state]
                        > self._STATE_PRECEDENCE[prev["state"]]):
                    by_tid[doc["tid"]] = doc
        return sorted(by_tid.values(), key=lambda d: d["tid"])

    def count(self, states):
        if isinstance(states, int):
            states = [states]
        total = 0
        for s in states:
            d = os.path.join(self.root, _STATE_DIRS[s])
            total += sum(1 for f in os.listdir(d) if f.endswith(".pkl"))
        return total

    # -- claim / finish (the Mongo find_one_and_update analog) ------------

    def reserve(self, owner):
        """Atomically claim one NEW job: rename into running/ (exactly one
        claimant can win the rename), then stamp owner/book_time.  Returns
        the claimed doc or None.

        Contention backs off: each lost rename sleeps a jittered
        exponentially-growing beat (1ms base, 50ms cap, deterministic in
        ``(owner, losses-so-far)``) before the next candidate, so N
        workers racing one burst of NEW docs de-synchronize instead of
        storming ``listdir``+``rename`` in lockstep.  The
        ``reserve.backoff_sec`` histogram is the tuning signal."""
        new_dir = os.path.join(self.root, "new")
        contention = 0
        for fname in sorted(os.listdir(new_dir)):
            if not fname.endswith(".pkl"):
                continue
            tid = fname[:-4]
            src = os.path.join(new_dir, fname)
            if self._settled(tid):
                # zombie NEW doc: an at-least-once reclaim raced a finish/
                # cancel that already settled this trial — remove instead of
                # re-running settled work
                _remove_quiet(src)
                continue
            dst = os.path.join(self.root, "running", fname)
            try:
                os.rename(src, dst)
            except FileNotFoundError:
                # another claimant won this one: the contention counter is
                # the store's "how many workers fight per job" signal
                self.metrics.counter("reserve.contention").inc()
                delay = _RESERVE_BACKOFF.delay(contention, key=str(owner))
                contention += 1
                self.metrics.histogram("reserve.backoff_sec").observe(delay)
                self._sleep(delay)
                continue
            doc = self._read(dst)
            if doc is None:
                continue
            now = coarse_utcnow()
            doc["state"] = JOB_STATE_RUNNING
            doc["owner"] = owner
            doc["book_time"] = now
            doc["refresh_time"] = now
            _atomic_write(dst, pickle.dumps(doc))
            self.metrics.counter("reserve.claims").inc()
            self.events.emit(TRIAL_CLAIMED, doc["tid"], owner=str(owner))
            return doc
        return None

    def _settled(self, tid):
        """True when a terminal doc (DONE/ERROR/CANCEL) exists for ``tid``.
        The shared zombie guard: heartbeat/reserve/reclaim/sweep all refuse
        to act on (or resurrect) a trial that has already settled — the
        at-least-once reclaim races can leave NEW/RUNNING leftovers beside a
        terminal doc, and re-running settled work both wastes evaluations
        and leaves duplicate files for precedence to hide."""
        return any(
            os.path.exists(self._path(s, tid))
            for s in (JOB_STATE_DONE, JOB_STATE_ERROR, JOB_STATE_CANCEL)
        )

    def heartbeat(self, doc):
        """Bump refresh_time on a RUNNING doc (MongoWorker heartbeat).
        A cancelled/finished trial is not resurrected: the write is skipped
        once the running file is gone (and the residual TOCTOU window is
        absorbed by ``load_all``'s state precedence)."""
        doc["refresh_time"] = coarse_utcnow()
        tid = doc["tid"]
        if self._settled(tid):
            return  # trial already settled: do not resurrect running/
        path = self._path(JOB_STATE_RUNNING, tid)
        if os.path.exists(path):
            _atomic_write(path, pickle.dumps(doc))
            self.events.emit(TRIAL_HEARTBEAT, tid,
                             owner=str(doc.get("owner")))

    def finish(self, doc, result=None, error=None):
        """RUNNING → DONE/ERROR.  Ownership of the transition is the running
        file itself: renaming it to a private name is the atomic claim.  If
        the rename fails, a concurrent ``cancel``/``reclaim_stale`` took the
        trial first — the result is dropped (returns False) rather than
        written alongside the other party's doc (which would double-count the
        tid in ``load_all``)."""
        tid = doc["tid"]
        run_path = self._path(JOB_STATE_RUNNING, tid)
        claim = f"{run_path}.finish.{_claim_suffix()}"
        try:
            os.rename(run_path, claim)
        except FileNotFoundError:
            self.metrics.counter("finish.dropped").inc()
            logger.warning(
                "trial %s was cancelled/reclaimed before finish; dropping %s",
                tid, "error" if error is not None else "result")
            return False
        _touch(claim)  # claim age = NOW, not the doc's last heartbeat write
        if self._settled(tid):
            # the running file we claimed was a zombie (a heartbeat-TOCTOU
            # resurrection after a concurrent cancel/finish settled the
            # trial): drop this result rather than writing a SECOND
            # terminal doc beside the first
            _remove_quiet(claim)
            self.metrics.counter("finish.dropped").inc()
            logger.warning(
                "trial %s already settled; dropping duplicate %s",
                tid, "error" if error is not None else "result")
            return False
        doc["refresh_time"] = coarse_utcnow()
        if error is not None:
            doc["state"] = JOB_STATE_ERROR
            doc["misc"]["error"] = (str(type(error)), str(error))
        else:
            doc["state"] = JOB_STATE_DONE
            doc["result"] = result
        self.write_doc(doc)
        _remove_quiet(claim)
        sec = None
        if doc.get("book_time") is not None:
            sec = (doc["refresh_time"] - doc["book_time"]).total_seconds()
        self.events.emit(TRIAL_FINISHED, tid,
                         status="error" if error is not None else "ok",
                         sec=sec, owner=str(doc.get("owner")))
        return True

    def reclaim_stale(self, reserve_timeout, to_cancel=False):
        """Move RUNNING docs whose heartbeat is older than reserve_timeout
        seconds back to NEW (worker died mid-trial) — or, with
        ``to_cancel=True``, to CANCEL instead of retrying (the SparkTrials
        timeout→JOB_STATE_CANCEL policy for jobs that must not be re-run;
        the orphan sweep honors the same policy).  Also sweeps aged
        claim-file orphans (see ``_sweep_orphan_claims``) and prunes
        duplicate TERMINAL docs (see ``_prune_terminal_duplicates``).
        Returns count of reclaimed docs (stale RUNNING + recovered
        orphans)."""
        n = self._sweep_orphan_claims(reserve_timeout, to_cancel=to_cancel)
        self._prune_terminal_duplicates()
        run_dir = os.path.join(self.root, "running")
        target = JOB_STATE_CANCEL if to_cancel else JOB_STATE_NEW
        for fname in os.listdir(run_dir):
            if not fname.endswith(".pkl"):
                continue
            path = os.path.join(run_dir, fname)
            doc = self._read(path)
            if doc is None or doc.get("refresh_time") is None:
                continue
            if self._settled(doc["tid"]):
                # zombie RUNNING file beside a terminal doc (a heartbeat
                # TOCTOU resurrection): delete it — a concurrent finish
                # loses its rename and drops the duplicate result, which is
                # the documented contract
                _remove_quiet(path)
                continue
            age = (coarse_utcnow() - doc["refresh_time"]).total_seconds()
            if age < reserve_timeout:
                continue
            # claim the transition by renaming the running file away first;
            # losing the rename means the worker finished (or another
            # reclaimer won) in the meantime — skip, don't duplicate
            claim = f"{path}.reclaim.{_claim_suffix()}"
            try:
                os.rename(path, claim)
            except FileNotFoundError:
                continue
            _touch(claim)
            doc["state"] = target
            doc["owner"] = None
            _atomic_write(self._path(target, doc["tid"]), pickle.dumps(doc))
            _remove_quiet(claim)
            self.metrics.counter("reclaims.stale").inc()
            self.events.emit(TRIAL_RECLAIMED, doc["tid"],
                             heartbeat_age_sec=age,
                             target=_STATE_DIRS[target])
            logger.warning("reclaimed stale trial %s (heartbeat %.0fs old) -> %s",
                           doc["tid"], age, _STATE_DIRS[target])
            n += 1
        return n

    def _prune_terminal_duplicates(self):
        """Remove precedence-loser duplicates among TERMINAL docs.

        The ``_settled`` guards are check-then-write: a ``finish`` and a
        ``cancel`` acting on different zombie copies of one tid can both
        pass their check in the same instant and both write a terminal doc.
        ``load_all``'s precedence already hides the loser from every
        reader; this pass makes the store physically CONVERGE to one doc
        per trial (a fresh write can transiently recreate the race — the
        next reclaim prunes again)."""
        best = {}
        # descending precedence: the first state a tid is seen in wins
        for s in (JOB_STATE_DONE, JOB_STATE_ERROR, JOB_STATE_CANCEL):
            d = os.path.join(self.root, _STATE_DIRS[s])
            for fname in os.listdir(d):
                if not fname.endswith(".pkl"):
                    continue
                tid = fname[:-4]
                if tid in best:
                    logger.warning(
                        "pruning duplicate terminal doc %s/%s (kept %s)",
                        _STATE_DIRS[s], fname, _STATE_DIRS[best[tid]])
                    _remove_quiet(os.path.join(d, fname))
                else:
                    best[tid] = s

    def _sweep_orphan_claims(self, max_age, to_cancel=False):
        """Recover claim files orphaned by a crash mid-transition.

        ``finish``/``reclaim_stale``/``cancel`` all rename the source doc to
        a private ``*.pkl.{finish,reclaim,cancel}.<pid>.<tid>`` claim before
        writing the terminal doc; a crash in that window leaves a claim file
        that ``load_all`` ignores (doesn't end in ``.pkl``) — the trial
        would vanish from every state and the driver would wait until its
        fmin timeout.  A claim is recovered once
        older than ``max(max_age, _CLAIM_GRACE)`` seconds (60 s for
        sweep-private files) — live transitions ``_touch`` their claim at
        creation, so claim mtime measures claim age, not the doc's last
        heartbeat, and the grace floor keeps a zero/short ``max_age`` from
        stealing a LIVE in-flight transition.  Readable finish/reclaim claims
        go back to NEW for re-evaluation (at-least-once semantics — same
        policy as stale-heartbeat reclaim), or to CANCEL under
        ``to_cancel=True`` (the must-not-re-run policy); cancel claims
        always complete their interrupted transition to CANCEL; unreadable
        ones are removed with a warning (there is no doc left to preserve).
        Returns the number of docs recovered."""
        n = 0
        now = time.time()
        for state_dir in _STATE_DIRS.values():
            dirpath = os.path.join(self.root, state_dir)
            for fname in os.listdir(dirpath):
                if ".pkl." not in fname or ".tmp." in fname:
                    continue
                kind = fname.split(".pkl.", 1)[1].split(".", 1)[0]
                if kind not in ("finish", "reclaim", "cancel"):
                    continue
                path = os.path.join(dirpath, fname)
                try:
                    age = now - os.path.getmtime(path)
                except FileNotFoundError:
                    continue  # another sweeper got it
                # LIVENESS GRACE: a transition claim is _touch()ed at
                # creation and completes in milliseconds, so a claim younger
                # than the grace window is almost certainly a LIVE
                # transition, whatever ``max_age`` says — stealing it would
                # let the victim's unconditional terminal write race the
                # recovery into a duplicated trial (found by the randomized
                # storm test at reserve_timeout=0).  A >grace mid-transition
                # stall still loses this protection; that residue is the
                # same zombie-writer hazard Mongo's stale-reclaim accepts.
                # Sweep-private files get a larger floor: same reasoning,
                # one more indirection.
                floor = max(max_age,
                            60.0 if ".sweep." in fname else _CLAIM_GRACE)
                if age < floor:
                    continue
                # claim the claim: rename to a sweep-private name so two
                # concurrent sweepers can't both recover the same doc
                mine = f"{path}.sweep.{_claim_suffix()}"
                try:
                    os.rename(path, mine)
                except FileNotFoundError:
                    continue
                # rename preserves the source mtime (the ALREADY-AGED claim
                # time) — without the touch, the 60s in-flight floor above
                # would measure the original claim's age and a concurrent
                # sweeper could still steal this file mid-transition
                _touch(mine)
                doc = self._read(mine)
                if doc is None:
                    logger.warning("removing unreadable orphan claim %s", fname)
                    _remove_quiet(mine)
                    continue
                if self._settled(doc["tid"]):
                    # the interrupted transition already completed (its
                    # terminal doc exists): the claim is a leftover, not a
                    # lost trial — recovering it to NEW would re-run settled
                    # work and leave a duplicate doc behind
                    _remove_quiet(mine)
                    continue
                if kind == "cancel" or to_cancel:
                    target = JOB_STATE_CANCEL
                    doc.setdefault("result", {})
                    doc["result"]["status"] = "fail"
                    doc["refresh_time"] = coarse_utcnow()
                else:
                    target = JOB_STATE_NEW
                    doc["owner"] = None
                doc["state"] = target
                _atomic_write(self._path(target, doc["tid"]), pickle.dumps(doc))
                _remove_quiet(mine)
                self.metrics.counter("reclaims.orphan").inc()
                self.events.emit(TRIAL_RECLAIMED, doc["tid"],
                                 orphan_kind=kind, claim_age_sec=age,
                                 target=_STATE_DIRS[target])
                logger.warning(
                    "recovered orphaned %s claim for trial %s (%.0fs old) -> %s",
                    kind, doc["tid"], age, _STATE_DIRS[target])
                n += 1
        return n

    def cancel(self, tid):
        """Move one NEW or RUNNING doc to CANCEL (SparkTrials job-group
        cancellation analog).  The source file is renamed away FIRST (the
        atomic claim — same idiom as ``reserve``/``finish``), so a worker
        that finishes concurrently loses the rename race and drops its
        result instead of writing a duplicate doc.  Returns True if a doc
        was cancelled."""
        for state in (JOB_STATE_NEW, JOB_STATE_RUNNING):
            src = self._path(state, tid)
            claim = f"{src}.cancel.{_claim_suffix()}"
            try:
                os.rename(src, claim)
            except FileNotFoundError:
                continue
            _touch(claim)
            if self._settled(tid):
                # the claimed file was a zombie copy (an at-least-once
                # reclaim raced the transition that settled this trial):
                # nothing to cancel, and writing CANCEL would duplicate the
                # existing terminal doc
                _remove_quiet(claim)
                return False
            doc = self._read(claim)
            if doc is None:
                # do NOT delete: the read may have raced a partial write.
                # Leave the claim for _sweep_orphan_claims, which recovers
                # it (or removes it if truly unreadable) once aged —
                # removing here would permanently destroy the trial doc
                #.
                logger.warning(
                    "cancel(%s): claim unreadable, leaving %s for orphan sweep",
                    tid, os.path.basename(claim))
                continue
            doc["state"] = JOB_STATE_CANCEL
            doc.setdefault("result", {})
            doc["result"]["status"] = "fail"
            doc["refresh_time"] = coarse_utcnow()
            _atomic_write(self._path(JOB_STATE_CANCEL, tid), pickle.dumps(doc))
            _remove_quiet(claim)
            self.metrics.counter("cancels").inc()
            self.events.emit(TRIAL_CANCELLED, tid,
                             from_state=_STATE_DIRS[state])
            return True
        return False

    # -- store hygiene (the space-pressure degrade rung) -------------------

    def gc(self, tmp_max_age=300.0, flight_max_age=7 * 86400.0):
        """Bounded garbage collection: reclaim bytes that are provably
        redundant without touching any live trial state.

        * ``new``/``running`` copies SUPERSEDED by a terminal doc (the
          tell path settles NEW→DONE and drops them eagerly, but a
          crash between the write and the drop leaves them for state
          precedence to hide forever);
        * precedence-loser terminal duplicates
          (:meth:`_prune_terminal_duplicates`);
        * ``*.tmp.*`` atomic-write leftovers of dead writers, once
          older than ``tmp_max_age`` (a LIVE write's tmp file exists
          for milliseconds);
        * flight-recorder crash dumps older than ``flight_max_age``
          (forensics age out; ``*.quarantined`` evidence never does).

        Returns ``{reclaimed_bytes, removed}``.  Every removal is
        tolerant of concurrent writers — losing a race to a path that
        vanished is a no-op, exactly like the claim machinery."""
        stats = {"reclaimed_bytes": 0, "removed": 0}

        def rm(path):
            try:
                size = os.path.getsize(path)
                os.remove(path)
            except OSError:
                return
            stats["removed"] += 1
            stats["reclaimed_bytes"] += size

        now = time.time()
        self._prune_terminal_duplicates()
        for state in (JOB_STATE_NEW, JOB_STATE_RUNNING):
            d = os.path.join(self.root, _STATE_DIRS[state])
            for fname in os.listdir(d):
                if fname.endswith(".pkl") and self._settled(fname[:-4]):
                    rm(os.path.join(d, fname))
        for d in ("attachments", *_STATE_DIRS.values()):
            dirpath = os.path.join(self.root, d)
            for fname in os.listdir(dirpath):
                if ".tmp." not in fname:
                    continue
                path = os.path.join(dirpath, fname)
                try:
                    if now - os.path.getmtime(path) > tmp_max_age:
                        rm(path)
                except OSError:
                    continue
        att = os.path.join(self.root, "attachments")
        for fname in os.listdir(att):
            if (fname.startswith(_FLIGHT_PREFIX)
                    and fname.endswith(".jsonl")):
                path = os.path.join(att, fname)
                try:
                    if now - os.path.getmtime(path) > flight_max_age:
                        rm(path)
                except OSError:
                    continue
        if stats["removed"]:
            self.metrics.counter("gc.removed").inc(stats["removed"])
            self.metrics.counter("gc.reclaimed_bytes").inc(
                stats["reclaimed_bytes"])
        return stats


class FileTrials(Trials):
    """Driver-side Trials over a FileStore (mongoexp.py sym: MongoTrials).

    ``asynchronous=True``: the driver inserts NEW docs and polls; separate
    worker *processes* (``python -m hyperopt_tpu_torch.worker``) evaluate
    them.  ``device`` is where the driver's history and suggesters live:
    the CUDA card unless ``device="cpu"``.  Docs are
    updated in place on refresh so the incremental padded-history fold (and
    its out-of-order pending set) keeps working across process boundaries.
    """

    asynchronous = True
    poll_interval_secs = 0.1

    def __init__(self, root, exp_key=None, refresh=True, device=None):
        self.store = FileStore(root)
        self._docs_by_tid = {}
        super().__init__(exp_key=exp_key, refresh=refresh, device=device)

    @property
    def attachments(self):
        return _StoreAttachments(self.store)

    @attachments.setter
    def attachments(self, value):
        for k, v in dict(value).items():
            self.store.set_attachment(k, _to_bytes(v))

    def refresh(self):
        for doc in self.store.load_all():
            mine = self._docs_by_tid.get(doc["tid"])
            if mine is None:
                self._docs_by_tid[doc["tid"]] = doc
                self._dynamic_trials.append(doc)
            elif doc["state"] != mine["state"] or doc["state"] == JOB_STATE_RUNNING:
                mine.update(doc)  # in place: history folding tracks identity
        super().refresh()

    def insert_trial_doc(self, doc):
        doc = dict(doc)
        self.store.write_doc(doc)
        if doc["tid"] not in self._docs_by_tid:
            self._docs_by_tid[doc["tid"]] = doc
            self._dynamic_trials.append(doc)
        return doc["tid"]

    def insert_trial_docs(self, docs):
        return [self.insert_trial_doc(d) for d in docs]

    def new_trial_ids(self, n):
        return self.store.new_trial_ids(n)

    def count_by_state_unsynced(self, arg):
        return self.store.count(arg)

    def checkpoint_trial(self, doc):
        """Ctrl.checkpoint hook: write the RUNNING doc (with its partial
        result) through to the store, so a worker crash after a checkpoint
        loses only the work since that checkpoint (MongoCtrl.checkpoint
        analog).  Reuses the heartbeat write path: atomic, skipped if the
        trial was cancelled/finished meanwhile."""
        self.store.heartbeat(doc)

    def cancel_unfinished(self):
        """NEW/RUNNING → CANCEL in the store (FMinIter calls this when its
        timeout expires so a dead/hung worker can't wedge the driver)."""
        for state in (JOB_STATE_NEW, JOB_STATE_RUNNING):
            d = os.path.join(self.store.root, _STATE_DIRS[state])
            for fname in os.listdir(d):
                if fname.endswith(".pkl"):
                    self.store.cancel(int(fname[:-4]))
        self.refresh()

    def delete_all(self):
        import shutil

        shutil.rmtree(self.store.root)
        self.store = FileStore(self.store.root)
        self._docs_by_tid = {}
        self._dynamic_trials = []
        self._ids = set()
        self._history = None
        self._history_synced = 0
        self._history_pending = []
        self.refresh()

    def __getstate__(self):
        state = super().__getstate__()
        state.pop("attachments", None)  # lives in the store, not the pickle
        return state


def _to_bytes(v):
    if isinstance(v, (bytes, bytearray)):
        return bytes(v)
    import cloudpickle

    return cloudpickle.dumps(v)


class _StoreAttachments:
    """Dict-like view over the store's attachment blobs (GridFS analog)."""

    def __init__(self, store):
        self._store = store

    def __contains__(self, k):
        return self._store.get_attachment(k) is not None

    def __getitem__(self, k):
        blob = self._store.get_attachment(k)
        if blob is None:
            raise KeyError(k)
        return blob

    def get(self, k, default=None):
        blob = self._store.get_attachment(k)
        return default if blob is None else blob

    def __setitem__(self, k, v):
        self._store.set_attachment(k, _to_bytes(v))

    def keys(self):
        return self._store.attachment_names()
