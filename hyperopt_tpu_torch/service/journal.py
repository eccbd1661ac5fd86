"""Write-ahead journal for the ask/tell service (counterpart of
``hyperopt_tpu/service/journal.py``, copied: host-only).
The record schema is the JAX package's field for field, so a journal
either package writes resumes in the other.

The scheduler's in-memory state — which studies exist, where each study's
seed stream is, which asks were issued — dies with the process; even with
``--store`` (per-study :class:`~hyperopt_tpu_torch.filestore.FileTrials`) a
restart forgets every live study.  The journal closes that gap with the
cheapest durable structure that works on the filesystems a cluster's hosts
actually mount (NFS / GCS-fuse): an append-only JSONL file under the
store root, read back through the torn-line-tolerant
:func:`~hyperopt_tpu_torch.obs.trace.iter_jsonl` (a half-written final line —
the normal crash artifact — is skipped, never fatal).

Record kinds (one JSON object per line; every record carries ``kind``
and ``sid``)::

    admit     {spec, seed, kwargs}            study admitted (spec is the
                                              JSON-wire space schema, or
                                              {"zoo": name})
    ask       {tids, seed, algo}              an ask was SERVED: the ids it
                                              issued, the suggest seed it
                                              drew, and the algo that
                                              produced the docs ("tpe",
                                              "rand" for startup/degraded)
    tell      {tid, loss, status}             one result reported
    close     {}                              study closed by the client
    snapshot  {spec, seed, kwargs, rstate,    compaction record: the
               n_asked, n_told, state}        study's registry entry + RNG
                                              position; its trials live in
                                              the FileStore
    quarantine {reason}                       the study's journal state was
                                              found corrupt:
                                              410 on ask/tell until the
                                              operator intervenes

Integrity: every appended/rewritten line carries a CRC32C
suffix field (``"c":"<hex>"`` over the canonical record bytes — see
``service/integrity.py``); replay classifies each line as ok /
torn-tail / corrupt-mid-file through ``integrity.iter_checked_jsonl``
and the scheduler quarantines per study instead of failing the boot.
Pre-journals (no ``c`` field) replay unchanged, pinned
bitwise.  ENOSPC on append/fsync raises the typed, retryable
:class:`JournalFullError` (HTTP 507 + store-full shed).

Ordering and idempotency (the replay argument): records
append in the order the scheduler applied them, and studies are
independent — a study's proposals depend only on its own ask/tell
history.  Replay therefore walks the journal once, per record:

* ``admit``/``snapshot`` re-create the study (bypassing the admission
  quota — resumed studies are grandfathered; the quota is admission
  control for NEW work, not an excuse to drop journaled state);
* ``ask`` advances the study's seed stream by exactly one draw and
  re-lands any doc the store does not already hold, regenerated through
  the SAME code path that served it (the determinism pins make the
  regenerated docs bit-identical — the exactly-once argument the fleet
  uses for duplicate shard publishes);
* ``tell`` applies only if the trial is not already DONE — a duplicate
  (journaled AND settled into the store before the crash) is skipped,
  never double-applied.

fsync is batched per wave: ask records flush+fsync once at the end of
the wave that served them (before any asker unblocks), tell records
before the tell returns.  Compaction (:meth:`StudyJournal.rewrite`)
replaces the file atomically (tmp + ``os.replace``) with one
``snapshot`` record per live study; it runs only when the scheduler has
a store (without one the ask records ARE the trial data) and only at
quiescent points (no wave in flight — a snapshot taken after a pending
ask's seed draw but before its ask record would replay that draw twice).
"""

from __future__ import annotations

import json
import logging
import os
import time

from .. import chaos
from . import integrity
from .integrity import StoreFullError

__all__ = ["StudyJournal", "JournalError", "JournalFullError",
           "JournalCorruptError", "wal_path_for"]

logger = logging.getLogger(__name__)

#: journal file name under a store root (``wal_path_for``)
WAL_BASENAME = "service.wal.jsonl"

#: suffix a quarantined journal segment is renamed under (evidence —
#: never replayed, never GC'd, readable by scrub and post-mortems)
QUARANTINE_SUFFIX = ".quarantined"


class JournalError(OSError):
    """The journal could not be written.  Raised back through the serving
    path so the failed request errors (client retries) instead of the
    scheduler advancing past state the journal never captured."""


class JournalFullError(JournalError, StoreFullError):
    """The journal write failed with ENOSPC.  Both a
    :class:`JournalError` (every existing handler keeps working) and a
    :class:`~hyperopt_tpu_torch.exceptions.StoreFullError` (the serving path
    answers a typed, retryable 507 and arms the store-full shed)."""


class JournalCorruptError(JournalError):
    """A compaction refused to run because the chain it would discard
    holds records that fail checksum verification — rewriting would
    launder the corruption into the only surviving copy.  The old chain
    is kept; scrub/resume quarantine the affected studies."""


def wal_path_for(store_root):
    """The default journal location for a scheduler persisting into
    ``store_root`` (the WAL shares the store's durability story)."""
    return os.path.join(str(store_root), WAL_BASENAME)


_METRICS = None


def _metrics():
    """Lazy process-global service registry for the journal's chaos
    sites, so injected wal faults/corruptions land in /metrics (the
    smoke gate's ground truth for '100% of injections detected')."""
    global _METRICS
    if _METRICS is None:
        from ..obs.metrics import get_metrics

        _METRICS = get_metrics("service")
    return _METRICS


def _fsync_dir(path):
    """fsync the DIRECTORY holding ``path``.  ``os.replace`` makes the
    compacted journal visible atomically, but on ext4-ordered (and most
    journaled) mounts the rename itself is only durable once the parent
    directory entry is flushed — a crash right after the replace could
    otherwise resurrect the pre-compaction journal, whose stale records
    would replay draws the snapshot already accounts for.  Best-effort:
    some filesystems refuse O_RDONLY fsync on directories; losing the
    directory flush there degrades to the older ordering, never
    to an error on the serving path."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class StudyJournal:
    """Append-side + replay-side of the WAL.  Not thread-safe by itself —
    the scheduler already serializes every mutation under its lock, and
    the journal is only touched there."""

    def __init__(self, path, checksum=True):
        self.path = str(path)
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._fh = None
        self._dirty = False
        # checksummed records: every appended/rewritten line
        # carries the CRC32C suffix field.  Off only for the bench's
        # overhead baseline and back-compat pins — production journals
        # are always sealed.
        self.checksum = bool(checksum)
        self.appends = 0
        self.syncs = 0
        self.compactions = 0

    # -- append side -------------------------------------------------------

    def _handle(self):
        if self._fh is None:
            self._fh = open(self.path, "ab")
        return self._fh

    def _line(self, rec):
        if self.checksum:
            return (integrity.seal(rec) + "\n").encode("utf-8")
        return (json.dumps(rec, sort_keys=True,
                           separators=(",", ":")) + "\n").encode("utf-8")

    @staticmethod
    def _raise_typed(what, e):
        if integrity.is_enospc(e):
            raise JournalFullError(
                e.errno, f"journal {what} failed, disk full: {e}") from e
        raise JournalError(f"journal {what} failed: {e}") from e

    def append(self, rec):
        """One record onto the journal, handed to the kernel at once (a
        killed process loses no appended record; :meth:`sync` is the
        durability point against a lost machine).  The JAX package keeps
        records in the process's buffer until the sync, so a replica
        killed between an ask's append and the wave's sync left the ask's
        landed docs in the store with no record: the adopter then served
        the next ask one id past them.  Any OSError surfaces as
        :class:`JournalError` — ENOSPC as the retryable
        :class:`JournalFullError` — so the serving path fails THIS
        request instead of silently losing the record."""
        try:
            chaos.io_point("wal", _metrics())
            # the chaos 'corrupt' site: the write SUCCEEDS but the
            # medium lies — exactly the fault class the checksum
            # exists to catch
            data = chaos.corrupt_bytes("wal", self._line(rec),
                                       _metrics())
            fh = self._handle()
            fh.write(data)
            fh.flush()
        except OSError as e:
            self._drop_handle()
            self._raise_typed("append", e)
        self._dirty = True
        self.appends += 1

    def sync(self):
        """Flush + fsync everything appended since the last sync (the
        batched per-wave durability point)."""
        if not self._dirty or self._fh is None:
            return
        try:
            self._fh.flush()
            os.fsync(self._fh.fileno())
        except OSError as e:
            self._drop_handle()
            self._raise_typed("fsync", e)
        self._dirty = False
        self.syncs += 1

    def _drop_handle(self):
        fh, self._fh = self._fh, None
        self._dirty = False
        if fh is not None:
            try:
                fh.close()
            except OSError:
                pass

    def close(self):
        try:
            self.sync()
        finally:
            self._drop_handle()

    # -- replay / compaction side -----------------------------------------

    def records(self):
        """Every verified record, in append order, with the checksum
        field stripped.  Torn tails (the crash artifact batched fsync
        allows) are skipped as always; CORRUPT lines are skipped WITH a
        warning — callers that must react per-study (the scheduler's
        quarantine, scrub) read :meth:`checked_records` instead."""
        for chk in self.checked_records():
            if chk.status in (integrity.OK, integrity.UNCHECKED):
                yield chk.rec
            elif chk.status == integrity.CORRUPT:
                logger.warning(
                    "%s:%d: CORRUPT journal record (checksum/framing "
                    "failure mid-file) skipped by an unchecked reader",
                    self.path, chk.lineno)

    def checked_records(self):
        """Every line, classified (:class:`~hyperopt_tpu_torch.service
        .integrity.Checked`): ok / unchecked (unsealed) / corrupt /
        torn.  The scheduler's resume and the scrub tool drive their
        quarantine decisions from this."""
        if not os.path.exists(self.path):
            return
        yield from integrity.iter_checked_jsonl(self.path)

    def size_bytes(self):
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def rewrite(self, records, verify_old=True):
        """Atomically replace the journal with ``records`` (compaction).
        The append handle reopens on the next :meth:`append`, so a
        concurrent-append-after-compact lands in the NEW file.

        Two integrity refusals:

        * with ``verify_old`` the existing chain is checksum-verified
          first; a corrupt record aborts (:class:`JournalCorruptError`)
          keeping the old chain, so scrub/resume still see the
          evidence and quarantine precisely;
        * the freshly-written snapshot is re-read and re-verified
          before the ``os.replace`` — a write the disk corrupted in
          flight aborts the same way instead of becoming the journal.
        """
        try:
            chaos.io_point("wal", _metrics())
        except OSError as e:
            self._raise_typed("compaction", e)
        if verify_old and self.checksum and os.path.exists(self.path):
            for chk in integrity.iter_checked_jsonl(self.path):
                if chk.status == integrity.CORRUPT:
                    raise JournalCorruptError(
                        f"{self.path}:{chk.lineno}: corrupt record in "
                        "the chain compaction would discard; keeping "
                        "the old chain (quarantine via resume/scrub)")
        self._drop_handle()
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                for rec in records:
                    f.write(self._line(rec))
                f.flush()
                os.fsync(f.fileno())
            if self.checksum:
                for chk in integrity.iter_checked_jsonl(tmp):
                    if chk.status != integrity.OK:
                        raise JournalCorruptError(
                            f"{tmp}:{chk.lineno}: compaction snapshot "
                            "failed re-read verification; keeping the "
                            "old chain")
            os.replace(tmp, self.path)
        except OSError as e:
            try:
                os.remove(tmp)
            except OSError:
                pass
            if isinstance(e, JournalError):
                raise
            self._raise_typed("compaction", e)
        # the rename is durable only once the parent directory entry is
        # too
        _fsync_dir(self.path)
        self.compactions += 1

    def quarantine_segment(self, reason):
        """Move this journal FILE aside as evidence: rename
        to ``<path>.quarantined`` (suffixed with a counter if one
        already exists), append a sealed reason record to the renamed
        file, fsync the directory.  The live path is then free — the
        caller rewrites it from the healthy replayed state (or the
        next append recreates it).  Returns the quarantine path, or
        None when there was nothing to rename."""
        self._drop_handle()
        if not os.path.exists(self.path):
            return None
        qpath = self.path + QUARANTINE_SUFFIX
        n = 1
        while os.path.exists(qpath):
            qpath = f"{self.path}{QUARANTINE_SUFFIX}.{n}"
            n += 1
        try:
            os.replace(self.path, qpath)
            with open(qpath, "ab") as f:
                f.write((integrity.seal({
                    "kind": "quarantine_reason", "reason": str(reason),
                    "path": self.path, "ts": time.time()}) + "\n")
                    .encode("utf-8"))
                f.flush()
                os.fsync(f.fileno())
        except OSError as e:
            logger.warning("could not quarantine journal segment %s: %s",
                           self.path, e)
            return None
        _fsync_dir(self.path)
        logger.warning("journal segment quarantined: %s -> %s (%s)",
                       self.path, qpath, reason)
        return qpath

    # -- record constructors (one place owns the schema) -------------------

    # ``trace`` is the request-trace id that caused the
    # record — pure metadata for the per-study audit timeline.  Replay
    # NEVER reads it (unknown fields were always ignored), so journals
    # written before the field existed — and journals written with
    # tracing disarmed — resume bit-identically (pinned by test).

    @staticmethod
    def admit_rec(study_id, spec, seed, kwargs, trace=None):
        rec = {"kind": "admit", "sid": study_id, "spec": spec,
               "seed": int(seed), "kwargs": dict(kwargs), "ts": time.time()}
        if trace is not None:
            rec["trace"] = str(trace)
        return rec

    @staticmethod
    def ask_rec(study_id, tids, seed, algo, trace=None, req=None):
        rec = {"kind": "ask", "sid": study_id,
               "tids": [int(t) for t in tids], "seed": int(seed),
               "algo": str(algo), "ts": time.time()}
        if trace is not None:
            rec["trace"] = str(trace)
        if req is not None:
            # the client's ask-idempotency token: replay
            # rebuilds the served-request map from it so a retried ask
            # answers the same tids across crashes and shard migrations
            rec["req"] = str(req)
        return rec

    @staticmethod
    def tell_rec(study_id, tid, loss, status, trace=None):
        rec = {"kind": "tell", "sid": study_id, "tid": int(tid),
               "loss": None if loss is None else float(loss),
               "status": status, "ts": time.time()}
        if trace is not None:
            rec["trace"] = str(trace)
        return rec

    @staticmethod
    def close_rec(study_id, trace=None):
        rec = {"kind": "close", "sid": study_id, "ts": time.time()}
        if trace is not None:
            rec["trace"] = str(trace)
        return rec

    @staticmethod
    def quarantine_rec(study_id, reason):
        """Durable per-study quarantine marker: replay marks
        the study quarantined (410 on ask/tell, listed in ``/studies``)
        without touching any other study — the resume-twice idempotence
        of the corruption path rides on this record."""
        return {"kind": "quarantine", "sid": study_id,
                "reason": str(reason), "ts": time.time()}

    @staticmethod
    def snapshot_rec(study):
        """Compaction record for one study: registry entry + exact RNG
        position (``numpy`` Generator state is a JSON-clean dict of
        bigints) so replay resumes the seed stream mid-flight."""
        rec = {
            "kind": "snapshot", "sid": study.study_id,
            "spec": study.space_spec, "seed": study.seed,
            "kwargs": study.admit_kwargs,
            "rstate": study.rstate.bit_generator.state,
            "n_asked": study.n_asked, "n_told": study.n_told,
            "state": study.state, "ts": time.time(),
        }
        if study.served_reqs:
            # compaction must not break ask idempotency: the retry
            # window spans a drain/migration (pre-field snapshots
            # replay fine — the map just starts empty)
            rec["served"] = dict(study.served_reqs)
        return rec
