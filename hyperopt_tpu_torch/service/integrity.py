"""Storage-integrity plane (counterpart of
``hyperopt_tpu/service/integrity.py``, copied: host-only): checksummed
self-validating records, corruption classification, disk-watermark
monitoring and bounded store GC.  The record format is the JAX
package's byte for byte, so either package verifies what the other
sealed.

Every durability guarantee the serving plane makes — bit-identical
crash-resume, epoch-WAL migration, census pre-warming — assumes the
filesystem under the store root is healthy.  Records parsed with
``json.loads`` alone cannot tell a mid-file bit-flip (failing NVMe, NFS
cache corruption, a torn compaction rewrite) from the benign torn tail
a crash leaves, and a full disk would turn the WAL append at the
durability point into an unrecoverable crash loop.  This module is the
shared vocabulary every store surface now speaks:

* **Sealed records** — :func:`seal` serializes a record canonically
  (``sort_keys``, compact separators) and splices a CRC32C suffix field
  ``"c":"<8 hex>"`` computed over the canonical bytes WITHOUT the
  field; :func:`verify_obj` pops ``c``, re-serializes and compares.
  Canonical-JSON round-tripping makes the check writer-independent:
  ``json.loads`` then ``json.dumps(sort_keys, separators)`` reproduces
  the exact bytes for any JSON-clean record (Python floats repr
  shortest-round-trip), so the verifier needs no framing beyond the
  line itself.  Records written before sealing existed simply lack ``c`` and
  classify ``unchecked`` — replayed byte-identically, never rejected.

* **Classification, not parsing** — :func:`iter_checked_jsonl`
  generalizes :func:`~hyperopt_tpu_torch.obs.trace.iter_jsonl`: every line
  classifies as ``ok`` (checksum verified), ``unchecked``
  (unsealed, no ``c``), ``corrupt`` (parseable-with-bad-checksum
  anywhere, or unparseable MID-file) or ``torn`` (unparseable FINAL
  line — the normal crash artifact batched fsync allows, skipped as
  always).  The distinction is the whole point: a torn tail is
  expected and survivable; a corrupt middle means the medium lied and
  the affected study must be quarantined, not silently mis-replayed.

* **ENOSPC as a typed, retryable state** — :func:`is_enospc` maps
  ``ENOSPC``/``EDQUOT`` to
  :class:`~hyperopt_tpu_torch.exceptions.StoreFullError`;
  :class:`DiskWatermark` polls ``statvfs`` (cached, scrape-time +
  per-wave) and publishes ``store.free_bytes`` / ``store.used_frac``
  gauges; :func:`gc_store_root` is the degrade rung's bounded GC:
  settle-superseded doc copies, stale tmp files, expired flight dumps
  and ancestor epoch WALs already compacted by adoption.

The scrub tool (``python -m hyperopt_tpu_torch.service.scrub``) walks a
whole store root through these primitives offline; the journal, fleet
ownership table and census ride :func:`seal`/:func:`verify_obj` on
their write paths.
"""

from __future__ import annotations

import errno
import json
import logging
import os
import re
import time
from collections import namedtuple

from ..exceptions import StoreFullError

__all__ = [
    "OK", "UNCHECKED", "CORRUPT", "TORN",
    "Checked", "StoreFullError",
    "crc32c", "seal", "seal_obj", "verify_obj",
    "iter_checked_jsonl", "salvage_sid", "is_enospc",
    "DiskWatermark", "gc_store_root",
]

logger = logging.getLogger(__name__)

#: line classifications (iter_checked_jsonl)
OK = "ok"                #: checksummed and verified
UNCHECKED = "unchecked"  #: parseable, no ``c`` field (unsealed)
CORRUPT = "corrupt"      #: bad checksum, or unparseable mid-file
TORN = "torn"            #: unparseable FINAL line (crash artifact)

#: one classified JSONL line: ``rec`` is the parsed record with ``c``
#: popped (None when unparseable), ``raw`` the line text
Checked = namedtuple("Checked", ["rec", "status", "lineno", "raw"])

#: the checksum field name — reserved in every sealed record
CHECKSUM_FIELD = "c"


# ---------------------------------------------------------------------------
# CRC32C (Castagnoli) — hardware-friendly polynomial, software table here
# ---------------------------------------------------------------------------

_CRC_TABLE = None
_accel = None  # optional C implementation, resolved once


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE is None:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def _resolve_accel():
    """Use a C crc32c if the environment happens to ship one (the wire
    format is identical); fall back to the table loop.  Resolved once —
    never a hard dependency."""
    global _accel
    if _accel is None:
        _accel = False
        for mod in ("google_crc32c", "crc32c"):
            try:
                m = __import__(mod)
                fn = getattr(m, "value", None) or getattr(m, "crc32c", None)
                if fn is not None and fn(b"123456789") == 0xE3069283:
                    _accel = fn
                    break
            except Exception:  # noqa: BLE001 - optional accel only
                continue
    return _accel


def crc32c(data, crc=0):
    """CRC32C (Castagnoli, reflected poly 0x1EDC6F41) of ``data``.
    ``crc32c(b"123456789") == 0xE3069283`` (the RFC 3720 check value,
    pinned by test)."""
    fn = _resolve_accel()
    if fn:
        return fn(bytes(data)) if crc == 0 else _crc_soft(data, crc)
    return _crc_soft(data, crc)


def _crc_soft(data, crc=0):
    table = _crc_table()
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# ---------------------------------------------------------------------------
# sealed records
# ---------------------------------------------------------------------------


def _canonical(rec):
    return json.dumps(rec, sort_keys=True, separators=(",", ":"))


def seal(rec):
    """One canonical JSONL line (no newline) for ``rec`` with the CRC32C
    suffix field spliced in: ``{...,"c":"<8 hex>"}``.  The checksum
    covers the canonical serialization WITHOUT the field, so a verifier
    pops ``c``, re-serializes and compares — no side framing."""
    if CHECKSUM_FIELD in rec:
        raise ValueError(f"record already carries {CHECKSUM_FIELD!r}: "
                         f"double-sealing would break verification")
    body = _canonical(rec)
    c = format(crc32c(body.encode("utf-8")), "08x")
    if body == "{}":
        return '{"c":"%s"}' % c
    return f'{body[:-1]},"{CHECKSUM_FIELD}":"{c}"}}'


def seal_obj(rec):
    """Dict form of :func:`seal` for single-object JSON files (the fleet
    ownership table): returns a copy of ``rec`` with ``c`` added."""
    body = _canonical(rec)
    out = dict(rec)
    out[CHECKSUM_FIELD] = format(crc32c(body.encode("utf-8")), "08x")
    return out


#: the checksum as :func:`seal` writes it: 8 lowercase hex digits
_SEAL_VALUE = re.compile(r"[0-9a-f]{8}")
#: the tail :func:`seal` splices onto a line, with its key damaged in place:
#: a one-character key other than ``c`` over 8 hex digits
_DAMAGED_SEAL = re.compile(r',"[^"c]":"[0-9a-fA-F]{8}"\}$')


def verify_obj(rec):
    """Classify one PARSED record: pops ``c`` in place and returns
    :data:`OK` / :data:`UNCHECKED` / :data:`CORRUPT`.  A checksum that is
    not 8 lowercase hex digits is corrupt: :func:`seal` never writes one
    (an upper-case digit is a flipped bit)."""
    c = rec.pop(CHECKSUM_FIELD, None)
    if c is None:
        return UNCHECKED
    if not isinstance(c, str) or not _SEAL_VALUE.fullmatch(c):
        return CORRUPT
    have = crc32c(_canonical(rec).encode("utf-8"))
    return OK if have == int(c, 16) else CORRUPT


def iter_checked_jsonl(path):
    """Stream ``path`` one classified line at a time (:class:`Checked`).

    Classification: a parseable line with a verifying ``c`` is ``ok``;
    parseable without ``c`` is ``unchecked`` (unsealed back-compat
    — replayed unchanged); parseable with a failing ``c`` is
    ``corrupt`` wherever it sits (a torn write essentially never yields
    complete JSON with a present-but-wrong checksum — that is the
    medium flipping bits); an UNPARSEABLE line is ``torn`` on the final
    line (the crash artifact batched fsync allows) and ``corrupt``
    anywhere else (records are whole lines — a mid-file fragment means
    data was destroyed after it was durable).  Empty lines are skipped
    like :func:`~hyperopt_tpu_torch.obs.trace.iter_jsonl` always did.

    Streams with a ONE-line lag (only the final line needs the
    is-this-the-tail lookahead) — a multi-GB WAL or event stream is
    never materialized wholesale, the contract ``iter_jsonl`` always
    kept.

    A parseable line whose sealed tail lost its ``c`` key to a flipped
    bit (``,"b":"<8 hex>"}``) is ``corrupt``, not ``unchecked``: every
    single-bit flip of a sealed line is detected (ROADMAP queue 3, item
    17)."""
    def classify(lineno, line, is_last):
        try:
            rec = json.loads(line)
        except ValueError:
            rec = None
        if not isinstance(rec, dict):
            # unparseable, or a bare scalar/list this plane never wrote
            return Checked(None, TORN if is_last else CORRUPT,
                           lineno, line)
        status = verify_obj(rec)
        if status == UNCHECKED and _DAMAGED_SEAL.search(line):
            status = CORRUPT
        return Checked(rec, status, lineno, line)

    with open(path, encoding="utf-8", errors="replace") as f:
        prev = None  # (lineno, stripped line)
        for lineno, raw in enumerate(f, 1):
            line = raw.strip()
            if not line:
                continue
            if prev is not None:
                yield classify(prev[0], prev[1], False)
            prev = (lineno, line)
        if prev is not None:
            yield classify(prev[0], prev[1], True)


_SID_RE = re.compile(r'"sid"\s*:\s*"([^"\\]{1,128})"')


def salvage_sid(raw):
    """Best-effort study-id extraction from a corrupt (possibly
    JSON-broken) line, so a bit-flip that destroys the framing can
    still be attributed to ONE study instead of failing the whole
    resume.  Returns None when nothing salvageable."""
    m = _SID_RE.search(raw or "")
    return m.group(1) if m else None


# ---------------------------------------------------------------------------
# ENOSPC / disk-watermark plane
# ---------------------------------------------------------------------------

_ENOSPC_ERRNOS = {errno.ENOSPC, getattr(errno, "EDQUOT", errno.ENOSPC)}


def is_enospc(exc):
    """True when ``exc`` is the filesystem saying "no space" (ENOSPC,
    or EDQUOT — a quota is just a smaller disk)."""
    return (isinstance(exc, OSError)
            and getattr(exc, "errno", None) in _ENOSPC_ERRNOS)


class DiskWatermark:
    """Cached ``statvfs`` monitor over a store root.

    ``threshold`` arms the low-space decision: a value below 1.0 is a
    minimum FREE FRACTION, a value >= 1.0 a minimum free BYTE count;
    ``None`` disarms the decision (sampling still publishes gauges).
    ``sample()`` is cheap enough for the per-wave hot path: the real
    ``statvfs`` runs at most once per ``poll_sec`` (scrape time forces
    a fresh read with ``force=True``)."""

    def __init__(self, root, threshold=None, poll_sec=1.0,
                 clock=time.monotonic, statvfs=os.statvfs, metrics=None):
        self.root = str(root)
        self.threshold = threshold
        self.poll_sec = float(poll_sec)
        self._clock = clock
        self._statvfs = statvfs
        self.metrics = metrics
        self._last = None       # cached sample dict
        self._last_ts = None

    def sample(self, force=False):
        """The current disk state ``{free_bytes, total_bytes, used_frac,
        free_frac, low}`` — or None when ``statvfs`` itself fails (a
        dead mount is an I/O problem, not a full disk)."""
        now = self._clock()
        if (not force and self._last is not None
                and now - self._last_ts < self.poll_sec):
            return self._last
        try:
            st = self._statvfs(self.root)
        except OSError:
            return self._last
        total = st.f_blocks * st.f_frsize
        free = st.f_bavail * st.f_frsize
        free_frac = (free / total) if total else 1.0
        out = {
            "free_bytes": int(free),
            "total_bytes": int(total),
            "used_frac": 1.0 - free_frac,
            "free_frac": free_frac,
            "low": self._is_low(free, free_frac),
        }
        self._last, self._last_ts = out, now
        if self.metrics is not None:
            self.metrics.gauge("store.free_bytes").set(float(free))
            self.metrics.gauge("store.used_frac").set(1.0 - free_frac)
        return out

    def _is_low(self, free_bytes, free_frac):
        t = self.threshold
        if t is None or t <= 0:
            return False
        return free_frac < t if t < 1.0 else free_bytes < t


# ---------------------------------------------------------------------------
# bounded store GC (the space-pressure degrade rung)
# ---------------------------------------------------------------------------

_EPOCH_RE = re.compile(r"^e(\d+)\..+\.jsonl$")


def _first_record_kind(path):
    try:
        with open(path, encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    return None
                return rec.get("kind") if isinstance(rec, dict) else None
    except OSError:
        return None
    return None


def _rm_sized(path, stats):
    try:
        size = os.path.getsize(path)
        os.remove(path)
    except OSError:
        return
    stats["removed"] += 1
    stats["reclaimed_bytes"] += size


def gc_store_root(root, limit_dirs=None, tmp_max_age=300.0,
                  flight_max_age=7 * 86400.0, metrics=None):
    """Bounded store hygiene under a serving root — the degrade rung the
    disk watermark triggers BEFORE any shed.  Reclaims only what is
    provably redundant:

    * per-study :class:`~hyperopt_tpu_torch.filestore.FileStore` GC
      (settle-superseded ``new``/``running`` copies, precedence-loser
      terminal duplicates, stale ``*.tmp.*``, expired flight dumps) for
      every subdirectory that IS a store (has a ``counter`` file) — up
      to ``limit_dirs`` of them, oldest-modified first;
    * stale ``*.tmp.*`` atomic-write leftovers at the root itself;
    * ancestor epoch WALs under ``fleet/wal/shard*/`` whose NEWEST
      epoch file is snapshot-led (the adoption compaction that makes
      ancestors redundant — a crash between that compaction and the
      ancestor delete leaves exactly this state).

    ``*.quarantined`` files are never touched — they are evidence.
    Returns ``{reclaimed_bytes, removed, dirs_swept}``."""
    from ..filestore import FileStore

    stats = {"reclaimed_bytes": 0, "removed": 0, "dirs_swept": 0}
    root = str(root)
    try:
        entries = sorted(os.listdir(root))
    except OSError:
        return stats
    now = time.time()

    # root-level stale tmp files (atomic-write leftovers of dead writers)
    for fname in entries:
        if ".tmp." not in fname:
            continue
        path = os.path.join(root, fname)
        try:
            if os.path.isfile(path) and now - os.path.getmtime(path) \
                    > tmp_max_age:
                _rm_sized(path, stats)
        except OSError:
            continue

    # per-study store GC, oldest-modified dirs first, bounded
    store_dirs = []
    for fname in entries:
        d = os.path.join(root, fname)
        if os.path.isfile(os.path.join(d, "counter")):
            try:
                store_dirs.append((os.path.getmtime(d), d))
            except OSError:
                continue
    store_dirs.sort()
    if limit_dirs is not None:
        store_dirs = store_dirs[: int(limit_dirs)]
    for _, d in store_dirs:
        try:
            sub = FileStore(d).gc(tmp_max_age=tmp_max_age,
                                  flight_max_age=flight_max_age)
        except OSError:
            continue
        stats["dirs_swept"] += 1
        stats["removed"] += sub["removed"]
        stats["reclaimed_bytes"] += sub["reclaimed_bytes"]

    # ancestor epoch WALs already made redundant by adoption compaction
    wal_root = os.path.join(root, "fleet", "wal")
    if os.path.isdir(wal_root):
        for shard in sorted(os.listdir(wal_root)):
            d = os.path.join(wal_root, shard)
            try:
                names = os.listdir(d)
            except OSError:
                continue
            epochs = sorted(
                (int(m.group(1)), os.path.join(d, n))
                for n in names for m in [_EPOCH_RE.match(n)] if m)
            for fname in names:
                if ".tmp." in fname:
                    path = os.path.join(d, fname)
                    try:
                        if now - os.path.getmtime(path) > tmp_max_age:
                            _rm_sized(path, stats)
                    except OSError:
                        pass
            if len(epochs) < 2:
                continue
            if _first_record_kind(epochs[-1][1]) in ("snapshot",
                                                     "quarantine"):
                for _, path in epochs[:-1]:
                    _rm_sized(path, stats)

    if metrics is not None:
        metrics.counter("store.gc.runs").inc()
        metrics.counter("store.gc.reclaimed_bytes").inc(
            stats["reclaimed_bytes"])
    if stats["removed"]:
        logger.info("store gc: reclaimed %d bytes across %d files "
                    "(%d store dirs swept) under %s",
                    stats["reclaimed_bytes"], stats["removed"],
                    stats["dirs_swept"], root)
    return stats
