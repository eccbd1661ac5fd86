"""Store scrub & repair (counterpart of
``hyperopt_tpu/service/scrub.py``, copied: host-only): walk a serving
store root offline, verify every checksummed surface and the
cross-file invariants, and — with ``--repair`` — perform the same quarantine/truncate actions the
live resume path performs, producing a store that boots clean.

::

    python -m hyperopt_tpu_torch.service.scrub <root> [--repair] [--json]

What is scanned:

* **WALs** — ``<root>/service.wal.jsonl`` and every fleet epoch WAL
  ``<root>/fleet/wal/shard*/e*.jsonl``: per-line CRC32C verification
  (ok / unchecked / corrupt / torn via
  :func:`~hyperopt_tpu_torch.service.integrity.iter_checked_jsonl`), plus
  per-study record invariants (a snapshot's ``n_asked >= n_told``, an
  ask/tell record for a study no admit/snapshot introduced).
* **Epoch chains** — per shard: duplicate epoch numbers are flagged;
  a multi-file chain is noted (legal only in the crash window between
  adoption compaction and ancestor deletion).
* **Census** — ``compile_census.jsonl``: per-line verification (the
  bank tolerates loss; scrub still reports it).
* **Ownership table** — ``fleet/owners/shard*.json``: seal
  verification + liveness (an owner with no replica record is stale).
* **Study stores** — every subdirectory with a ``counter`` file: each
  ``*.pkl`` doc must unpickle (a corrupt doc is a media fault the
  pickle layer cannot excuse), the counter must parse, and a DONE doc
  count below the newest WAL snapshot's ``n_told`` is flagged
  (snapshot-vs-store agreement).
* **Attachments** — ``obs_events.jsonl`` / flight dumps: JSONL parse
  sweep (warn-level; these streams are best-effort by contract).

Repair actions (the offline mirror of the live quarantine path):

* a WAL with corrupt lines is renamed to ``*.quarantined`` (+ sealed
  reason record) and rewritten in place with its verified records,
  minus the corrupt studies' records, plus one ``quarantine`` record
  per corrupt study — the next boot quarantines them (410) and every
  healthy study resumes bit-identically;
* a torn tail is dropped by the same rewrite (the truncate);
* a corrupt census line is dropped on rewrite; a corrupt ownership
  entry is removed (the live owner republishes within a heartbeat);
* an unreadable study doc is renamed ``*.quarantined`` so store scans
  skip it permanently instead of re-parsing it forever.

Exit status: 0 clean (or fully repaired), 2 when corruption was found
and ``--repair`` was not given.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

from . import integrity
from .journal import StudyJournal

__all__ = ["scan_store", "repair_store", "main"]

_EPOCH_RE = re.compile(r"^e(\d+)\..+\.jsonl$")


def _wal_paths(root):
    out = []
    for fname in sorted(os.listdir(root)):
        if fname.endswith(".wal.jsonl"):
            out.append(os.path.join(root, fname))
    wal_root = os.path.join(root, "fleet", "wal")
    if os.path.isdir(wal_root):
        for shard in sorted(os.listdir(wal_root)):
            d = os.path.join(wal_root, shard)
            if not os.path.isdir(d):
                continue
            for fname in sorted(os.listdir(d)):
                if _EPOCH_RE.match(fname):
                    out.append(os.path.join(d, fname))
    return out


def _scan_wal(path, findings):
    """One WAL file: per-line classification + per-study invariants.
    Returns the per-file summary dict."""
    counts = {"ok": 0, "unchecked": 0, "corrupt": 0, "torn": 0}
    corrupt_sids = {}
    known = set()
    records = 0
    t0 = time.perf_counter()
    for chk in integrity.iter_checked_jsonl(path):
        records += 1
        counts[chk.status] += 1
        if chk.status == integrity.CORRUPT:
            sid = ((chk.rec or {}).get("sid")
                   or integrity.salvage_sid(chk.raw))
            corrupt_sids.setdefault(sid or "?", []).append(chk.lineno)
            findings.append({
                "kind": "wal_corrupt", "path": path,
                "lineno": chk.lineno, "sid": sid})
            continue
        if chk.status == integrity.TORN:
            findings.append({"kind": "wal_torn_tail", "path": path,
                             "lineno": chk.lineno, "benign": True})
            continue
        rec = chk.rec
        kind, sid = rec.get("kind"), rec.get("sid")
        if kind in ("admit", "snapshot", "quarantine"):
            known.add(sid)
            if kind == "snapshot":
                if int(rec.get("n_asked", 0)) < int(rec.get("n_told", 0)):
                    findings.append({
                        "kind": "snapshot_invariant", "path": path,
                        "lineno": chk.lineno, "sid": sid,
                        "detail": "n_asked < n_told"})
                if not isinstance(rec.get("rstate"), dict):
                    findings.append({
                        "kind": "snapshot_invariant", "path": path,
                        "lineno": chk.lineno, "sid": sid,
                        "detail": "missing rstate"})
        elif kind in ("ask", "tell", "close") and sid not in known:
            # legal mid-chain (an earlier epoch introduced the study);
            # recorded as a note, not a fault, unless this is the only
            # file — the caller downgrades when a chain exists
            findings.append({"kind": "orphan_record", "path": path,
                             "lineno": chk.lineno, "sid": sid,
                             "benign": True})
    return {"path": path, "records": records, "counts": counts,
            "corrupt_sids": {k: v for k, v in corrupt_sids.items()},
            "known_sids": sorted(s for s in known if s),
            "scan_sec": time.perf_counter() - t0}


def _scan_chains(root, findings):
    wal_root = os.path.join(root, "fleet", "wal")
    chains = {}
    if not os.path.isdir(wal_root):
        return chains
    for shard in sorted(os.listdir(wal_root)):
        d = os.path.join(wal_root, shard)
        if not os.path.isdir(d):
            continue
        epochs = []
        for fname in sorted(os.listdir(d)):
            m = _EPOCH_RE.match(fname)
            if m:
                epochs.append(int(m.group(1)))
        dups = sorted({e for e in epochs if epochs.count(e) > 1})
        if dups:
            findings.append({"kind": "epoch_duplicate", "path": d,
                             "epochs": dups})
        if len(epochs) > 1:
            findings.append({"kind": "epoch_chain_pending", "path": d,
                             "epochs": sorted(epochs), "benign": True})
        chains[shard] = sorted(epochs)
    return chains


def _scan_owners(root, findings):
    owners_dir = os.path.join(root, "fleet", "owners")
    replicas_dir = os.path.join(root, "fleet", "replicas")
    out = []
    if not os.path.isdir(owners_dir):
        return out
    live = set()
    if os.path.isdir(replicas_dir):
        live = set(os.listdir(replicas_dir))
    for fname in sorted(os.listdir(owners_dir)):
        path = os.path.join(owners_dir, fname)
        try:
            with open(path) as f:
                rec = json.loads(f.read())
        except (OSError, ValueError):
            findings.append({"kind": "owner_corrupt", "path": path})
            out.append(path)
            continue
        if not isinstance(rec, dict) \
                or integrity.verify_obj(rec) == integrity.CORRUPT:
            findings.append({"kind": "owner_corrupt", "path": path})
            out.append(path)
            continue
        if live and rec.get("replica") not in live:
            findings.append({"kind": "owner_stale", "path": path,
                             "replica": rec.get("replica"),
                             "benign": True})
    return out


def _scan_census(root, findings):
    path = os.path.join(root, "compile_census.jsonl")
    if not os.path.exists(path):
        return None
    counts = {"ok": 0, "unchecked": 0, "corrupt": 0, "torn": 0}
    for chk in integrity.iter_checked_jsonl(path):
        counts[chk.status] += 1
        if chk.status == integrity.CORRUPT:
            findings.append({"kind": "census_corrupt", "path": path,
                             "lineno": chk.lineno})
    return {"path": path, "counts": counts}


def _scan_stores(root, findings):
    import pickle

    swept = docs = bad = 0
    for fname in sorted(os.listdir(root)):
        d = os.path.join(root, fname)
        if not os.path.isfile(os.path.join(d, "counter")):
            continue
        swept += 1
        try:
            with open(os.path.join(d, "counter")) as f:
                int(f.read().strip() or "0")
        except (OSError, ValueError):
            findings.append({"kind": "counter_corrupt",
                             "path": os.path.join(d, "counter")})
        for sub in ("new", "running", "done", "error", "cancel"):
            dirpath = os.path.join(d, sub)
            if not os.path.isdir(dirpath):
                continue
            for doc in sorted(os.listdir(dirpath)):
                if not doc.endswith(".pkl"):
                    continue
                docs += 1
                path = os.path.join(dirpath, doc)
                try:
                    with open(path, "rb") as f:
                        pickle.loads(f.read())
                except Exception:  # noqa: BLE001 - any parse fault counts
                    bad += 1
                    findings.append({"kind": "doc_corrupt", "path": path})
        att = os.path.join(d, "attachments")
        if os.path.isdir(att):
            for doc in sorted(os.listdir(att)):
                if not doc.endswith(".jsonl"):
                    continue
                path = os.path.join(att, doc)
                try:
                    for chk in integrity.iter_checked_jsonl(path):
                        if chk.rec is None \
                                and chk.status == integrity.CORRUPT:
                            findings.append({
                                "kind": "attachment_garbled",
                                "path": path, "lineno": chk.lineno,
                                "benign": True})
                except OSError:
                    continue
    return {"stores": swept, "docs": docs, "corrupt_docs": bad}


def scan_store(root):
    """Full offline scan; returns the report dict (see module
    docstring).  ``report["clean"]`` is True when no NON-benign finding
    surfaced; ``report["findings"]`` lists everything."""
    root = str(root)
    t0 = time.perf_counter()
    findings = []
    wals = [_scan_wal(p, findings) for p in _wal_paths(root)]
    report = {
        "root": root,
        "ts": time.time(),
        "wals": wals,
        "chains": _scan_chains(root, findings),
        "census": _scan_census(root, findings),
        "owners_corrupt": _scan_owners(root, findings),
        "stores": _scan_stores(root, findings),
        "findings": findings,
    }
    report["records_scanned"] = sum(w["records"] for w in wals)
    report["scan_sec"] = time.perf_counter() - t0
    report["records_per_sec"] = (
        report["records_scanned"] / report["scan_sec"]
        if report["scan_sec"] > 0 else 0.0)
    report["faults"] = [f for f in findings if not f.get("benign")]
    report["clean"] = not report["faults"]
    return report


def repair_store(root, report=None):
    """Apply the offline quarantine/truncate actions for every fault in
    ``report`` (a fresh :func:`scan_store` when omitted).  Returns the
    action list; after repair the store boots clean — healthy studies
    resume bit-identically, corrupt ones answer 410."""
    root = str(root)
    if report is None:
        report = scan_store(root)
    actions = []
    for wal in report["wals"]:
        path = wal["path"]
        has_corrupt = wal["counts"]["corrupt"] > 0
        has_torn = wal["counts"]["torn"] > 0
        if not (has_corrupt or has_torn):
            continue
        healthy = []
        corrupt_sids = set()
        for chk in integrity.iter_checked_jsonl(path):
            if chk.status == integrity.CORRUPT:
                sid = ((chk.rec or {}).get("sid")
                       or integrity.salvage_sid(chk.raw))
                if sid:
                    corrupt_sids.add(sid)
                continue
            if chk.status == integrity.TORN:
                continue
            healthy.append(chk.rec)
        jr = StudyJournal(path)
        if has_corrupt:
            reason = ("scrub --repair: corrupt records for "
                      + (", ".join(sorted(corrupt_sids)) or "unknown"))
            qpath = jr.quarantine_segment(reason)
            actions.append({"action": "quarantine_segment", "path": path,
                            "quarantined": qpath})
        kept = [r for r in healthy
                if r.get("sid") not in corrupt_sids]
        kept += [StudyJournal.quarantine_rec(sid, "scrub --repair")
                 for sid in sorted(corrupt_sids)]
        jr.rewrite(kept, verify_old=False)
        actions.append({"action": "rewrite", "path": path,
                        "records": len(kept),
                        "quarantined_studies": sorted(corrupt_sids),
                        "truncated_torn": has_torn})
    census = report.get("census")
    if census and census["counts"]["corrupt"]:
        path = census["path"]
        kept = [chk.rec for chk in integrity.iter_checked_jsonl(path)
                if chk.status in (integrity.OK, integrity.UNCHECKED)]
        tmp = f"{path}.tmp.scrub.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            for rec in kept:
                f.write(integrity.seal(rec) + "\n")
        os.replace(tmp, path)
        actions.append({"action": "census_rewrite", "path": path,
                        "records": len(kept)})
    for path in report.get("owners_corrupt") or []:
        try:
            os.remove(path)
            actions.append({"action": "owner_removed", "path": path})
        except OSError:
            pass
    for f in report["findings"]:
        if f["kind"] in ("doc_corrupt", "counter_corrupt"):
            path = f["path"]
            try:
                os.replace(path, path + ".quarantined")
                actions.append({"action": "doc_quarantined",
                                "path": path})
            except OSError:
                pass
    return actions


def _render(report, out=sys.stdout):
    p = lambda s: print(s, file=out)  # noqa: E731
    p(f"scrub: {report['root']}")
    p(f"  scanned {report['records_scanned']} WAL records across "
      f"{len(report['wals'])} files in {report['scan_sec']:.3f}s "
      f"({report['records_per_sec']:.0f} rec/s)")
    for w in report["wals"]:
        c = w["counts"]
        line = (f"  wal {os.path.relpath(w['path'], report['root'])}: "
                f"{c['ok']} ok")
        if c["unchecked"]:
            line += f"  {c['unchecked']} unchecked (unsealed)"
        if c["torn"]:
            line += f"  {c['torn']} torn-tail"
        if c["corrupt"]:
            line += f"  {c['corrupt']} CORRUPT -> " + ", ".join(
                f"{sid}@{lines}" for sid, lines
                in sorted(w["corrupt_sids"].items()))
        p(line)
    st = report["stores"]
    if st["stores"]:
        line = (f"  stores: {st['stores']} study dirs, "
                f"{st['docs']} docs")
        if st["corrupt_docs"]:
            line += f", {st['corrupt_docs']} CORRUPT"
        p(line)
    if report["census"]:
        c = report["census"]["counts"]
        p(f"  census: {c['ok']} ok, {c['unchecked']} unchecked"
          + (f", {c['corrupt']} CORRUPT" if c["corrupt"] else ""))
    benign = [f for f in report["findings"] if f.get("benign")]
    if benign:
        p(f"  notes: {len(benign)} benign "
          f"({', '.join(sorted({f['kind'] for f in benign}))})")
    if report["clean"]:
        p("  CLEAN: every checksummed surface verified")
    else:
        p(f"  FAULTS: {len(report['faults'])}")
        for f in report["faults"]:
            p(f"    {f['kind']}: {f.get('path')}"
              + (f":{f['lineno']}" if f.get("lineno") else "")
              + (f" sid={f['sid']}" if f.get("sid") else ""))


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m hyperopt_tpu_torch.service.scrub",
        description="Verify (and optionally repair) a serving store "
                    "root: WAL/census/ownership checksums, cross-file "
                    "invariants, study-doc readability.")
    parser.add_argument("root", help="the store root to scrub")
    parser.add_argument("--repair", action="store_true",
                        help="apply the offline quarantine/truncate "
                             "actions (rename corrupt WAL segments "
                             "aside, rewrite verified records, mark "
                             "corrupt studies quarantined)")
    parser.add_argument("--json", action="store_true",
                        help="print the machine-readable report")
    args = parser.parse_args(argv)
    if not os.path.isdir(args.root):
        print(f"scrub: {args.root} is not a directory", file=sys.stderr)
        return 1
    report = scan_store(args.root)
    if args.repair and not report["clean"]:
        report["repair_actions"] = repair_store(args.root, report)
        report["post"] = scan_store(args.root)
        report["repaired"] = report["post"]["clean"]
    if args.json:
        print(json.dumps(report, default=str))
    else:
        _render(report)
        if args.repair and "repair_actions" in report:
            print(f"  repaired: {len(report['repair_actions'])} actions; "
                  f"post-repair scan "
                  f"{'CLEAN' if report['repaired'] else 'STILL FAULTY'}")
    if report["clean"]:
        return 0
    if args.repair:
        return 0 if report.get("repaired") else 2
    return 2


if __name__ == "__main__":
    sys.exit(main())
