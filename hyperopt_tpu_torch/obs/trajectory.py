"""Append-only perf-trajectory store: the repo's bench history as data
(counterpart of ``hyperopt_tpu/obs/trajectory.py``, copied: host-only,
the same store and records).  A record the port writes names its backend
``gpu`` (a CUDA card) or ``cpu`` (:func:`backend_key`), so
``scripts/bench_gate.py``'s backend-matched history never gates a card's
run against TPU or CPU runs.

``BENCH_r01..r05.json`` record what each PR's bench run printed, but as
opaque blobs: the *trajectory* — did ``ask_p50_ms`` creep up over six
PRs, did ``sharded_cand_per_sec`` keep scaling — was unanswerable without
re-reading five JSON tails by hand.  This module gives every bench run a
durable, machine-readable record:

* ``.obs/trajectory.jsonl`` — one JSONL record per bench run (schema
  below), append-only, committed to the repo so the history travels with
  the code.  Torn final lines (a killed bench) are tolerated by every
  reader via :func:`~hyperopt_tpu_torch.obs.trace.iter_jsonl`.
* :func:`record_from_bench_json` backfills the checked-in ``BENCH_r*``
  artifacts; ``python -m hyperopt_tpu_torch.obs.trajectory backfill`` seeds the
  store from day one.
* ``bench.py`` calls :func:`append` after every run, stamping the current
  git revision and mesh/dtype config next to the headline keys.
* ``python -m hyperopt_tpu_torch.obs.report --trend`` renders the per-key
  sparkline history; ``scripts/bench_gate.py`` gates new runs against the
  windowed median of the stored history (direction-aware — see
  :data:`KEY_DIRECTIONS`) instead of a single baseline file.

Record schema (one line of ``.obs/trajectory.jsonl``)::

    {"kind": "bench", "ts": <epoch>, "round": <int|None>,
     "source": "BENCH_r04.json" | "bench.py",
     "git_rev": "<short sha>|None", "backend": "tpu|gpu|cpu|...",
     "config": {"n_devices": ..., "hist_dtype": ..., "shard": ...},
     "keys": {<scalar metric>: <float>, ...},
     "series": {<tail metric>: [<float>, ...], ...}}

``keys`` holds one representative value per metric, and only TRUSTED
ones: live bench runs name theirs exactly
(``record_from_headline(keys_override=...)`` — bench.py knows which
stage is the TPE loop); backfilled rounds keep tail metrics in
``series`` only (a recorded tail's first occurrence can name a
different stage, so promoting it to the shared key would poison the
windowed median).  ``series`` keeps every occurrence for metrics that
legitimately repeat (``sharded_cand_per_sec`` per shard count,
``ask_p50_ms`` for tpe then rand), compared positionally by the gate.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import re
import subprocess
import sys
import time

from .trace import iter_jsonl

__all__ = [
    "KEY_DIRECTIONS",
    "TRAJECTORY_PATH",
    "append",
    "load",
    "git_rev",
    "record_from_bench_json",
    "record_from_headline",
    "backfill",
    "trajectory_path",
    "backend_key",
]

logger = logging.getLogger(__name__)

#: repo-relative location of the store (one dir for every obs artifact the
#: repo commits, so ``.obs/`` can grow siblings later)
TRAJECTORY_PATH = os.path.join(".obs", "trajectory.jsonl")

#: Direction metadata for every gated trajectory key: which way is a
#: REGRESSION, and the default allowed relative change vs the windowed
#: median (shared-hardware noise makes tails loose — see bench_gate.py).
#: This table is the single source for ``scripts/bench_gate.py`` and the
#: ``--trend`` renderer (an unknown key renders but never gates).
KEY_DIRECTIONS = {
    "value": {"direction": "higher", "threshold": 0.20},
    "vs_baseline": {"direction": "higher", "threshold": 0.35},
    "trials_per_sec": {"direction": "higher", "threshold": 0.20},
    "candidates_per_sec": {"direction": "higher", "threshold": 0.20},
    "cv_fits_per_sec": {"direction": "higher", "threshold": 0.20},
    "sharded_cand_per_sec": {"direction": "higher", "threshold": 0.20},
    "ask_p50_ms": {"direction": "lower", "threshold": 0.35},
    "ask_p95_ms": {"direction": "lower", "threshold": 0.50},
    "ask_p99_ms": {"direction": "lower", "threshold": 1.00},
    "peak_hbm_bytes": {"direction": "lower", "threshold": 0.30},
    "history_bytes": {"direction": "lower", "threshold": 0.10},
    # armed-but-idle profiler plane vs off (bench.py profiler_overhead
    # stage).  The bar catches a plane that stopped being idle (an
    # accidental always-on session or capture thread costs tens of
    # percent), not single-digit drift: the stage's min-of-3 wall clock
    # swings ±15-20% run-to-run on shared/single-core hardware (the
    # committed round measured -0.167), so anything tighter gates noise.
    "profiler_overhead_frac": {"direction": "lower", "threshold": 0.35,
                               "absolute": True},
    # request-trace + SLO plane armed vs disarmed per-ask delta through
    # the real handler path (bench.py trace_overhead stage).
    # Absolute, like profiler_overhead_frac: the bar catches the plane
    # growing a per-ask serialization/I/O cost (tens of percent), not
    # the scheduler-noise swings of a sub-ms handler loop.
    "trace_overhead_frac": {"direction": "lower", "threshold": 0.35,
                            "absolute": True},
    # fleet shard-reclaim latency (bench.py fleet_recovery stage): wall
    # seconds from a controller dying mid-shard to a survivor holding the
    # reclaimed lease.  Dominated by the stage's lease_ttl constant plus
    # poll jitter; the loose bar catches a broken reclaim path (latency
    # jumping to the barrier timeout), not scheduler noise.
    "recovery_latency_sec": {"direction": "lower", "threshold": 1.00},
    # multi-study serving throughput (bench.py multi_study stage): asks
    # served per wall second at 1k concurrent studies over batched cohort
    # ticks.  The loose-ish bar absorbs shared-hardware noise; a real
    # regression here means the study axis stopped batching.
    "studies_per_sec": {"direction": "higher", "threshold": 0.25},
    # per-ask completion latency of a 1k-study wave (every ask completes
    # with its wave) — deliberately NOT named ask_p99_ms: that key is the
    # single-study interactive loop's, ~1000x smaller, and sharing the
    # name would corrupt the tail-mined series
    "study_ask_p99_ms": {"direction": "lower", "threshold": 1.00},
    # occupied / total cohort slots after the measured waves: near-
    # deterministic for a fixed mix (pow2 slot padding is the only
    # slack), so a drop means the packer started stranding slots
    "slot_utilization_frac": {"direction": "higher", "threshold": 0.15},
    # crash-restart availability gap (bench.py service_resume stage):
    # fresh-scheduler construction on a crashed store root — WAL replay
    # + store rescan + regenerating one in-flight ask per study.
    # Dominated by per-cohort XLA compiles on the regeneration waves;
    # the loose bar catches replay going accidentally quadratic, not
    # compile-time noise
    "resume_latency_sec": {"direction": "lower", "threshold": 1.00},
    # shed fraction of offered asks at 2x sustained capacity through
    # the real handler path: healthy backpressure sits near the excess
    # fraction (~0.5); a collapse toward zero means the bounded
    # admission queue stopped bounding (the overload pin's regression
    # mode — latency explodes instead of clients being told to back
    # off).  Direction "higher" so the gate fires on that collapse.
    "shed_rate_frac": {"direction": "higher", "threshold": 0.60},
    # replicated-fleet serving throughput (bench.py fleet_scale
    # stage): ask+tell rounds/sec through in-process fleet replicas
    # at the largest measured replica count.  Loose-ish bar — the stage
    # runs real per-shard schedulers and WAL fsyncs on shared hardware;
    # a real regression means shard routing or the per-shard WAL grew a
    # per-request cost.
    "fleet_studies_per_sec": {"direction": "higher", "threshold": 0.35},
    # shard-failover latency (same stage): wall seconds from a replica
    # abandoning its shards (SIGKILL analog: leases simply stop
    # heartbeating) to a survivor holding + serving the reclaimed
    # shard.  Dominated by the stage's lease TTL constant + steward
    # poll; the loose bar catches a broken reclaim/adopt path (latency
    # jumping toward the client retry ceiling), not scheduler noise.
    "reclaim_latency_sec": {"direction": "lower", "threshold": 1.00},
    # brand-new-space first-ask tail (bench.py coldstart
    # stage): p99 of the FIRST TPE-eligible ask of never-seen spaces with
    # the compile plane armed — served at the warming rand floor while
    # the cohort program compiles off-thread.  Its regression mode is an
    # ask BLOCKING on a compile (ms → seconds), which the loose relative
    # bar catches comfortably while absorbing rand-floor noise.
    "cold_study_ask_p99_ms": {"direction": "lower", "threshold": 1.00},
    # background compile queue high-water mark during the cold phase:
    # bounded by the distinct-cohort count; a jump means dedupe or the
    # worker broke and the queue grew past the workload's key count.
    "compile_queue_depth_max": {"direction": "lower", "threshold": 2.00},
    # census kernel-bank reuse across the stage's simulated restart:
    # warmed keys that actually served live traffic / keys warmed.
    # Near 1.0 when the census round-trips; a collapse toward 0 means
    # the bank stopped matching live cohort keys.
    "bank_hit_frac": {"direction": "higher", "threshold": 0.40},
    # WAL checksum overhead on the serving path (bench.py
    # store_integrity stage): relative min-of-reps
    # wall-clock delta of real ask+tell round loops through handle()
    # with sealed records vs the checksum-disabled baseline.  The seal
    # is a constant per-record cost (never tail-concentrated), so this
    # mean-side bound bounds its study_ask_p99_ms contribution too.
    # Absolute fixed bar at the acceptance criterion: within 5% or the
    # CRC is too hot for the hot path.
    "checksum_overhead_frac": {"direction": "lower", "threshold": 0.05,
                               "absolute": True},
    # bytes the bounded store GC reclaimed from the stage's seeded
    # garbage (superseded copies, stale tmps, expired dumps).  The
    # stage plants a known-size garbage set, so a collapse means the
    # GC stopped finding it, not that the workload shrank.
    "gc_reclaimed_bytes": {"direction": "higher", "threshold": 0.50},
    # offline scrub throughput over the stage's WAL (records/sec).
    # Loose bar: the scan is pure-Python CRC; a collapse means the
    # verifier went accidentally quadratic.
    "scrub_records_per_sec": {"direction": "higher", "threshold": 0.50},
    # -- the standing per-algo search-QUALITY table (bench.py
    # search_quality stage): the zoo mix run to budget under
    # each algorithm.  These are the megakernel's quality bars — the
    # non-bit-exact scoring-loop rewrites (int8/fp8 history, fused
    # Pallas EI) land against THESE instead of impossible bitwise pins.
    # trials_to_target_*: mean 1-based trial index of the first
    # target-clearing loss (budget when unsolved — failure is penalized,
    # not dropped).  Stochastic across the fixed seed set, so the bars
    # are loose; a real regression (a broken posterior, a mis-weighted
    # EI) moves tpe toward rand's level, far past them.
    "trials_to_target_tpe": {"direction": "lower", "threshold": 0.30},
    "trials_to_target_rand": {"direction": "lower", "threshold": 0.30},
    "trials_to_target_anneal": {"direction": "lower", "threshold": 0.30},
    "trials_to_target_mix": {"direction": "lower", "threshold": 0.30},
    "trials_to_target_atpe": {"direction": "lower", "threshold": 0.30},
    # final_regret_*: mean simple regret vs the zoo optimum at budget
    # exhaustion (optimum-known domains only).  Heavier-tailed than
    # trials-to-target — one unlucky hartmann6 run dominates the mean —
    # hence the looser bar.
    "final_regret_tpe": {"direction": "lower", "threshold": 0.75},
    "final_regret_rand": {"direction": "lower", "threshold": 0.75},
    "final_regret_anneal": {"direction": "lower", "threshold": 0.75},
    "final_regret_mix": {"direction": "lower", "threshold": 0.75},
    "final_regret_atpe": {"direction": "lower", "threshold": 0.75},
    # solved_frac_*: fraction of mix studies whose best cleared the zoo
    # loss_target within budget.  Small denominator (the mix size), so
    # one flipped study moves it by 1/n — the bar allows that, a
    # posterior-breaking change zeroes it.
    "solved_frac_tpe": {"direction": "higher", "threshold": 0.30},
    "solved_frac_rand": {"direction": "higher", "threshold": 0.30},
    "solved_frac_anneal": {"direction": "higher", "threshold": 0.30},
    "solved_frac_mix": {"direction": "higher", "threshold": 0.30},
    "solved_frac_atpe": {"direction": "higher", "threshold": 0.30},
    # armed-vs-disarmed quality-plane per-tell delta through the real
    # handle() path (bench.py quality_overhead stage).  Absolute fixed
    # bar at the acceptance criterion, the checksum_overhead_frac
    # pattern: within 5% or the tracker is too hot for the tell path.
    "quality_overhead_frac": {"direction": "lower", "threshold": 0.05,
                              "absolute": True},
    # armed-vs-disarmed cost-attribution per-wave delta through the
    # real handle() path (bench.py load_attribution stage) — the same
    # 5% absolute acceptance bar: attribution must be noise on the
    # wave, not a tax
    "attribution_overhead_frac": {"direction": "lower", "threshold": 0.05,
                                  "absolute": True},
    # heat skew (max/mean shard heat) of the bench stage's deliberately
    # skewed placement — lower is better (1.0 = balanced); a regression
    # means attribution stopped seeing the imbalance it exists to see
    "shard_heat_skew": {"direction": "lower", "threshold": 0.30},
    # blackbox time-to-detect (bench.py blackbox_probe stage):
    # wall seconds from corruption injected into the serving path to the
    # prober's first non-green verdict, driven with a tight probe period
    # so the measurement is the detection pipeline, not the period.  The
    # loose bar catches detection taking extra cycles (a broken digest
    # or lint path), not shared-hardware cycle-time noise.
    "probe_detection_latency_sec": {"direction": "lower",
                                    "threshold": 1.00},
    # armed-vs-disarmed prober tax on TENANT traffic through the real
    # handle() path while canary cycles run concurrently — the same 5%
    # absolute acceptance bar as the other planes: blackbox auditing
    # must be noise on the tenants it audits, not a tax.
    "probe_overhead_frac": {"direction": "lower", "threshold": 0.05,
                            "absolute": True},
    # fused-suggest megakernel throughput (bench.py megakernel
    # stage): candidates/sec through the armed (interpret-on-CPU /
    # Pallas-on-TPU) cohort at the stage's largest (components,
    # candidates, hist_cap) point.  Loose bar — the interpret path is an
    # XLA emulation whose constant factors swing with scheduler noise; a
    # real regression means the fused tick grew a per-candidate cost.
    "megakernel_cand_per_sec": {"direction": "higher", "threshold": 0.35},
    # quantized-history HBM footprint: int8 resident history bytes /
    # f32 resident history bytes at EQUAL hist_cap.  Near-deterministic
    # (pure dtype arithmetic plus the unquantized losses/flags rows), so
    # the absolute fixed bar sits at the acceptance criterion: int8 must
    # stay <= 0.3x f32 or quantization stopped paying for its cap.
    "megakernel_int8_bytes_frac": {"direction": "lower", "threshold": 0.30,
                                   "absolute": True},
    # tenant-fairness skew (bench.py tenant_fairness stage):
    # light-tenant ask p99 under a 10:1 noisy neighbour, as a multiple
    # of the light tenant's solo p99, with the DRR packer armed.  The
    # acceptance bar is 3x; the loose trajectory bar catches the packer
    # silently degenerating to first-come order, not shared-hardware
    # tail noise.
    "tenant_p99_skew": {"direction": "lower", "threshold": 0.50},
    # armed-vs-disarmed tenant-plane per-ask delta through the real
    # handle() path — the same 5% absolute acceptance bar as the other
    # planes: attribution + DRR must be noise on the ask, not a tax.
    "tenant_overhead_frac": {"direction": "lower", "threshold": 0.05,
                             "absolute": True},
}

#: metrics mined from a bench round's recorded output tail (the same
#: regex bench_gate has always used — the JSON detail block is printed to
#: stderr and only its tail survives in BENCH_r*.json)
TAIL_METRICS = ("trials_per_sec", "candidates_per_sec", "cv_fits_per_sec",
                "sharded_cand_per_sec",
                "ask_p50_ms", "ask_p95_ms", "ask_p99_ms",
                "peak_hbm_bytes", "history_bytes",
                "profiler_overhead_frac", "trace_overhead_frac",
                "recovery_latency_sec",
                "studies_per_sec", "study_ask_p99_ms",
                "slot_utilization_frac",
                "resume_latency_sec", "shed_rate_frac",
                "fleet_studies_per_sec", "reclaim_latency_sec",
                "cold_study_ask_p99_ms", "compile_queue_depth_max",
                "bank_hit_frac",
                "checksum_overhead_frac", "gc_reclaimed_bytes",
                "scrub_records_per_sec",
                "trials_to_target_tpe", "trials_to_target_rand",
                "trials_to_target_anneal", "trials_to_target_mix",
                "trials_to_target_atpe",
                "final_regret_tpe", "final_regret_rand",
                "final_regret_anneal", "final_regret_mix",
                "final_regret_atpe",
                "solved_frac_tpe", "solved_frac_rand",
                "solved_frac_anneal", "solved_frac_mix",
                "solved_frac_atpe",
                "quality_overhead_frac",
                "attribution_overhead_frac", "shard_heat_skew",
                "probe_detection_latency_sec", "probe_overhead_frac",
                "megakernel_cand_per_sec", "megakernel_int8_bytes_frac",
                "tenant_p99_skew", "tenant_overhead_frac")


def backend_key():
    """The backend a port-written record names: ``gpu`` with a CUDA card,
    else ``cpu``."""
    import torch

    return "gpu" if torch.cuda.is_available() else "cpu"


def trajectory_path(root=None):
    """Absolute store path under ``root`` (default: the repo root, two
    levels above this file)."""
    if root is None:
        root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, TRAJECTORY_PATH)


def git_rev(root=None):
    """Short git revision of ``root``, or None (a store consumer must
    never require git to be present)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=root or os.getcwd(), capture_output=True, text=True,
            timeout=10)
    except Exception:
        return None
    rev = (out.stdout or "").strip()
    return rev if out.returncode == 0 and rev else None


def load(path=None):
    """Every parseable ``kind="bench"`` record in the store, oldest
    first.  Torn lines (a bench killed mid-append) warn and skip via
    ``iter_jsonl`` — one partial record must never blind the gate to the
    rest of the history.  Filtering by kind here keeps every consumer
    (the gate, ``--trend``) sane when pointed at the wrong JSONL — a
    telemetry stream renders as an empty store, not thousands of header
    rows."""
    path = path or trajectory_path()
    if not os.path.exists(path):
        return []
    return [r for r in iter_jsonl(path)
            if isinstance(r, dict) and r.get("kind") == "bench"]


def append(record, path=None):
    """Append one record (a single JSON line + flush) and return the path.
    Append-only by design: the store is a history, and rewriting history
    is exactly the failure mode a regression gate exists to prevent."""
    path = path or trajectory_path()
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(record, default=float, sort_keys=True) + "\n")
        f.flush()
    return path


def _mine_tail(tail):
    """``{metric: [occurrences]}`` from a recorded output tail."""
    series = {}
    for name in TAIL_METRICS:
        vals = re.findall(rf'"{name}":\s*(-?[0-9][0-9.eE+-]*)', tail or "")
        if vals:
            series[name] = [float(v) for v in vals]
    return series


def _split_keys(parsed, series, tail_fallback=True):
    """Scalar key dict for a record: the parsed headline values, plus —
    when ``tail_fallback`` — the first occurrence of each tail metric as
    a provisional scalar view.  The fallback is ONLY safe for live
    bench.py records, where ``keys_override`` replaces it with exactly
    named figures before the record is stored; backfilled rounds must
    NOT use it, because a recorded tail's first occurrence can name a
    different stage than the live runs' representative (r02's first
    ``candidates_per_sec`` is the numpy baseline) — storing it under the
    same key would let a real TPE-loop regression hide behind a
    baseline-level median."""
    keys = {}
    for k in ("value", "vs_baseline"):
        v = (parsed or {}).get(k)
        if isinstance(v, (int, float)):
            keys[k] = float(v)
    if tail_fallback:
        for name, vals in series.items():
            keys.setdefault(name, vals[0])
    return keys


def record_from_bench_json(path):
    """A trajectory record backfilled from one checked-in ``BENCH_r*.json``
    artifact (the ``{n, cmd, rc, tail, parsed}`` shape of a recorded bench run).  Rounds
    that crashed (``rc != 0``, ``parsed: null``) still record — an empty
    round is part of the trajectory, and the gate skips keys it lacks."""
    with open(path) as f:
        rec = json.load(f)
    m = re.search(r"BENCH_r(\d+)\.json$", os.path.basename(path))
    parsed = rec.get("parsed") or {}
    series = _mine_tail(rec.get("tail"))
    return {
        "kind": "bench",
        "ts": os.path.getmtime(path),
        "round": int(m.group(1)) if m else None,
        "source": os.path.basename(path),
        "git_rev": None,  # the artifact predates the store; unknowable
        "rc": rec.get("rc"),
        "backend": parsed.get("backend"),
        "config": {},
        "keys": _split_keys(parsed, series, tail_fallback=False),
        "series": series,
    }


def record_from_headline(headline, detail_tail=None, config=None, root=None,
                         keys_override=None):
    """The record ``bench.py`` appends after printing its headline line:
    the parsed headline dict + metrics mined from the detail JSON it just
    wrote to stderr, stamped with the live git revision and mesh/dtype
    config.

    ``keys_override`` replaces the first-tail-occurrence scalar view for
    metrics the producer can name exactly — bench.py knows which stage is
    the TPE loop, the regex miner only knows text order (its first
    ``candidates_per_sec`` hit is the numpy baseline stage, not the
    headline kernel).  The full ``series`` keeps every occurrence either
    way."""
    series = _mine_tail(detail_tail)
    keys = _split_keys(headline, series)
    for k, v in (keys_override or {}).items():
        if isinstance(v, (int, float)):
            keys[k] = float(v)
    return {
        "kind": "bench",
        "ts": time.time(),
        "round": None,
        "source": "bench.py",
        "git_rev": git_rev(root),
        "rc": 0,
        "backend": headline.get("backend") or backend_key(),
        "config": dict(config or {}),
        "keys": keys,
        "series": series,
    }


def backfill(root=None, path=None, force=False):
    """Seed the store from every ``BENCH_r*.json`` under ``root`` (round
    order), skipping rounds already present unless ``force``.  Returns the
    list of rounds appended."""
    if root is None:
        root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
    path = path or trajectory_path(root)
    have = {r.get("round") for r in load(path)
            if r.get("round") is not None} if not force else set()

    def round_no(p):
        m = re.search(r"BENCH_r(\d+)\.json$", p)
        return int(m.group(1)) if m else -1

    appended = []
    for bench_path in sorted(glob.glob(os.path.join(root, "BENCH_r*.json")),
                             key=round_no):
        rec = record_from_bench_json(bench_path)
        if rec["round"] in have:
            continue
        append(rec, path)
        appended.append(rec["round"])
    return appended


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m hyperopt_tpu_torch.obs.trajectory",
        description="Manage the append-only bench trajectory store "
                    "(.obs/trajectory.jsonl).")
    p.add_argument("cmd", choices=("backfill", "show"),
                   help="backfill: seed from BENCH_r*.json; show: dump "
                        "the stored records")
    p.add_argument("--root", default=None,
                   help="repo root (default: auto-detected)")
    p.add_argument("--path", default=None, help="store path override")
    p.add_argument("--force", action="store_true",
                   help="backfill rounds even if already present")
    args = p.parse_args(argv)
    if args.cmd == "backfill":
        rounds = backfill(root=args.root, path=args.path, force=args.force)
        print(f"backfilled rounds: {rounds or 'none (all present)'}")
        return 0
    for rec in load(args.path or trajectory_path(args.root)):
        print(json.dumps(rec, sort_keys=True, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
