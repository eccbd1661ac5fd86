"""Render a captured run's JSONL telemetry stream into a human report
(counterpart of ``hyperopt_tpu/obs/report.py``, copied: host-only; either
package renders the other's streams to the same text).

Usage::

    python -m hyperopt_tpu_torch.obs.report run.jsonl [--top 5]
    python -m hyperopt_tpu_torch.obs.report --merge run.p0.jsonl run.p1.jsonl ...
    python -m hyperopt_tpu_torch.obs.report --postmortem run.flight.jsonl
    python -m hyperopt_tpu_torch.obs.report --export-trace out.json run.jsonl ...
    python -m hyperopt_tpu_torch.obs.report --trend [.obs/trajectory.jsonl]
    python -m hyperopt_tpu_torch.obs.report --study <id> <store-or-wal> [more...]

Single-stream sections, matching the telemetry pillars:

1. **Phase-time breakdown** — spans aggregated by name: where the run's
   wall clock (and host CPU) actually went, with a share bar.
2. **Search health** — the optimizer's own vitals from the armed TPE /
   rand / anneal suggest paths (obs/health.py): EI-quantile and dup-rate
   trends, prior-fallback sparkline, below/above split, per-param
   posterior shape.
3. **Trial-state waterfall** — lifecycle events rolled into per-trial
   timelines: counts per transition, queue latency (new→claimed) and run
   latency (claimed→finished) distributions.
4. **Top-k slowest trials** — the individual post-mortem targets.

Plus the final metrics snapshot(s) embedded in the stream (the device
loop's capture/execute split, queue gauges, the analytic kernel costs).

``--merge`` treats the inputs as the per-controller streams one
``fmin_multihost`` run wrote (``parallel/driver.py`` names them
``<path>.p<i>.jsonl``) and renders the cross-controller view instead:
per-controller summary + phase breakdown, allgather-latency skew, and
correlated divergence context.

``--postmortem`` renders a flight-recorder dump (``<run>.flight.jsonl``,
written when a process dies — ``obs/flight.py``) as a last-moments
narrative: why/when the process died, the spans still open at death, the
last heartbeat per component (which collective each controller reached),
stall reports, in-flight trials, and the tail of the record ring.

``--export-trace OUT`` converts the input stream(s) to Chrome/Perfetto
trace-event JSON (``obs/export.py``; one process track group per stream)
instead of rendering ASCII — load OUT in https://ui.perfetto.dev.  Any
``kind="profile"`` record in the inputs whose device-capture artifact
(``*.trace.json.gz``, a ``torch.profiler`` chrome trace written by
obs/profiler.py) still exists is merged
in automatically as additional ``device:`` track groups, wall-clock
aligned with the host spans.

``--trend`` renders the append-only bench trajectory store
(``.obs/trajectory.jsonl``, obs/trajectory.py) as per-key sparkline
history — the answer to "did ``ask_p50_ms`` creep up over the last six
PRs" from the committed artifacts alone.

``--probes`` renders the blackbox prober's sealed verdict ledgers
(``render_probes``): per replica the verdict census, the golden's
provenance and the detection latency of every green-to-red edge.  It is a
view of its own and renders text only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .events import (
    TRIAL_CANCELLED,
    TRIAL_CLAIMED,
    TRIAL_FINISHED,
    TRIAL_NEW,
    TRIAL_RECLAIMED,
)
from .trace import iter_jsonl, read_jsonl  # noqa: F401  (read_jsonl re-export)

__all__ = ["main", "render", "render_merged", "render_postmortem",
           "render_trend", "headline_sections", "json_report",
           "render_study_timeline", "study_timeline_events",
           "render_probes"]

_BAR_W = 30


def _bar(frac, width=_BAR_W):
    n = int(round(frac * width))
    return "#" * n + "." * (width - n)


def _fmt_sec(s):
    if s is None:
        return "-"
    if s < 1e-3:
        return f"{s * 1e6:.0f}us"
    if s < 1.0:
        return f"{s * 1e3:.1f}ms"
    return f"{s:.2f}s"


_SPARK_BLOCKS = "▁▂▃▄▅▆▇█"


def _spark(values, width=24):
    """ASCII-art trend line; downsamples evenly to ``width`` points."""
    import math

    vals = [v for v in values if v is not None and math.isfinite(v)]
    if not vals:
        return ""
    if len(vals) > width:
        step = (len(vals) - 1) / (width - 1)
        vals = [vals[int(round(i * step))] for i in range(width)]
    lo, hi = min(vals), max(vals)
    rng = (hi - lo) or 1.0
    return "".join(
        _SPARK_BLOCKS[int((v - lo) / rng * (len(_SPARK_BLOCKS) - 1) + 0.5)]
        for v in vals
    )


def _phase_section(spans, out):
    # shares are SELF time (wall minus direct children) so an umbrella span
    # like fmin's "run" doesn't double-count its phases into the breakdown
    child_wall = {}
    for s in spans:
        pid = s.get("parent_id")
        if pid is not None:
            child_wall[pid] = child_wall.get(pid, 0.0) + s.get("wall_sec", 0.0)
    agg = {}
    for s in spans:
        e = agg.setdefault(s["name"],
                           {"sec": 0.0, "self": 0.0, "cpu": 0.0, "count": 0})
        wall = s.get("wall_sec", 0.0)
        e["sec"] += wall
        e["self"] += max(0.0, wall - child_wall.get(s.get("span_id"), 0.0))
        e["cpu"] += s.get("cpu_sec", 0.0)
        e["count"] += 1
    if not agg:
        out.append("  (no spans in stream)")
        return
    total = sum(e["self"] for e in agg.values()) or 1.0
    width = max(len(n) for n in agg)
    for name, e in sorted(agg.items(), key=lambda kv: -kv[1]["self"]):
        frac = e["self"] / total
        out.append(
            f"  {name:<{width}}  {_bar(frac)} {frac * 100:5.1f}%  "
            f"self {_fmt_sec(e['self']):>8}  wall {_fmt_sec(e['sec']):>8}  "
            f"cpu {_fmt_sec(e['cpu']):>8}  x{e['count']}"
        )


def _trial_timelines(trial_events):
    """Per-tid {event: first ts} plus terminal info."""
    timelines = {}
    for r in trial_events:
        t = timelines.setdefault(r["tid"], {})
        t.setdefault(r["event"], r["ts"])  # first occurrence wins
        if r["event"] == TRIAL_FINISHED:
            t["_status"] = r.get("status", "ok")
    return timelines


def _quantiles(xs):
    if not xs:
        return None
    xs = sorted(xs)

    def q(p):
        return xs[min(len(xs) - 1, int(p * (len(xs) - 1) + 0.5))]

    return {"p50": q(0.5), "p90": q(0.9), "max": xs[-1]}


def _waterfall_section(trial_events, out):
    if not trial_events:
        out.append("  (no trial events in stream)")
        return
    counts = {}
    for r in trial_events:
        counts[r["event"]] = counts.get(r["event"], 0) + 1
    out.append("  transitions: " + "  ".join(
        f"{k}={v}" for k, v in sorted(counts.items())))
    timelines = _trial_timelines(trial_events)
    queue_lat = [
        t[TRIAL_CLAIMED] - t[TRIAL_NEW]
        for t in timelines.values()
        if TRIAL_NEW in t and TRIAL_CLAIMED in t
    ]
    run_lat = [
        t[TRIAL_FINISHED] - t[TRIAL_CLAIMED]
        for t in timelines.values()
        if TRIAL_CLAIMED in t and TRIAL_FINISHED in t
    ]
    for label, lat in (("queue (new->claimed)", queue_lat),
                       ("run (claimed->finished)", run_lat)):
        q = _quantiles(lat)
        if q:
            out.append(
                f"  {label:<24} n={len(lat)}  p50 {_fmt_sec(q['p50'])}  "
                f"p90 {_fmt_sec(q['p90'])}  max {_fmt_sec(q['max'])}")
    n_reclaimed = counts.get(TRIAL_RECLAIMED, 0)
    n_cancelled = counts.get(TRIAL_CANCELLED, 0)
    if n_reclaimed or n_cancelled:
        out.append(f"  anomalies: reclaimed={n_reclaimed} "
                   f"cancelled={n_cancelled}")


def _slowest_section(trial_events, out, top=5):
    timelines = _trial_timelines(trial_events)
    durations = []
    for tid, t in timelines.items():
        start = t.get(TRIAL_CLAIMED, t.get(TRIAL_NEW))
        end = t.get(TRIAL_FINISHED, t.get(TRIAL_CANCELLED))
        if start is not None and end is not None:
            durations.append((end - start, tid, t.get("_status", "?")))
    if not durations:
        out.append("  (no completed trials in stream)")
        return
    durations.sort(reverse=True)
    for sec, tid, status in durations[:top]:
        out.append(f"  tid {tid:>6}  {_fmt_sec(sec):>9}  status={status}")


def _health_section(health_recs, out):
    """Search-health vitals (obs/health.py record schema): trends over the
    run's asks, last-ask posterior shape per param."""
    if not health_recs:
        out.append("  (no health records — arm the run with obs=<path> and "
                   "a tpe/rand/anneal suggester)")
        return
    by_algo = {}
    for r in health_recs:
        by_algo[r.get("algo", "?")] = by_algo.get(r.get("algo", "?"), 0) + 1
    out.append("  asks: " + "  ".join(
        f"{a}={n}" for a, n in sorted(by_algo.items())))
    tpe = [r for r in health_recs if "ei_p50" in r]
    if tpe:
        ei = [r["ei_p50"] for r in tpe]
        out.append(f"  EI p50        first {ei[0]:+.3g}  last {ei[-1]:+.3g}"
                   f"  {_spark(ei)}")
        sel = [r.get("sel_rank", 0.0) for r in tpe]
        out.append(f"  EI sel rank   mean {sum(sel) / len(sel):.2f}"
                   "  (0 = pure argmax)")
    dups = [r["dup_rate"] for r in health_recs if "dup_rate" in r]
    if dups:
        out.append(f"  dup rate      first {dups[0]:.1%}  last {dups[-1]:.1%}"
                   f"  {_spark(dups)}")
    spreads = [r["spread"] for r in health_recs if "spread" in r]
    if spreads:
        out.append(f"  spread        last {spreads[-1]:.3g}  {_spark(spreads)}"
                   "  (rand/anneal proposal std)")
    if tpe:
        takes = [r.get("prior_takes", 0) for r in tpe]
        total = sum(r.get("n_label_proposals", 0) for r in tpe)
        out.append(f"  prior fallback  {sum(takes)}/{total} label-proposals"
                   f"  {_spark(takes)}")
        last = tpe[-1]
        out.append(f"  below/above split (last ask): "
                   f"{last.get('n_below', '?')}/{last.get('n_above', '?')}")
        labels = last.get("labels") or {}
        if labels:
            w = max(len(l) for l in labels)
            out.append("  per-param (last ask):")
            for l, st in sorted(labels.items()):
                out.append(
                    f"    {l:<{w}}  eff_comp {st.get('eff_components', 0):.1f}"
                    f"  prior_mass {st.get('prior_mass_frac', 0):.2f}"
                    f"  dup {st.get('dup_rate', 0):.1%}")


def _metrics_section(metric_recs, out):
    if not metric_recs:
        out.append("  (no metrics snapshot in stream)")
        return
    for rec in metric_recs:
        snap = rec.get("snapshot", {})
        out.append(f"  run_id={rec.get('run_id', '?')}")
        out.append("  " + json.dumps(snap, indent=2, sort_keys=True,
                                     default=str).replace("\n", "\n  "))


def _pipeline_section(spans, metrics, out):
    """Ask-pipeline summary: dispatch vs readback wall time and
    the speculative-ask overlap, when the run recorded the split."""
    agg = {}
    for s in spans:
        if s["name"] in ("suggest", "suggest.dispatch", "suggest.readback"):
            e = agg.setdefault(s["name"], [0.0, 0])
            e[0] += s.get("wall_sec", 0.0)
            e[1] += 1
    if "suggest.dispatch" not in agg and "suggest.readback" not in agg:
        return
    out.append("")
    out.append("== ask pipeline " + "=" * 48)
    for name in ("suggest", "suggest.dispatch", "suggest.readback"):
        if name in agg:
            sec, count = agg[name]
            out.append(f"  {name:<18} wall {_fmt_sec(sec):>8}  x{count}")
    shards = metrics.get("suggest.shards")
    if shards:
        line = f"  sharded over {int(shards)} device(s)"
        cps = metrics.get("suggest.cand_per_shard")
        if cps:
            line += f"  cand/shard {int(cps)}"
        line += ("  history axis: sharded"
                 if metrics.get("suggest.hist_sharded")
                 else "  history axis: replicated")
        out.append(line)
    spec = metrics.get("suggest.speculative", 0)
    blocked = metrics.get("ask.blocked_sec") or {}
    if blocked.get("count"):
        out.append(
            f"  blocked per ask    p50 {_fmt_sec(blocked.get('p50', 0)):>8}"
            f"  p99 {_fmt_sec(blocked.get('p99', 0)):>8}"
            f"  x{blocked['count']}  (speculative asks: {spec})")
    if spec:
        out.append("  overlap: speculative dispatches ran while trials "
                   "evaluated — readback p50 above is the residual wait")
    else:
        out.append("  no speculative asks recorded (lookahead=0: "
                   "synchronous dispatch+readback)")


def _resilience_section(metrics, out):
    """Fleet & chaos summary: shard-lease traffic, injected
    faults, retry/backoff pressure — rendered only when the run recorded
    any of it (a non-fleet, chaos-free run keeps its report unchanged)."""
    lease_keys = [k for k in metrics if k.startswith("lease.")]
    chaos_keys = [k for k in metrics if k.startswith("chaos.")]
    retry_n = metrics.get("trials.retries", 0)
    backoff = metrics.get("retry.backoff_sec") or {}
    res_backoff = metrics.get("reserve.backoff_sec") or {}
    ag_timeouts = metrics.get("allgather.timeouts", 0)
    if not (lease_keys or chaos_keys or retry_n or backoff.get("count")
            or res_backoff.get("count") or ag_timeouts):
        return
    out.append("")
    out.append("== fleet & chaos " + "=" * 47)
    if lease_keys or metrics.get("fleet.members") is not None:
        out.append(
            f"  leases   claims {int(metrics.get('lease.claims', 0))}"
            f"  reclaims {int(metrics.get('lease.reclaims', 0))}"
            f"  contention {int(metrics.get('lease.contention', 0))}"
            f"  heartbeats {int(metrics.get('lease.heartbeats', 0))}")
        members = metrics.get("fleet.members")
        pub = metrics.get("shard.published", 0)
        if members is not None or pub:
            out.append(f"  fleet    members {int(members or 0)}"
                       f"  shards published {int(pub)}"
                       f"  joins {int(metrics.get('fleet.joins', 0))}")
    if chaos_keys:
        inj = "  ".join(f"{k[len('chaos.'):]} x{int(metrics[k])}"
                        for k in sorted(chaos_keys))
        out.append(f"  chaos    {inj}")
    if retry_n or backoff.get("count"):
        line = f"  retries  {int(retry_n)} re-attempts"
        if backoff.get("count"):
            line += (f"  backoff p50 {_fmt_sec(backoff.get('p50', 0))}"
                     f"  max {_fmt_sec(backoff.get('max', 0))}")
        out.append(line)
    if res_backoff.get("count"):
        out.append(
            f"  reserve  backoff x{int(res_backoff['count'])}"
            f"  p50 {_fmt_sec(res_backoff.get('p50', 0))}"
            f"  total {_fmt_sec(res_backoff.get('sum', 0))}")
    if ag_timeouts:
        out.append(f"  DEGRADED: {int(ag_timeouts)} collective timeout(s) — "
                   "checkpoint-and-shrink path taken")


def _service_section(metrics, out):
    """Serving-plane health: traffic, shed/backpressure,
    degrade-ladder state, WAL durability and HTTP error classes —
    rendered only when the stream recorded ``service.*`` metrics (a
    non-serving run keeps its report unchanged)."""
    svc = {k: v for k, v in metrics.items() if k.startswith("service.")}
    if not svc:
        return
    out.append("")
    out.append("== service health " + "=" * 46)
    asks = int(svc.get("service.asks", 0))
    tells = int(svc.get("service.tells", 0))
    ticks = int(svc.get("service.ticks", 0))
    if asks or tells:
        wave = svc.get("service.wave_sec") or {}
        line = (f"  traffic  asks {asks}  tells {tells}  ticks {ticks}"
                f"  studies {int(svc.get('service.studies_created', 0))}")
        if wave.get("count"):
            line += (f"  wave p50 {_fmt_sec(wave.get('p50', 0))}"
                     f"  p99 {_fmt_sec(wave.get('p99', 0))}")
        out.append(line)
    shed_ask = int(svc.get("service.shed.ask", 0))
    shed_tell = int(svc.get("service.shed.tell", 0))
    shed_ddl = int(svc.get("service.shed.deadline", 0))
    if shed_ask or shed_tell:
        frac = shed_ask / max(1, shed_ask + asks)
        out.append(f"  shed     asks {shed_ask} ({100 * frac:.1f}% of "
                   f"offered)  tells {shed_tell}"
                   f"  deadline-unservable {shed_ddl}")
    level = svc.get("service.degraded")
    downs = int(svc.get("service.degrade.down", 0))
    if level or downs:
        out.append(
            f"  degrade  level {int(level or 0)}"
            f"  faults {int(svc.get('service.degrade.faults', 0))}"
            f"  down x{downs}"
            f"  up x{int(svc.get('service.degrade.up', 0))}"
            f"  rand-served asks "
            f"{int(svc.get('service.degraded_asks', 0))}")
        if level:
            out.append("  DEGRADED: serving below full quality — see "
                       "service.degrade.* transitions")
    comp_keys = [k for k in svc if k.startswith("service.compile.")]
    if comp_keys:
        # cold-start compile plane: warming traffic, the
        # background queue, and the kernel bank's reuse
        cc_h = int(svc.get("service.compile.cohort_cache.hits", 0))
        cc_m = int(svc.get("service.compile.cohort_cache.misses", 0))
        out.append(
            f"  compile  warming studies "
            f"{int(svc.get('service.compile.warming_studies', 0))}"
            f"  warming asks "
            f"{int(svc.get('service.compile.warming_asks', 0))}"
            f"  promotions "
            f"{int(svc.get('service.compile.promotions', 0))}"
            f"  queue {int(svc.get('service.compile.queue_depth', 0))}"
            f"  compiled "
            f"{int(svc.get('service.compile.compiled_total', 0))}")
        bank_keys = int(svc.get("service.compile.bank.keys", 0))
        if bank_keys or cc_h or cc_m:
            line = (f"  kernels  cohort cache {cc_h}h/{cc_m}m"
                    f"  bank keys {bank_keys}"
                    f"  bank hits "
                    f"{int(svc.get('service.compile.bank.hits', 0))}")
            errs = int(svc.get("service.compile.errors", 0))
            if errs:
                line += f"  COMPILE ERRORS {errs}"
            out.append(line)
    wal_keys = [k for k in svc if k.startswith("service.wal.")]
    if wal_keys:
        out.append(
            f"  wal      replayed studies "
            f"{int(svc.get('service.wal.replay_studies', 0))}"
            f"  asks {int(svc.get('service.wal.replay_asks', 0))}"
            f" ({int(svc.get('service.wal.replay_regenerated', 0))} "
            f"regenerated)"
            f"  dup tells "
            f"{int(svc.get('service.wal.replay_duplicate_tells', 0))}"
            f"  compactions "
            f"{int(svc.get('service.wal.compactions', 0))}")
        sync_errs = int(svc.get("service.wal.sync_errors", 0))
        if sync_errs or svc.get("service.wal.replay_errors"):
            out.append(
                f"  WAL TROUBLE: sync errors {sync_errs}  replay errors "
                f"{int(svc.get('service.wal.replay_errors', 0))}")
    http = {}
    for k, v in svc.items():
        if k.startswith("service.http."):
            _, _, rest = k.partition("service.http.")
            ep, _, cls = rest.rpartition(".")
            http.setdefault(cls, {})[ep] = int(v)
    for cls in sorted(http):
        if cls in ("4xx", "5xx") or cls == "2xx":
            total = sum(http[cls].values())
            detail = "  ".join(f"{ep} {n}" for ep, n
                               in sorted(http[cls].items()))
            out.append(f"  http     {cls} x{total}  ({detail})")
    _slo_lines(metrics, out)


def _quality_section(metrics, events, out):
    """Search-quality roll-up: the ``quality.*`` gauges per
    (algo, space-signature) cohort — studies/stagnant/solved counts and
    best regret — plus a best-so-far sparkline per cohort mined from the
    streamed ``quality.improvement`` events.  Rendered only when the
    stream recorded the quality plane (a disarmed run keeps its report
    unchanged)."""
    qual = {k: v for k, v in metrics.items() if k.startswith("quality.")}
    imps = [e for e in events
            if e.get("name") == "quality.improvement"
            and (e.get("attrs") or {}).get("best") is not None]
    if not qual and not imps:
        return
    out.append("")
    out.append("== search quality " + "=" * 46)
    n = int(qual.get("quality.studies", 0))
    if n or qual:
        line = (f"  studies  {n}"
                f"  stagnant {int(qual.get('quality.stagnant', 0))}"
                f" ({float(qual.get('quality.stagnant_frac', 0.0)):.0%})"
                f"  solved {int(qual.get('quality.solved', 0))}")
        imp_n = qual.get("quality.improvements")
        stag_n = qual.get("quality.stagnations")
        if imp_n is not None or stag_n is not None:
            line += (f"  improvements {int(imp_n or 0)}"
                     f"  stagnations {int(stag_n or 0)}")
        out.append(line)
    # per-cohort table from the quality.cohort.<key>.* gauges
    cohorts = sorted({k.split(".")[2] for k in qual
                      if k.startswith("quality.cohort.")
                      and k.count(".") >= 3})
    # best-so-far trajectory per cohort: each improvement event carries
    # the new best — in stream order that IS the convergence curve
    curves = {}
    for e in imps:
        a = e.get("attrs") or {}
        curves.setdefault(a.get("cohort") or "?", []).append(
            float(a["best"]))
    for c in cohorts:
        base = f"quality.cohort.{c}"
        line = (f"  cohort   {c:<28}"
                f" studies {int(qual.get(f'{base}.studies', 0))}"
                f"  stagnant {int(qual.get(f'{base}.stagnant', 0))}"
                f"  solved {int(qual.get(f'{base}.solved', 0))}")
        regret = qual.get(f"{base}.best_regret")
        if regret is not None:
            line += f"  regret {float(regret):.4g}"
        spark = _spark(curves.get(c, []))
        if spark:
            line += f"  best {spark}"
        out.append(line)
    # cohorts seen only in the event stream (gauges not snapshotted)
    for c in sorted(set(curves) - set(cohorts)):
        out.append(f"  cohort   {c:<28} best {_spark(curves[c])}"
                   f" -> {min(curves[c]):.4g}")
    if qual.get("quality.stagnant_frac", 0.0) and n and (
            float(qual.get("quality.stagnant_frac", 0.0)) >= 0.5):
        out.append("  STAGNATION: over half the live studies have "
                   "plateaued — check budgets/targets (quality.* gauges, "
                   "per-study timelines)")


def _storage_section(metrics, out):
    """Storage integrity: checksum verification traffic,
    quarantines with reasons, disk watermarks, GC reclaim and the
    ENOSPC shed state — rendered only when the stream recorded any
    integrity/store metric (a healthy in-memory run keeps its report
    unchanged)."""
    keys = {k: v for k, v in metrics.items()
            if k.startswith(("service.integrity.", "store.",
                             "service.shed.store_full",
                             "scrub."))}
    if not keys:
        return
    out.append("")
    out.append("== storage integrity " + "=" * 43)
    verified = int(keys.get("service.integrity.verified", 0))
    unchecked = int(keys.get("service.integrity.unchecked", 0))
    corrupt = int(keys.get("service.integrity.corrupt_records", 0))
    torn = int(keys.get("service.integrity.torn", 0))
    if verified or unchecked or corrupt or torn:
        out.append(f"  checksums  verified {verified}"
                   f"  unchecked(pre-15) {unchecked}"
                   f"  torn-tail {torn}  corrupt {corrupt}")
    quarantines = int(keys.get("service.integrity.quarantines", 0))
    if quarantines or corrupt:
        out.append(
            f"  quarantine studies {quarantines}"
            f"  records-skipped "
            f"{int(keys.get('service.integrity.quarantine_skipped', 0))}"
            f"  snapshot-recovered "
            f"{int(keys.get('service.integrity.snapshot_recovered', 0))}"
            f"  unattributed "
            f"{int(keys.get('service.integrity.corrupt_unattributed', 0))}")
        if quarantines:
            out.append("  QUARANTINED: corrupt studies answer 410 — "
                       "run `python -m hyperopt_tpu_torch.service.scrub "
                       "<root> --repair`")
    free = keys.get("store.free_bytes")
    if free is not None:
        used = float(keys.get("store.used_frac", 0.0) or 0.0)
        line = (f"  disk       free {_fmt_bytes(float(free))}"
                f"  used {used:.1%}")
        if keys.get("store.full"):
            line += "  STORE-FULL (shedding 507)"
        out.append(line)
    shed = int(keys.get("service.shed.store_full", 0))
    enospc = int(keys.get("store.enospc_errors", 0))
    if shed or enospc:
        out.append(f"  enospc     sheds {shed}  append-errors {enospc}")
    gc_bytes = keys.get("store.gc.reclaimed_bytes")
    if gc_bytes is not None:
        out.append(
            f"  gc         runs {int(keys.get('store.gc.runs', 0))}"
            f"  reclaimed {_fmt_bytes(float(gc_bytes))}")
    scrub_recs = keys.get("scrub.records")
    if scrub_recs is not None:
        out.append(
            f"  scrub      records {int(scrub_recs)}"
            f"  corrupt {int(keys.get('scrub.corrupt', 0))}"
            f"  repaired {int(keys.get('scrub.repaired', 0))}")


def _probe_section(metrics, out):
    """Blackbox probes: the synthetic-canary audit plane —
    cycle count, newest verdict, golden-match streak and the measured
    green→red detection latency — from the ``probe.*`` gauges a
    prober-armed server snapshots.  Rendered only when the stream
    recorded the prober (a disarmed run keeps its report unchanged)."""
    pr = {k: v for k, v in metrics.items() if k.startswith("probe.")}
    if not pr:
        return
    verdict_names = ("ok", "degraded", "contract", "mismatch", "error")
    out.append("")
    out.append("== blackbox probes " + "=" * 45)
    code = int(pr.get("probe.last_verdict_code", -1))
    verdict = verdict_names[code] if 0 <= code < len(verdict_names) \
        else "?"
    out.append(
        f"  cycles   {int(pr.get('probe.cycles', 0))}"
        f"  targets {int(pr.get('probe.targets', 0))}"
        f"  last verdict {verdict}"
        f"  golden-match streak "
        f"{int(pr.get('probe.golden_match_streak', 0))}")
    counts = "  ".join(
        f"{v} {int(pr[f'probe.verdict.{v}'])}" for v in verdict_names
        if pr.get(f"probe.verdict.{v}"))
    if counts:
        out.append(f"  verdicts {counts}")
    lat = pr.get("probe.detection_latency_sec")
    if lat is not None:
        out.append(f"  detection latency {float(lat):.2f}s "
                   "(last green->red edge, client-view)")
    esc = int(pr.get("probe.escalations", 0))
    if esc or verdict == "mismatch":
        out.append(
            f"  GOLDEN MISMATCH: escalations {esc} — the canary's "
            "proposal stream diverged from the committed golden digest "
            "(evidence bundles under fleet/probes/, flight ring has "
            "probe_mismatch records)")


def _megakernel_section(metrics, spans, out):
    """Fused-suggest megakernel plane: arming state, quantized
    history encode/dispatch span time, and the two warn-once fallback
    counters (kernel lowering failure, quantizer refusal).  Rendered only
    when the run ever armed the megakernel or tripped a fallback — a
    plain bf16/jnp run keeps its report unchanged."""
    armed = metrics.get("suggest.megakernel")
    kfall = int(metrics.get("suggest.megakernel.fallback", 0))
    qfall = int(metrics.get("suggest.quant.fallback", 0))
    span_tot = {}
    for s in spans:
        n = s.get("name", "")
        if n.startswith("suggest.megakernel."):
            e = span_tot.setdefault(n, {"sec": 0.0, "count": 0})
            e["sec"] += s.get("wall_sec", 0.0)
            e["count"] += 1
    if armed is None and not (kfall or qfall or span_tot):
        return
    out.append("")
    out.append("== megakernel " + "=" * 50)
    state = "armed" if armed else "disarmed"
    out.append(f"  fused    {state}"
               f"  lowering fallbacks {kfall}"
               f"  quant fallbacks {qfall}")
    for name in sorted(span_tot):
        e = span_tot[name]
        short = name[len("suggest.megakernel."):]
        out.append(f"  {short:<8} x{e['count']:<6} "
                   f"total {_fmt_sec(e['sec']):>8}")
    if kfall:
        out.append("  FALLBACK: Pallas lowering failed at least once — "
                   "cohort(s) rebuilt on the jnp path (warn-once log has "
                   "the first error)")
    if qfall:
        out.append("  FALLBACK: quantizer refused the space/dtype — "
                   "history stored bf16 instead (asks unaffected)")


def render_probes(path):
    """The blackbox-probe verdict view from the durable CRC-sealed
    ledgers: give one ``<replica>.jsonl`` ledger, a
    ``fleet/probes`` dir, or a store root — per replica the verdict
    census, current/newest verdict, golden digest provenance and the
    measured detection-latency stats over every green→red edge.
    Corrupt ledger lines are counted, not fatal (the census read
    discipline)."""
    from .prober import PROBES_DIR, detection_stats, read_probes

    if os.path.isdir(path):
        probes_dir = os.path.join(path, PROBES_DIR)
        if not os.path.isdir(probes_dir):
            probes_dir = path
        ledgers = sorted(
            os.path.join(probes_dir, f) for f in os.listdir(probes_dir)
            if f.endswith(".jsonl"))
    else:
        ledgers = [path]
    out = []
    out.append("== blackbox probes " + "=" * 45)
    if not ledgers:
        out.append(f"  (no probe ledgers under {path} — is any replica "
                   "running with --probe on / HYPEROPT_TPU_PROBE=1?)")
        return "\n".join(out) + "\n"
    verdict_names = ("ok", "degraded", "contract", "mismatch", "error")
    glyph = {"ok": ".", "degraded": "d", "contract": "c",
             "mismatch": "X", "error": "!"}
    for ledger in ledgers:
        recs, corrupt, torn = read_probes(ledger)
        name = os.path.basename(ledger)[: -len(".jsonl")]
        line = f"  {name:<24} verdicts {len(recs)}"
        if corrupt:
            line += f"  CORRUPT {corrupt}"
        if torn:
            line += f"  torn {torn}"
        out.append(line)
        if not recs:
            continue
        recs = sorted(recs, key=lambda r: (r.get("ts") or 0.0,
                                           r.get("cycle") or 0))
        counts = {}
        for r in recs:
            counts[r.get("verdict") or "?"] = (
                counts.get(r.get("verdict") or "?", 0) + 1)
        census = "  ".join(f"{v} {counts[v]}" for v in verdict_names
                           if v in counts)
        extra = sum(n for v, n in counts.items()
                    if v not in verdict_names)
        if extra:
            census += f"  other {extra}"
        last = recs[-1]
        out.append(f"    census   {census}")
        out.append(
            f"    newest   cycle {int(last.get('cycle') or 0)}"
            f"  verdict {last.get('verdict')}"
            + (f"  ({last.get('why')})" if last.get("why") else ""))
        golden = last.get("golden")
        if golden:
            out.append(
                f"    golden   {golden} [{last.get('golden_source')}]"
                f"  canary {last.get('canary')}"
                f"  backend {last.get('backend')}")
        strip = "".join(glyph.get(r.get("verdict"), "?")
                        for r in recs[-48:])
        out.append(f"    verdicts [{strip}]  (newest right)")
        stats = detection_stats(recs)
        if stats["episodes"]:
            out.append(
                f"    detect   {stats['episodes']} episode(s)  "
                f"latency min {stats['min_sec']:.2f}s  "
                f"mean {stats['mean_sec']:.2f}s  "
                f"max {stats['max_sec']:.2f}s (client-view "
                "green->red)")
        evidence = [r.get("evidence") for r in recs if r.get("evidence")]
        if evidence:
            out.append(f"    evidence {evidence[-1]}")
    return "\n".join(out) + "\n"


def _slo_lines(metrics, out):
    """SLO error-budget lines: one row per objective from the
    ``slo.*`` gauges, budget bar + fast/slow burn rates, with the
    ERROR-BUDGET-EXHAUSTED banner when any objective's budget is gone.
    Rendered only when the stream recorded the SLO plane."""
    objectives = sorted({k.split(".")[1] for k in metrics
                         if k.startswith("slo.") and k.count(".") >= 2})
    if not objectives:
        return
    exhausted = []
    for name in objectives:
        rem = metrics.get(f"slo.{name}.budget_remaining_frac")
        if rem is None:
            continue
        burn_f = metrics.get(f"slo.{name}.burn_fast", 0.0)
        burn_s = metrics.get(f"slo.{name}.burn_slow", 0.0)
        frac = max(0.0, min(1.0, float(rem)))
        line = (f"  slo      {name:<14} budget [{_bar(frac, 16)}] "
                f"{float(rem) * 100:6.1f}%  burn fast {float(burn_f):5.1f}x"
                f"  slow {float(burn_s):5.1f}x")
        if metrics.get(f"slo.{name}.fast_alerting"):
            line += "  FAST-BURN"
        out.append(line)
        if metrics.get(f"slo.{name}.exhausted"):
            exhausted.append(name)
    if exhausted:
        out.append("  ERROR-BUDGET-EXHAUSTED: " + ", ".join(exhausted)
                   + " — the service is out of SLO; see slo.* gauges and "
                     "the escalation capture (slo.escalations)")


def _devmem_section(devmem_recs, out):
    """HBM watermark over the run's devmem samples (obs/devmem.py) + the
    last live-array census, so "how much memory did it hold" is answerable
    from the report alone."""
    if not devmem_recs:
        return
    from .devmem import roll_up

    out.append("")
    out.append("== device memory (HBM) " + "=" * 41)
    rolls = [roll_up(r.get("devices", [])) for r in devmem_recs]
    in_use = [r[0] for r in rolls]
    limit = next((r[2] for r in reversed(rolls) if r[2] is not None), None)
    peak = max((r[1] for r in rolls if r[1] is not None), default=None)
    if peak is None and not any(v is not None for v in in_use):
        out.append(f"  {len(devmem_recs)} sample(s); backend reports no "
                   "memory_stats (CPU?) — census only")
    else:
        line = f"  samples {len(devmem_recs)}"
        if peak is not None:
            line += f"  peak {_fmt_bytes(peak)}"
        if limit:
            line += f"  limit {_fmt_bytes(limit)}"
            if peak is not None:
                # explicitly the PEAK fraction — the live "hbm N%"
                # progressbar/top figure is current in-use, a different
                # (and for a live surface, more useful) number
                line += f"  peak watermark {peak / limit:.0%}"
        out.append(line)
        spark = _spark([v for v in in_use if v is not None])
        if spark:
            out.append(f"  in-use trend  {spark}")
    census = devmem_recs[-1].get("census") or {}
    if census:
        parts = []
        for owner in sorted(census):
            if owner == "total":
                continue
            b = census[owner]
            parts.append(f"{owner} {_fmt_bytes(b['bytes'])} "
                         f"(x{b['count']})")
        tot = census.get("total", {})
        out.append("  live arrays (last census): " + "  ".join(parts)
                   + (f"  | total {_fmt_bytes(tot.get('bytes', 0))} "
                      f"(x{tot.get('count', 0)})" if tot else ""))
    per_device = devmem_recs[-1].get("per_device") or {}
    if per_device:
        # the sharded-suggest breakdown: where each owner's bytes actually
        # landed, device by device (a sharded axis shows up as 1/n-sized
        # slices; a replicated leaf charges every device in full)
        out.append("  per-shard breakdown (last census):")
        for dev in sorted(per_device):
            owners = per_device[dev]
            parts = [f"{o} {_fmt_bytes(owners[o]['bytes'])}"
                     for o in sorted(owners) if o != "total"]
            out.append(f"    {dev}: " + "  ".join(parts))


def _fmt_bytes(n):
    if n is None:
        return "-"
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return (f"{n:.0f}{unit}" if unit == "B" else f"{n:.2f}{unit}")
        n /= 1024


def _fmt_flops(v):
    if v is None:
        return "-"
    v = float(v)
    for unit in ("", "K", "M", "G", "T", "P"):
        if abs(v) < 1000 or unit == "P":
            return f"{v:.1f}{unit}F/s"
        v /= 1000


def _roofline_section(records, spans, out):
    """Per-program roofline (kernel attribution): the recorded costs
    (the port's: analytic kernel counts) joined with measured execute
    spans, plus each program's share of the suggest phase — from the final embedded
    metrics snapshot, same join the live ``/snapshot`` serves."""
    from .health import roofline_table

    metric_recs = [r for r in records if r.get("kind") == "metrics"]
    if not metric_recs:
        return
    snap = metric_recs[-1].get("snapshot") or {}
    dev = ((snap.get("shared") or {}).get("device") or {}).get("metrics", {})
    phases = {}
    for s in spans:
        if s.get("aggregate") is False:
            continue
        e = phases.setdefault(s["name"], {"sec": 0.0, "count": 0})
        e["sec"] += s.get("wall_sec", 0.0)
        e["count"] += 1
    rows = roofline_table(dev, phases=phases)
    if not rows:
        return
    out.append("")
    out.append("== kernel roofline " + "=" * 45)
    w = max(len(n) for n in rows)
    for st, r in sorted(rows.items()):
        ai = r.get("arithmetic_intensity")
        if r.get("dispatches"):
            line = (f"  {st:<{w}}  x{r['dispatches']:<6} "
                    f"exec {_fmt_sec(r['execute_sec_total']):>8}  "
                    f"achieved "
                    f"{_fmt_flops(r.get('achieved_flops_per_sec')):>10}")
            if ai is not None:
                line += f"  AI {ai:.1f} F/B"
            if r.get("pct_of_ask") is not None:
                line += f"  {r['pct_of_ask'] * 100:.0f}% of ask"
        else:
            line = f"  {st:<{w}}  static cost captured"
            if ai is not None:
                line += f"  AI {ai:.1f} F/B"
            line += "  (no execute spans yet)"
        out.append(line)


def render_trend(records, width=24):
    """The bench trajectory store as per-key sparkline history.

    ``records`` is the oldest-first output of
    :func:`hyperopt_tpu_torch.obs.trajectory.load`.  Every key any run ever
    reported gets a row — gated keys (obs/trajectory.py
    ``KEY_DIRECTIONS``) first, with their regression direction named, so
    the reader knows which way "up" is before trusting a slope; keys the
    gate doesn't know render too (marked ungated).  Runs missing a key
    are skipped in that key's sparkline (the run count says how many
    contributed).  Mixed-backend histories segment per backend (one
    ``key [backend]`` row each): a tpu→cpu switch is a hardware change,
    not a 1000x regression — the same reason the windowed gate
    backend-matches its history."""
    from .trajectory import KEY_DIRECTIONS

    out = []
    out.append("== bench trajectory " + "=" * 44)
    if not records:
        out.append("  (store is empty — run bench.py or "
                   "`python -m hyperopt_tpu_torch.obs.trajectory backfill`)")
        return "\n".join(out) + "\n"
    for r in records:
        rd = r.get("round")
        out.append(
            f"  {('r%s' % rd) if rd is not None else 'live':<5} "
            f"{r.get('source', '?'):<18} "
            f"rev {r.get('git_rev') or '-':<9} "
            f"backend {r.get('backend') or '?'}")
    out.append("")
    keys = []
    for r in records:
        for k in (r.get("keys") or {}):
            if k not in keys:
                keys.append(k)
    ordered = ([k for k in KEY_DIRECTIONS if k in keys]
               + [k for k in keys if k not in KEY_DIRECTIONS])
    if not ordered:
        out.append("  (no numeric keys recorded yet)")
        return "\n".join(out) + "\n"
    backends = []
    for r in records:
        b = r.get("backend") or "?"
        if b not in backends:
            backends.append(b)
    multi = len(backends) > 1
    w = max(len(k) for k in ordered)
    if multi:
        w += 3 + max(len(b) for b in backends)
    for k in ordered:
        meta = KEY_DIRECTIONS.get(k)
        direction = {"higher": "higher=better",
                     "lower": "lower=better"}.get(
            (meta or {}).get("direction"), "ungated")
        for b in backends:
            recs = [r for r in records
                    if (r.get("backend") or "?") == b] if multi else records
            series = [(r.get("keys") or {}).get(k) for r in recs]
            vals = [v for v in series if isinstance(v, (int, float))]
            if not vals:
                continue
            label = f"{k} [{b}]" if multi else k
            runs = f"{len(vals)}/{len(recs)} {b} runs" if multi else \
                f"{len(vals)}/{len(recs)} runs"
            out.append(
                f"  {label:<{w}}  {_spark(series, width=width):<{width}}  "
                f"{vals[0]:.6g} -> {vals[-1]:.6g}  ({direction}, {runs})")
            if not multi:
                break
    return "\n".join(out) + "\n"


def render_fleet_load(store_root, width=24):
    """The fleet-wide heat view from every replica's durable
    heat ledger under ``<store_root>/fleet/heat/``: one row per shard —
    cumulative heat (the MAX across all replicas' cumulative snapshots,
    so restarts and ownership moves never reset it), the latest owner,
    and a sparkline of the shard's heat history — plus the per-replica
    busy fractions and a SKEW banner when max/mean shard heat exceeds
    the default imbalance bound.  Corrupt ledger lines are counted, not
    fatal (the census read discipline)."""
    from .load import _iter_heat_records, read_heat
    from .slo import LOAD_TARGETS

    merged = read_heat(store_root)
    out = []
    out.append("== fleet load " + "=" * 50)
    out.append(f"  store {store_root}   ledger files {merged['files']}"
               + (f"   CORRUPT {merged['corrupt']}"
                  if merged["corrupt"] else "")
               + (f"   torn {merged['torn']}" if merged["torn"] else ""))
    shards = merged["shards"]
    if not shards:
        out.append("  (no heat records yet — is the fleet serving with "
                   "HYPEROPT_TPU_LOAD armed?)")
        return "\n".join(out) + "\n"
    # per-shard heat history for the sparklines: every record, oldest
    # first (the ledger is append-only per replica; cross-replica order
    # by ts is close enough for a trend line)
    series = {}
    for _fname, rec, _status in _iter_heat_records(store_root):
        if rec is None or rec.get("kind") != "heat":
            continue
        if rec.get("shard") is None:
            continue
        series.setdefault(str(int(rec["shard"])), []).append(
            (float(rec.get("ts") or 0.0), float(rec.get("heat_ms") or 0)))
    heats = {k: v["heat_ms"] for k, v in shards.items()}
    hot = max(heats.values()) or 1.0
    w = max(len(k) for k in shards) + 5
    out.append(f"  {'shard':<{w}} {'heat':>8}  {'share':<12}  "
               f"{'owner':<20}  trend")
    for k in sorted(shards, key=lambda s: -heats[s]):
        s = shards[k]
        hist = [h for _, h in sorted(series.get(k, []))]
        out.append(
            f"  shard{k:<{w - 5}} {heats[k] / 1e3:>7.1f}s  "
            f"[{_bar(heats[k] / hot, 10)}]  "
            f"{str(s.get('replica') or '?')[:20]:<20}  "
            f"{_spark(hist, width=width)}")
    skew = merged["heat_skew"]
    bound = LOAD_TARGETS["imbalance"]["skew_max"]
    line = f"  heat skew {skew:.2f}x (max/mean over {len(shards)} shards)"
    if skew > bound:
        line += f"  SKEW (over the {bound:.1f}x imbalance bound)"
    out.append(line)
    if merged["replicas"]:
        out.append("")
        out.append("  replica busy fractions (latest snapshot each):")
        for rid in sorted(merged["replicas"]):
            r = merged["replicas"][rid]
            busy = float(r.get("busy_frac") or 0.0)
            out.append(f"    {rid[:28]:<28} [{_bar(min(1.0, busy), 12)}] "
                       f"{busy:.0%}")
    return "\n".join(out) + "\n"


def render_tenants(source, width=24):
    """The per-tenant attribution view.  ``source`` is
    either a merged tenant STATUS dict (``GET /tenants`` /
    ``/snapshot``'s ``tenants`` section — full columns) or a store root
    (str — durable fleet-merged tenant heat from the heat ledgers,
    device-time only).  One row per tenant: a budget bar of its share
    of attributed device time, plus asks/tells/sheds and the ask-p99
    column when known; a NOISY-TENANT banner flags a tenant holding
    over half the fleet's attributed time while others wait."""
    out = ["== tenants " + "=" * 53]
    if isinstance(source, str):
        from .tenant import read_tenant_heat

        heat = read_tenant_heat(source)["tenants"]
        table = {t: {"device_ms": ms} for t, ms in heat.items()}
        out.append(f"  store {source}   (durable tenant heat; arm "
                   "HYPEROPT_TPU_TENANT + _LOAD for live columns)")
    else:
        status = source or {}
        table = dict(status.get("table") or {})
        out.append(f"  tracked {status.get('tenants', len(table))}"
                   f"   top-K {status.get('top_k', '?')}"
                   f"   evictions {status.get('evictions', 0)}"
                   f"   sheds {status.get('sheds', 0)}")
    if not table:
        out.append("  (no tenant attribution yet — is the service "
                   "serving with HYPEROPT_TPU_TENANT armed?)")
        return "\n".join(out) + "\n"
    total = sum(float(r.get("device_ms") or 0.0)
                for r in table.values()) or 1.0
    w = min(24, max(len(t) for t in table) + 2)
    out.append(f"  {'tenant':<{w}} {'device':>8}  {'share':<14}  "
               f"{'asks':>6} {'tells':>6} {'sheds':>6}  ask_p99")
    noisy = None
    for t in sorted(table,
                    key=lambda k: -float(table[k].get("device_ms") or 0)):
        r = table[t]
        ms = float(r.get("device_ms") or 0.0)
        share = ms / total
        if noisy is None and share > 0.5 and len(table) > 1:
            noisy = (t, share)
        p99 = r.get("ask_p99_ms")
        out.append(
            f"  {t[:w]:<{w}} {ms / 1e3:>7.1f}s  [{_bar(share, 10)}]  "
            f"{r.get('asks', '-'):>6} {r.get('tells', '-'):>6} "
            f"{r.get('sheds', '-'):>6}  "
            + (f"{p99:.0f}ms" if p99 is not None else "-"))
    if noisy is not None:
        out.append(f"  NOISY-TENANT {noisy[0]!r} holds {noisy[1]:.0%} of "
                   f"attributed device time (fair-share packing + "
                   f"HYPEROPT_TPU_TENANT_QUOTA bound it)")
    return "\n".join(out) + "\n"


def _profile_section(profile_recs, out):
    """On-demand / stall device captures recorded by obs/profiler.py: the
    pointers from this stream to its device-timeline artifacts."""
    if not profile_recs:
        return
    out.append("")
    out.append("== device captures " + "=" * 45)
    for r in profile_recs:
        if r.get("ok"):
            out.append(f"  {r.get('reason', '?'):<10} "
                       f"{_fmt_sec(r.get('wall_sec')):>8}  "
                       f"{r.get('trace_json') or r.get('dir', '?')}")
        else:
            out.append(f"  {r.get('reason', '?'):<10} FAILED  "
                       f"{r.get('error', '?')}")


# ---------------------------------------------------------------------------
# the shared headline serializer (``--format json`` == ``/snapshot``)
# ---------------------------------------------------------------------------


def headline_sections(phases, metrics, device_metrics, wall_sec=None):
    """The four headline report sections as pure data — report (phase
    breakdown), health, utilization, ask_pipeline.

    ONE serializer for both consumers: the live ``/snapshot`` endpoint
    (obs/serve.py) feeds it the tracer's phase totals + live registry
    snapshots, ``obs.report --format json`` feeds it the same shapes
    recovered from a recorded stream — so the two outputs can never drift
    (tests/test_serve.py golden-pins the structure).

    ``phases``: ``{name: {"sec", "count"}}``; ``metrics`` /
    ``device_metrics``: snapshotted metric dicts (the ``"metrics"`` value
    of ``MetricsRegistry.snapshot()``).
    """
    from .health import roofline_table, utilization_from_metrics

    total = sum(e.get("sec", 0.0) for e in phases.values()) or 1.0
    report = {
        name: {"sec": e.get("sec", 0.0), "count": e.get("count", 0),
               "frac": e.get("sec", 0.0) / total}
        for name, e in sorted(phases.items())
    }

    health = {"asks": metrics.get("health.asks", 0)}
    if health["asks"]:
        health.update(
            proposals=metrics.get("health.proposals", 0),
            prior_fallbacks=metrics.get("health.prior_fallbacks", 0),
            last_ei_p50=metrics.get("health.last_ei_p50"),
            last_dup_rate=metrics.get("health.last_dup_rate"),
            n_below=metrics.get("health.n_below"),
            n_above=metrics.get("health.n_above"),
            ei_p50=metrics.get("health.ei_p50"),
            dup_rate=metrics.get("health.dup_rate"),
        )

    blocked = metrics.get("ask.blocked_sec")
    ask_pipeline = {
        "calls": metrics.get("suggest.calls", 0),
        "speculative": metrics.get("suggest.speculative", 0),
        "inflight": metrics.get("suggest.inflight", 0),
        "queue_depth": metrics.get("queue_depth", 0),
        "blocked_sec": blocked if isinstance(blocked, dict) else None,
    }

    return {
        "report": report,
        "health": health,
        "utilization": utilization_from_metrics(device_metrics,
                                                wall_sec=wall_sec),
        # per-program roofline: static cost × measured execute spans, with
        # each program's share of the suggest phase wall clock — the
        # kernel-attribution view, live on /snapshot and offline here
        "roofline": roofline_table(device_metrics, phases=phases),
        "ask_pipeline": ask_pipeline,
    }


def _stream_sections(records):
    """Recover :func:`headline_sections` inputs from a recorded stream:
    phase totals re-aggregated from spans (same wall-clock-by-name sum the
    live ``PhaseTimings`` accumulates), metric dicts from the final
    embedded snapshot."""
    phases = {}
    for s in records:
        if s.get("kind") != "span" or s.get("aggregate") is False:
            # aggregate=False umbrella spans are excluded from the live
            # totals too — offline and live rebuild the SAME dict
            continue
        e = phases.setdefault(s["name"], {"sec": 0.0, "count": 0})
        e["sec"] += s.get("wall_sec", 0.0)
        e["count"] += 1
    metric_recs = [r for r in records if r.get("kind") == "metrics"]
    snap = metric_recs[-1].get("snapshot", {}) if metric_recs else {}
    metrics = snap.get("metrics", {})
    device = ((snap.get("shared") or {}).get("device") or {}).get(
        "metrics", {})
    run_ids = sorted({r["run_id"] for r in records if r.get("run_id")})
    return {"run_id": ",".join(run_ids) or None,
            "sections": headline_sections(phases, metrics, device)}


def json_report(streams, merge=False):
    """``--format json``: the machine-readable headline sections for one
    stream (or per controller with ``--merge``), via the SAME serializer
    the live ``/snapshot`` endpoint uses."""
    if not merge:
        return _stream_sections(streams[0][1])
    return {"merged": True,
            "controllers": {name: _stream_sections(recs)
                            for name, recs in streams}}


def render(records, top=5):
    """Build the report text from parsed JSONL records."""
    spans = [r for r in records if r.get("kind") == "span"]
    trial_events = [r for r in records if r.get("kind") == "trial_event"]
    metric_recs = [r for r in records if r.get("kind") == "metrics"]
    health_recs = [r for r in records if r.get("kind") == "health"]
    devmem_recs = [r for r in records if r.get("kind") == "devmem"]
    profile_recs = [r for r in records if r.get("kind") == "profile"]
    events = [r for r in records if r.get("kind") == "event"]

    out = []
    out.append("== phase-time breakdown " + "=" * 40)
    _phase_section(spans, out)
    _pipeline_section(spans, _last_snapshot_metrics(records), out)
    _resilience_section(_last_snapshot_metrics(records), out)
    _service_section(_last_snapshot_metrics(records), out)
    _quality_section(_last_snapshot_metrics(records), events, out)
    _storage_section(_last_snapshot_metrics(records), out)
    _probe_section(_last_snapshot_metrics(records), out)
    _megakernel_section(_last_snapshot_metrics(records), spans, out)
    _roofline_section(records, spans, out)
    _profile_section(profile_recs, out)
    out.append("")
    out.append("== search health " + "=" * 47)
    _health_section(health_recs, out)
    _devmem_section(devmem_recs, out)
    out.append("")
    out.append("== trial-state waterfall " + "=" * 39)
    _waterfall_section(trial_events, out)
    out.append("")
    out.append(f"== top-{top} slowest trials " + "=" * 38)
    _slowest_section(trial_events, out, top=top)
    out.append("")
    out.append("== metrics snapshot " + "=" * 44)
    _metrics_section(metric_recs, out)
    if events:
        out.append("")
        out.append("== events " + "=" * 54)
        for r in events:
            attrs = r.get("attrs", {})
            out.append(f"  {r['name']}  " + json.dumps(attrs, default=str))
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# cross-controller merge view (fmin_multihost per-process streams)
# ---------------------------------------------------------------------------

# ``fmin_multihost``'s allgather latency histograms, in schedule order — the merge
# view's skew table compares their per-controller means
_ALLGATHER_METRICS = (
    "allgather.resume_sec",
    "allgather.proposals_sec",
    "allgather.results_sec",
    "allgather.losses_sec",  # pre-payload streams (renamed to results)
    "allgather.checksum_sec",
)

_DIVERGENCE_EVENTS = ("controller_divergence", "resume_disagreement")


def _last_snapshot_metrics(records):
    metric_recs = [r for r in records if r.get("kind") == "metrics"]
    if not metric_recs:
        return {}
    return (metric_recs[-1].get("snapshot") or {}).get("metrics", {})


def _controller_summary(name, records):
    spans = [r for r in records if r.get("kind") == "span"]
    metrics = _last_snapshot_metrics(records)
    run_ids = sorted({r["run_id"] for r in records if r.get("run_id")})
    ts = [r["ts"] for r in records if "ts" in r]
    return {
        "name": name,
        "run_ids": run_ids,
        "spans": spans,
        "metrics": metrics,
        "generations": metrics.get("generations"),
        "t0": min(ts) if ts else None,
        "t1": max(ts) if ts else None,
        "events": [r for r in records if r.get("kind") == "event"
                   and r.get("name") in _DIVERGENCE_EVENTS],
    }


def render_merged(streams):
    """Cross-controller view over per-controller JSONL streams from one
    ``fmin_multihost`` run: summary + allgather skew + per-controller
    phase breakdown + correlated divergence context.  ``streams`` is a
    list of ``(name, records)``."""
    ctrls = [_controller_summary(name, recs) for name, recs in streams]
    out = []

    out.append("== controllers " + "=" * 49)
    w = max(len(c["name"]) for c in ctrls)
    for c in ctrls:
        gens = c["generations"]
        wall = (c["t1"] - c["t0"]) if c["t0"] is not None else None
        out.append(
            f"  {c['name']:<{w}}  run_id={','.join(c['run_ids']) or '?'}"
            f"  gens={gens if gens is not None else '?'}"
            f"  spans={len(c['spans'])}  wall={_fmt_sec(wall)}")

    out.append("")
    out.append("== allgather skew " + "=" * 46)
    any_row = False
    for metric in _ALLGATHER_METRICS:
        means = {}
        for c in ctrls:
            h = c["metrics"].get(metric)
            if isinstance(h, dict) and h.get("count"):
                means[c["name"]] = h["mean"]
        if not means:
            continue
        any_row = True
        vals = list(means.values())
        skew = max(vals) - min(vals)
        ratio = (max(vals) / min(vals)) if min(vals) > 0 else float("inf")
        per = "  ".join(f"{n} {_fmt_sec(m)}" for n, m in sorted(means.items()))
        out.append(f"  {metric:<26} {per}  skew {_fmt_sec(skew)}"
                   f" ({ratio:.1f}x)")
    if not any_row:
        out.append("  (no allgather metrics in the streams — single-process"
                   " run, or metrics snapshots missing)")

    # per-controller device memory: each controller samples its OWN devices
    # (obs/devmem.py), so the merged view is the cluster's HBM picture
    from .devmem import roll_up

    dm_rows = []
    for name, recs in streams:
        dms = [r for r in recs if r.get("kind") == "devmem"]
        if not dms:
            continue
        rolls = [roll_up(r.get("devices", [])) for r in dms]
        peaks = [r[1] for r in rolls if r[1] is not None]
        limits = [r[2] for r in rolls if r[2] is not None]
        hist = (dms[-1].get("census") or {}).get("history", {})
        dm_rows.append((name, len(dms),
                        max(peaks) if peaks else None,
                        max(limits) if limits else None,
                        hist.get("bytes")))
    if dm_rows:
        out.append("")
        out.append("== device memory per controller " + "=" * 32)
        w = max(len(n) for n, *_ in dm_rows)
        for name, n, peak, limit, hist_b in dm_rows:
            line = (f"  {name:<{w}}  samples {n}"
                    f"  peak {_fmt_bytes(peak):>10}")
            if limit:
                line += f"  limit {_fmt_bytes(limit):>10}"
                if peak is not None:
                    line += f"  peak watermark {peak / limit:.0%}"
            if hist_b is not None:
                line += f"  history {_fmt_bytes(hist_b)}"
            out.append(line)

    out.append("")
    out.append("== per-controller phase breakdown " + "=" * 30)
    for c in ctrls:
        out.append(f"  -- {c['name']}")
        _phase_section(c["spans"], out)

    out.append("")
    out.append("== divergence context " + "=" * 42)
    dumps = [(c["name"], e) for c in ctrls for e in c["events"]]
    if not dumps:
        out.append("  (no divergence events — every generation's fold"
                   " checksummed identically)")
    else:
        for name, e in sorted(dumps, key=lambda ne: ne[1].get("ts", 0)):
            attrs = e.get("attrs", {})
            out.append(f"  {name}: {e['name']}  "
                       + json.dumps(attrs, sort_keys=True, default=str))
        # correlate: which (gen, n_done) points diverged, seen by whom
        keyed = {}
        for name, e in dumps:
            a = e.get("attrs", {})
            keyed.setdefault((a.get("gen"), a.get("n_done")),
                             []).append(name)
        for (gen, n_done), names in sorted(keyed.items(),
                                           key=lambda kv: str(kv[0])):
            out.append(f"  gen={gen} n_done={n_done}: reported by "
                       + ", ".join(sorted(names)))
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# post-mortem view (flight-recorder dumps — obs/flight.py)
# ---------------------------------------------------------------------------


def _last_moments(records, death_ts, out, tail=12):
    """The ring's final records, as a T-minus timeline."""
    shown = [r for r in records
             if r.get("kind") in ("span", "event", "trial_event", "stall",
                                  "health", "devmem") and "ts" in r][-tail:]
    if not shown:
        out.append("  (empty ring)")
        return
    for r in shown:
        dt = death_ts - r["ts"]
        kind = r.get("kind")
        if kind == "span":
            # a span's ts is its START; the ring appended it at its END —
            # show when it finished so the timeline reads in ring order
            dt = death_ts - (r["ts"] + (r.get("wall_sec") or 0.0))
            what = (f"span {r.get('name', '?')} "
                    f"({_fmt_sec(r.get('wall_sec'))})")
            if r.get("error"):
                what += f"  error={r['error']}"
        elif kind == "trial_event":
            what = f"{r.get('event', '?')} tid={r.get('tid')}"
        elif kind == "stall":
            what = (f"STALL  quiet {_fmt_sec(r.get('quiet_for_sec'))}  "
                    f"(#{r.get('stall_count', '?')})")
        elif kind == "health":
            what = f"health ask ({r.get('algo', '?')})"
        elif kind == "devmem":
            census = r.get("census") or {}
            tot = census.get("total", {})
            devs = [d.get("bytes_in_use") for d in r.get("devices", [])
                    if d.get("bytes_in_use") is not None]
            what = (f"devmem  in-use {_fmt_bytes(max(devs) if devs else None)}"
                    f"  live {_fmt_bytes(tot.get('bytes'))}"
                    f" (x{tot.get('count', '?')})")
        else:
            what = f"event {r.get('name', '?')}"
        out.append(f"  T-{dt:8.2f}s  {what}")


def render_postmortem(records, name=None):
    """A flight dump (or any obs stream) as a last-moments narrative:
    death reason, open spans at death, last heartbeat per component,
    stall reports, in-flight trials, tail of the ring."""
    recs = list(records)
    dumps = [r for r in recs if r.get("kind") == "flight_dump"]
    open_spans = [r for r in recs if r.get("kind") == "open_span"]
    beat_recs = [r for r in recs if r.get("kind") == "last_heartbeats"]
    stalls = [r for r in recs if r.get("kind") == "stall"]
    trial_events = [r for r in recs if r.get("kind") == "trial_event"]
    ts_all = [r["ts"] for r in recs if "ts" in r]
    death_ts = dumps[-1]["ts"] if dumps else (max(ts_all) if ts_all else 0.0)

    out = []
    out.append("== flight dump " + "=" * 49)
    if dumps:
        d = dumps[-1]
        out.append(f"  reason={d.get('reason', '?')}  pid={d.get('pid', '?')}"
                   f"  records={d.get('n_records', '?')}"
                   + (f"  stream={name}" if name else ""))
    else:
        out.append("  (no flight_dump header — rendering a live stream as a "
                   "post-mortem)")

    out.append("")
    out.append("== open spans at death " + "=" * 41)
    if open_spans:
        w = max(len(r.get("name", "?")) for r in open_spans)
        for r in sorted(open_spans, key=lambda r: -r.get("age_sec", 0.0)):
            out.append(f"  {r.get('name', '?'):<{w}}  open for "
                       f"{_fmt_sec(r.get('age_sec')):>9}  "
                       f"thread {r.get('thread', '?')}")
    else:
        out.append("  (none — the process died between spans)")

    out.append("")
    out.append("== last heartbeats " + "=" * 45)
    beats = (beat_recs[-1].get("beats") or {}) if beat_recs else {}
    if beats:
        w = max(len(c) for c in beats)
        for comp, b in sorted(beats.items(),
                              key=lambda kv: kv[1].get("age_sec", 0.0)):
            line = (f"  {comp:<{w}}  {_fmt_sec(b.get('age_sec')):>9} before "
                    f"death")
            detail = b.get("detail")
            if detail:
                line += "  " + json.dumps(detail, sort_keys=True, default=str)
            out.append(line)
    else:
        out.append("  (no heartbeat record — watchdog disabled or never fed)")

    out.append("")
    out.append("== stalls " + "=" * 54)
    if stalls:
        s = stalls[-1]
        out.append(f"  {len(stalls)} stall record(s); last: quiet for "
                   f"{_fmt_sec(s.get('quiet_for_sec'))} "
                   f"(threshold {_fmt_sec(s.get('quiet_sec'))})")
        for tname, frames in sorted((s.get("stacks") or {}).items()):
            out.append(f"  thread {tname}:")
            for fr in frames[-4:]:
                out.append(f"    {fr}")
    else:
        out.append("  (no stall records — the run was heartbeating until "
                   "death)")

    out.append("")
    out.append("== in-flight trials " + "=" * 44)
    timelines = _trial_timelines(trial_events)
    inflight = []
    for tid, t in sorted(timelines.items()):
        if TRIAL_FINISHED in t or TRIAL_CANCELLED in t:
            continue
        start = t.get(TRIAL_CLAIMED, t.get(TRIAL_NEW))
        state = "claimed" if TRIAL_CLAIMED in t else "queued"
        age = (death_ts - start) if start is not None else None
        inflight.append(f"  tid {tid:>6}  {state} "
                        f"{_fmt_sec(age):>9} before death")
    out.extend(inflight if inflight
               else ["  (none — no trial was mid-evaluation)"])

    # device captures pinned in the flight ring (obs/profiler.py): the
    # stall escalation's bounded trace — a hang's postmortem points at
    # the device timeline artifact, not just host stacks
    _profile_section([r for r in recs if r.get("kind") == "profile"], out)

    # the memory narrative (devmem tail + at-death census attached by the
    # flight recorder when the sampler was armed — OOMs die explained)
    devmem_recs = [r for r in recs if r.get("kind") == "devmem"]
    census_recs = [r for r in recs if r.get("kind") == "devmem_census"]
    if devmem_recs or census_recs:
        _devmem_section(devmem_recs, out)
        if census_recs:
            census = census_recs[-1].get("census") or {}
            parts = [f"{o} {_fmt_bytes(b['bytes'])} (x{b['count']})"
                     for o, b in sorted(census.items()) if o != "total"]
            out.append("  at-death census: " + ("  ".join(parts) or "(empty)"))

    out.append("")
    out.append("== last records " + "=" * 48)
    _last_moments(recs, death_ts, out)
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# per-study audit timeline (obs.report --study <id>)
# ---------------------------------------------------------------------------

#: the WAL record kinds that belong to a study's durable timeline
_WAL_KINDS = ("admit", "snapshot", "ask", "tell", "close")


def study_timeline_events(study_id, streams):
    """Join one study's lifecycle out of mixed JSONL streams.

    ``streams`` is ``[(name, records)]`` — typically the service WAL
    (``service.wal.jsonl``) plus any obs/flight/access streams the
    caller has.  Returns ``(events, trace_hops)``:

    * ``events`` — the study's WAL records (admit/ask/tell/void/close/
      snapshot), each tagged with its source stream, sorted by ``ts``
      (records without one — journals older than request tracing — keep file order at
      the front);
    * ``trace_hops`` — ``{trace_id: [span/access records]}`` for every
      trace id the study's records name, joined across ALL streams (the
      client→handler→wave→device correlation arc).
    """
    # materialize up front: the streams are walked TWICE (events, then
    # trace joins), and a caller handing iter_jsonl generators would
    # otherwise silently lose the whole correlation view on pass 2
    streams = [(name, list(records)) for name, records in streams]
    events = []
    traces = set()
    for name, records in streams:
        for r in records:
            if not isinstance(r, dict):
                continue
            kind = r.get("kind")
            if kind in _WAL_KINDS and r.get("sid") == study_id:
                events.append({**r, "_src": name})
                if r.get("trace"):
                    traces.add(r["trace"])
            elif kind == "access" and r.get("study_id") == study_id \
                    and r.get("trace"):
                traces.add(r["trace"])
    order = {id(e): i for i, e in enumerate(events)}
    events.sort(key=lambda e: (e.get("ts") is not None, e.get("ts") or 0.0,
                               order[id(e)]))
    trace_hops = {t: [] for t in traces}
    if traces:
        for name, records in streams:
            for r in records:
                if not isinstance(r, dict):
                    continue
                attrs = r.get("attrs") or {}
                hits = set()
                t = r.get("trace") or attrs.get("trace")
                if t in trace_hops:
                    hits.add(t)
                for t in attrs.get("links") or []:
                    if t in trace_hops:
                        hits.add(t)
                for t in hits:
                    trace_hops[t].append({**r, "_src": name})
        for hops in trace_hops.values():
            hops.sort(key=lambda r: r.get("ts") or 0.0)
    return events, trace_hops


def render_study_timeline(study_id, streams):
    """``--study``: one study's full lifecycle as a T+ timeline — every
    admit/ask/tell/void/evict/close/resume boundary from the WAL, each
    ask's wave/algo/degrade flags and trace id, plus the cross-stream
    correlation arc for every trace the study's records name."""
    events, trace_hops = study_timeline_events(study_id, streams)
    out = []
    out.append(f"== study timeline: {study_id} " + "=" * max(
        1, 46 - len(study_id)))
    if not events:
        out.append("  (no WAL records for this study in "
                   + ", ".join(n for n, _ in streams) + ")")
        return "\n".join(out) + "\n"
    t0 = next((e["ts"] for e in events if e.get("ts") is not None), 0.0)
    asks = tells = voids = degraded = 0
    for e in events:
        ts = e.get("ts")
        stamp = f"T+{ts - t0:9.3f}s" if ts is not None else "T+    ?    "
        kind = e["kind"]
        if kind == "admit":
            what = (f"admit     seed={e.get('seed')}"
                    + (f"  kwargs={e.get('kwargs')}" if e.get("kwargs")
                       else ""))
        elif kind == "snapshot":
            # a snapshot record is a compaction boundary: everything
            # before it was folded into this one registry entry —
            # after a crash-resume this is where replay picked up
            what = (f"snapshot  (compaction/resume boundary)  "
                    f"state={e.get('state')}  n_asked={e.get('n_asked')}"
                    f"  n_told={e.get('n_told')}")
        elif kind == "ask":
            algo = e.get("algo")
            if algo == "void":
                voids += 1
                what = f"void      tids={e.get('tids')}  (failed/shed ask)"
            else:
                asks += 1
                what = f"ask       tids={e.get('tids')}  algo={algo}"
                if algo == "rand":
                    degraded += 1
                    what += "  [startup or DEGRADED]"
        elif kind == "tell":
            tells += 1
            what = (f"tell      tid={e.get('tid')}  loss={e.get('loss')}"
                    + (f"  status={e['status']}" if e.get("status")
                       else ""))
        elif kind == "close":
            what = "close"
        else:  # pragma: no cover - _WAL_KINDS is closed
            what = kind
        if e.get("trace"):
            what += f"  trace={e['trace'][:16]}.."
        out.append(f"  {stamp}  {what}")
    out.append(f"  summary: {asks} asks ({degraded} rand-served, "
               f"{voids} void), {tells} tells")
    shown = {t: hops for t, hops in trace_hops.items() if hops}
    if shown:
        out.append("")
        out.append("== request correlation " + "=" * 41)
        for t in sorted(shown):
            hops = shown[t]
            arc = " -> ".join(
                f"{h.get('name') or h.get('kind')}"
                + (f"[{h['attrs']['wave']}]"
                   if (h.get("attrs") or {}).get("wave") is not None
                   else "")
                for h in hops[:8])
            out.append(f"  {t[:16]}..  {arc}"
                       + ("  (+%d more)" % (len(hops) - 8)
                          if len(hops) > 8 else ""))
    return "\n".join(out) + "\n"


def _study_streams(paths):
    """Resolve ``--study`` inputs: a directory means a store root (its
    ``service.wal.jsonl`` is the stream); files are read as JSONL."""
    from ..service.journal import wal_path_for

    streams = []
    for path in paths:
        p = wal_path_for(path) if os.path.isdir(path) else path
        if not os.path.exists(p):
            raise OSError(f"no such stream: {p}")
        streams.append((os.path.basename(p), read_jsonl(p)))
    return streams


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m hyperopt_tpu_torch.obs.report",
        description="Render a hyperopt_tpu obs JSONL stream.")
    p.add_argument("jsonl", nargs="*",
                   help="telemetry stream(s) written by an armed run, or "
                        "flight dump(s) with --postmortem, or the "
                        "trajectory store with --trend (default: the "
                        "repo's .obs/trajectory.jsonl)")
    p.add_argument("--top", type=int, default=5,
                   help="how many slowest trials to list (single-stream "
                        "report only)")
    p.add_argument("--merge", action="store_true",
                   help="treat the inputs as per-controller streams from "
                        "one fmin_multihost run and render the "
                        "cross-controller view")
    p.add_argument("--postmortem", action="store_true",
                   help="render flight-recorder dump(s) as a last-moments "
                        "narrative")
    p.add_argument("--export-trace", metavar="OUT",
                   help="write Chrome/Perfetto trace-event JSON to OUT "
                        "instead of rendering (each input stream becomes "
                        "its own process track group)")
    p.add_argument("--format", choices=("text", "json"), default="text",
                   help="json: machine-readable headline sections "
                        "(report/health/utilization/ask-pipeline) via the "
                        "same serializer the live /snapshot endpoint uses")
    p.add_argument("--trend", action="store_true",
                   help="render the bench trajectory store "
                        "(.obs/trajectory.jsonl) as per-key sparkline "
                        "history instead of a run report")
    p.add_argument("--fleet", metavar="STORE_ROOT", default=None,
                   help="render the fleet-wide load view from the durable "
                        "heat ledgers under STORE_ROOT/fleet/heat/: merged "
                        "per-shard heat with sparklines, replica busy "
                        "fractions, and a SKEW banner on imbalance")
    p.add_argument("--tenants", metavar="SRC", default=None,
                   help="render the per-tenant attribution view: SRC is "
                        "a store root (durable fleet-merged tenant heat "
                        "from the heat ledgers) or a JSON file holding a "
                        "GET /tenants (or /snapshot) payload — budget "
                        "bars per tenant + a NOISY-TENANT banner")
    p.add_argument("--probes", metavar="PATH", default=None,
                   help="render the blackbox-probe verdict view from the "
                        "durable probe ledger(s): a <replica>.jsonl "
                        "ledger file, a fleet/probes dir, or the store "
                        "root — verdict census, golden provenance and "
                        "detection-latency stats per replica")
    p.add_argument("--study", metavar="ID", default=None,
                   help="render one study's audit timeline from the "
                        "service WAL (give the WAL file or the --store "
                        "root; extra obs/flight/access streams join the "
                        "request-correlation view)")
    args = p.parse_args(argv)
    if args.probes is not None:
        if (args.merge or args.postmortem or args.export_trace
                or args.trend or args.study or args.fleet):
            print("error: --probes is its own view; it does not combine "
                  "with --merge/--postmortem/--export-trace/--trend/"
                  "--study/--fleet", file=sys.stderr)
            return 2
        if args.format == "json":
            # erroring beats a scripted consumer silently getting text:
            # the ledgers are already machine-readable sealed JSONL and
            # the live view is served as JSON by GET /probes
            print("error: --probes renders text only; for machine-"
                  "readable verdicts GET /probes or read the ledgers "
                  "under fleet/probes/", file=sys.stderr)
            return 2
        if not os.path.exists(args.probes):
            print(f"error: no probe ledger or store at {args.probes}",
                  file=sys.stderr)
            return 2
        sys.stdout.write(render_probes(args.probes))
        return 0
    if args.tenants is not None:
        if (args.merge or args.postmortem or args.export_trace
                or args.trend or args.study or args.fleet):
            print("error: --tenants is its own view; it does not combine "
                  "with --merge/--postmortem/--export-trace/--trend/"
                  "--study/--fleet", file=sys.stderr)
            return 2
        if args.format == "json":
            # erroring beats a scripted consumer silently getting text:
            # the live view is already served as JSON by GET /tenants
            print("error: --tenants renders text only; for machine-"
                  "readable tables GET /tenants or read the heat "
                  "ledgers under fleet/heat/", file=sys.stderr)
            return 2
        if os.path.isdir(args.tenants):
            sys.stdout.write(render_tenants(args.tenants))
            return 0
        if not os.path.exists(args.tenants):
            print(f"error: no store root or payload file at "
                  f"{args.tenants}", file=sys.stderr)
            return 2
        try:
            with open(args.tenants, encoding="utf-8") as f:
                payload = json.load(f)
        except (OSError, ValueError) as e:
            print(f"error: cannot read {args.tenants}: {e}",
                  file=sys.stderr)
            return 2
        if isinstance(payload, dict) and "tenants" in payload \
                and isinstance(payload["tenants"], dict):
            # a /snapshot (or /fleet/load) payload: unwrap its section
            payload = payload["tenants"]
        sys.stdout.write(render_tenants(payload))
        return 0
    if args.fleet is not None:
        if (args.merge or args.postmortem or args.export_trace
                or args.trend or args.study):
            print("error: --fleet is its own view; it does not combine "
                  "with --merge/--postmortem/--export-trace/--trend/"
                  "--study", file=sys.stderr)
            return 2
        if args.format == "json":
            # erroring beats a scripted consumer silently getting text:
            # the merged view is already served as JSON by /fleet/load
            print("error: --fleet renders text only; for machine-"
                  "readable heat GET /fleet/load or read the ledgers "
                  "under fleet/heat/", file=sys.stderr)
            return 2
        if not os.path.isdir(args.fleet):
            print(f"error: no store root at {args.fleet}",
                  file=sys.stderr)
            return 2
        sys.stdout.write(render_fleet_load(args.fleet))
        return 0
    if args.study is not None:
        if args.merge or args.postmortem or args.export_trace or args.trend:
            print("error: --study is its own view; it does not combine "
                  "with --merge/--postmortem/--export-trace/--trend",
                  file=sys.stderr)
            return 2
        if args.format == "json":
            # erroring beats a scripted consumer silently getting text:
            # the WAL records behind the view are already JSONL
            print("error: --study renders text only; for machine-"
                  "readable records read the WAL (service.wal.jsonl) "
                  "or GET /study/<id>/timeline", file=sys.stderr)
            return 2
        if not args.jsonl:
            p.error("--study needs the service WAL (or store root), plus "
                    "any extra streams to correlate")
        try:
            streams = _study_streams(args.jsonl)
        except OSError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        sys.stdout.write(render_study_timeline(args.study, streams))
        return 0
    if args.format == "json" and args.postmortem:
        print("error: --format json applies to the report/merge views, "
              "not --postmortem", file=sys.stderr)
        return 2
    if args.trend:
        if args.merge or args.postmortem or args.export_trace:
            print("error: --trend is its own view; it does not combine "
                  "with --merge/--postmortem/--export-trace",
                  file=sys.stderr)
            return 2
        if args.format == "json":
            # erroring beats a scripted consumer silently getting text:
            # the store is already machine-readable JSONL
            print("error: --trend renders text only; for machine-readable "
                  "history use `python -m hyperopt_tpu_torch.obs.trajectory "
                  "show`", file=sys.stderr)
            return 2
        if len(args.jsonl) > 1:
            print("error: --trend takes one trajectory store, got "
                  f"{len(args.jsonl)} paths", file=sys.stderr)
            return 2
        from .trajectory import load, trajectory_path

        path = args.jsonl[0] if args.jsonl else trajectory_path()
        if not os.path.exists(path):
            print(f"error: no trajectory store at {path} — run bench.py "
                  "or `python -m hyperopt_tpu_torch.obs.trajectory backfill`",
                  file=sys.stderr)
            return 2
        sys.stdout.write(render_trend(load(path)))
        return 0
    if not args.jsonl:
        p.error("give telemetry stream(s), or --trend")
    for path in args.jsonl:
        if not os.path.exists(path):
            print(f"error: cannot read {path}: no such file",
                  file=sys.stderr)
            return 2
    if args.export_trace:
        from .export import write_trace

        # device captures referenced by kind="profile" records merge in
        # automatically, collected DURING the single conversion pass (a
        # vanished capture degrades to a skipped track group).  Safe
        # because export_trace consumes every host stream before it reads
        # device_traces, so the teed list is complete by then.
        device_traces = []

        def _tee_profiles(path):
            # capture paths were recorded relative to the RUN's cwd; when
            # the export runs elsewhere, retry them relative to the
            # stream file (run.jsonl and prof/ usually share a directory)
            base = os.path.dirname(os.path.abspath(path))
            for r in iter_jsonl(path):
                if (isinstance(r, dict) and r.get("kind") == "profile"
                        and r.get("ok") and r.get("trace_json")):
                    tj = r["trace_json"]
                    if not os.path.exists(tj):
                        alt = os.path.join(base, tj)
                        tj = alt if os.path.exists(alt) else None
                    if tj is None:
                        print(f"warning: skipping device capture "
                              f"{r.get('dir') or r['trace_json']}: artifact "
                              f"{r['trace_json']} not found (moved? or "
                              "export running from a different directory "
                              "than the run)", file=sys.stderr)
                    else:
                        device_traces.append((
                            os.path.basename(r.get("dir") or tj),
                            tj, r.get("t0")))
                yield r

        # iter_jsonl avoids holding the raw JSONL in memory; the converted
        # trace events themselves still accumulate for the final sort, so
        # peak memory is one event dict per record
        n = write_trace(args.export_trace,
                        [(os.path.basename(path), _tee_profiles(path))
                         for path in args.jsonl],
                        device_traces=device_traces)
        merged = (f" (+{len(device_traces)} device capture(s) merged)"
                  if device_traces else "")
        print(f"wrote {n} trace events to {args.export_trace}{merged} "
              "(load in https://ui.perfetto.dev)")
        return 0
    if len(args.jsonl) > 1 and not (args.merge or args.postmortem):
        print("error: multiple streams require --merge", file=sys.stderr)
        return 2
    streams = []
    for path in args.jsonl:
        try:
            records = read_jsonl(path)
        except OSError as e:
            print(f"error: cannot read {path}: {e}", file=sys.stderr)
            return 2
        streams.append((os.path.basename(path), records))
    if not any(recs for _, recs in streams):
        print("error: no telemetry records in "
              + ", ".join(args.jsonl), file=sys.stderr)
        return 1
    if args.format == "json":
        json.dump(json_report(streams, merge=args.merge), sys.stdout,
                  indent=2, sort_keys=True, default=str)
        sys.stdout.write("\n")
    elif args.postmortem:
        for name, recs in streams:
            sys.stdout.write(render_postmortem(recs, name=name))
    elif args.merge:
        sys.stdout.write(render_merged(streams))
    else:
        sys.stdout.write(render(streams[0][1], top=args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
