"""Search-health diagnostics and device-utilization accounting
(counterpart of ``hyperopt_tpu/obs/health.py``).

**Search health.**  When a run is armed (``fmin(..., obs="run.jsonl")``)
the TPE tick computes, beside its proposals, a small per-label stats
vector per ask (:data:`HEALTH_STATS`: EI quantiles, the selected
candidate's EI rank, the duplicate-candidate rate, the below model's
effective component count and prior-mass fraction, the ε-prior take
flag) from arrays the proposal already holds, with no extra draw, and
reads it back in the same single transfer as the proposals;
:func:`record_tpe_health` folds it into the run's metrics namespace and
JSONL stream.  ``rand``/``anneal`` proposals get the cheap subset
(duplicate rate and spread across the batch) from the host values they
already read (:func:`record_proposal_health`).  A disarmed run pays one
``getattr`` per ask: its tick is launch for launch what it was.

**Device utilization.**  The JAX package reads each compiled program's
FLOPs and bytes from XLA's ``cost_analysis()``.  Torch has no such
table, so the port counts analytically from the shapes the ``ei_diff``
kernel is launched at (``megakernel.ei_cost``, the same yardstick as
``chip_smoke.py``'s roofline): :func:`record_program_cost` sets
``<program>.flops`` / ``<program>.bytes`` gauges in the process-global
``"device"`` namespace (``suggest.tpe`` per TPE ask, ``chunk`` per TPE
chunk of the device loop).  Those "flops" are the kernel's exponentials
and its bytes the kernel's least traffic: a lower bound on the
program's work, which also runs sampling, fitting and selection in
torch ops.  The gauge ``<program>.exp_ops`` = 1 marks such a count; it
rides the run's metrics snapshot, so either package's report shows it
beside the roofline row it qualifies.  :func:`utilization_snapshot`
joins the costs with the measured ``execute_sec`` histograms (wall time
around dispatch → readback; the device loop's chunk is timed by CUDA
events) into achieved rates and busy fractions.

**Multi-controller merge.**  :func:`controller_stream_path` names the
per-controller JSONL streams ``fmin_multihost`` writes (``run.p<i>.jsonl``);
``python -m hyperopt_tpu_torch.obs.report --merge`` renders them together.
"""

from __future__ import annotations

import os
import time

import numpy as np

from .metrics import get_metrics

__all__ = [
    "HEALTH_STATS",
    "record_tpe_health",
    "record_proposal_health",
    "live_health_postfix",
    "record_program_cost",
    "ei_launch_cost",
    "utilization_snapshot",
    "utilization_from_metrics",
    "roofline_table",
    "controller_stream_path",
]

#: order of the per-label stat vector the armed TPE tick packs
#: (``algos/tpe.py``: ``_diag_stats``): the contract between device and host
HEALTH_STATS = (
    "ei_p10",
    "ei_p50",
    "ei_p90",
    "ei_max",
    "sel_rank",
    "dup_rate",
    "eff_components",
    "prior_mass_frac",
    "prior_take",
)

_IDX = {name: i for i, name in enumerate(HEALTH_STATS)}

# summary stats carried per-label in the JSONL health record (the full
# 9-vector per label per ask would bloat the stream for wide spaces)
_LABEL_STATS = ("ei_p50", "dup_rate", "eff_components", "prior_mass_frac")


def _finite_mean(a, axis=None):
    """Mean over finite entries (EI quantiles can be -inf when every
    candidate fell outside one model's support); 0.0 when none are."""
    a = np.asarray(a, np.float64)
    mask = np.isfinite(a)
    n = mask.sum(axis=axis)
    s = np.where(mask, a, 0.0).sum(axis=axis)
    return np.where(n > 0, s / np.maximum(n, 1), 0.0)


def record_tpe_health(obs, labels, stats, splits, algo="tpe"):
    """Fold one armed TPE ask's diagnostics into metrics + JSONL.

    ``stats``: ``[B, L, len(HEALTH_STATS)]`` host array (B proposals in the
    ask, L labels); ``splits``: ``[B, 2]`` (n_below, n_above — identical
    across the batch, every proposal saw the same history).
    """
    stats = np.asarray(stats, np.float64)
    if stats.ndim != 3 or not stats.size:
        return
    B, L = stats.shape[0], stats.shape[1]
    splits = np.asarray(splits).reshape(B, 2)
    n_below, n_above = int(splits[0, 0]), int(splits[0, 1])

    agg = _finite_mean(stats.reshape(-1, stats.shape[-1]), axis=0)  # [S]
    lab = _finite_mean(stats, axis=0)                               # [L, S]
    takes = int(np.nansum(stats[:, :, _IDX["prior_take"]]))

    m = obs.metrics
    m.counter("health.asks").inc()
    m.counter("health.proposals").inc(B)
    m.counter("health.prior_fallbacks").inc(takes)
    for name in ("ei_p50", "sel_rank", "dup_rate", "eff_components",
                 "prior_mass_frac"):
        m.histogram(f"health.{name}").observe(float(agg[_IDX[name]]))
    m.gauge("health.last_ei_p50").set(float(agg[_IDX["ei_p50"]]))
    m.gauge("health.last_dup_rate").set(float(agg[_IDX["dup_rate"]]))
    m.gauge("health.n_below").set(n_below)
    m.gauge("health.n_above").set(n_above)

    if obs.sink is None:
        return
    rec = {"kind": "health", "algo": algo, "ts": time.time(),
           "run_id": obs.run_id, "n": B, "n_label_proposals": B * L,
           "n_below": n_below, "n_above": n_above,
           "prior_takes": takes}
    for name in HEALTH_STATS:
        if name != "prior_take":
            rec[name] = float(agg[_IDX[name]])
    rec["labels"] = {
        l: {name: float(lab[j, _IDX[name]]) for name in _LABEL_STATS}
        for j, l in enumerate(labels)
    }
    obs.sink.write(rec)


def record_proposal_health(obs, algo, labels, flats):
    """The cheap health subset for non-TPE suggesters (``rand``,
    ``anneal``, any :class:`~hyperopt_tpu_torch.algos.algobase.SuggestAlgo`):
    per-label duplicate rate and proposal spread across one ask's batch.
    Computed from the host-side flat samples the suggester already fetched
    — no extra device work.  Callers skip batches of < 2 (both stats are
    degenerate at width 1)."""
    B = len(flats)
    if B < 2:
        return
    per = {}
    dups, spreads = [], []
    for l in labels:
        v = np.sort(np.asarray([f[l] for f in flats], np.float64))
        scale = max(float(v[-1] - v[0]), 1e-12)
        dup = float(np.mean(np.diff(v) <= 1e-6 * scale))
        spread = float(np.std(v))
        per[l] = {"dup_rate": dup, "spread": spread}
        dups.append(dup)
        spreads.append(spread)
    dup_mean = float(np.mean(dups))
    spread_mean = float(np.mean(spreads))

    m = obs.metrics
    m.counter("health.asks").inc()
    m.counter("health.proposals").inc(B)
    m.histogram("health.dup_rate").observe(dup_mean)
    m.gauge("health.last_dup_rate").set(dup_mean)
    if obs.sink is not None:
        obs.sink.write({"kind": "health", "algo": algo, "ts": time.time(),
                        "run_id": obs.run_id, "n": B,
                        "dup_rate": dup_mean, "spread": spread_mean,
                        "labels": per})


def live_health_postfix(obs):
    """Compact live-progress string ("EI p50 0.42  dup 3%") from the run's
    latest health gauges, or None before the first armed ask."""
    if obs is None:
        return None
    metrics = getattr(obs, "metrics", None)
    if metrics is None:
        return None
    reg = metrics._metrics
    asks = reg.get("health.asks")
    if asks is None or not asks.value:
        return None
    parts = []
    g = reg.get("health.last_ei_p50")
    if g is not None:
        parts.append(f"EI p50 {g.value:.3g}")
    d = reg.get("health.last_dup_rate")
    if d is not None:
        parts.append(f"dup {d.value * 100:.0f}%")
    return "  ".join(parts) or None


# ---------------------------------------------------------------------------
# device-utilization accounting (analytic costs × execute spans)
# ---------------------------------------------------------------------------


def record_program_cost(name, ops, nbytes, metrics=None):
    """Record one dispatch of program ``name``'s analytic cost as
    ``<name>.flops`` / ``<name>.bytes`` gauges (default: the process-global
    ``"device"`` namespace, next to the ``<name>.execute_sec`` histograms
    they join against), marked ``<name>.exp_ops`` = 1: the ops are
    exponentials (``megakernel.ei_cost``).  Returns ``{"flops",
    "bytes"}``."""
    reg = metrics if metrics is not None else get_metrics("device")
    reg.gauge(f"{name}.flops").set(float(ops))
    reg.gauge(f"{name}.bytes").set(float(nbytes))
    reg.gauge(f"{name}.exp_ops").set(1.0)
    return {"flops": float(ops), "bytes": float(nbytes)}


def ei_launch_cost(shapes):
    """``(ops, bytes)`` summed over ``ei_diff`` launch shapes ``[(P, n,
    m), ...]`` (``megakernel.ei_cost`` each)."""
    from ..megakernel import ei_cost

    ops = nbytes = 0
    for P, n, m in shapes:
        o, b = ei_cost(P, n, m)
        ops += o
        nbytes += b
    return ops, nbytes


def utilization_snapshot(wall_sec=None, stages=("chunk", "whole_run"),
                         metrics=None):
    """Join recorded program costs with measured execute spans into
    achieved FLOP/s, arithmetic intensity and (given the enclosing wall
    clock) device-busy fraction.

    ``execute_sec`` spans are wall clock around dispatch→readback, so
    "busy fraction" is an *upper bound proxy*: the share of ``wall_sec``
    spent inside device-program round trips (host dispatch overhead
    included).  Honest enough to answer "was the run device-bound or
    host-bound" from the artifacts alone.  Caveat: the ``"device"``
    namespace is process-cumulative — in a process running several stages,
    the execute totals cover every stage so far, and the clip keeps the
    fraction sane rather than exact."""
    reg = metrics if metrics is not None else get_metrics("device")
    return utilization_from_metrics(reg.snapshot()["metrics"],
                                    wall_sec=wall_sec, stages=stages)


def utilization_from_metrics(dev, wall_sec=None,
                             stages=("chunk", "whole_run")):
    """:func:`utilization_snapshot` over an already-snapshotted metrics
    dict — the form a RECORDED stream's final snapshot arrives in, so the
    live ``/snapshot`` endpoint and ``obs.report --format json`` share one
    join (obs/serve.py, report.headline_sections)."""
    out = {}
    busy_total = 0.0
    for st in stages:
        fl = dev.get(f"{st}.flops")
        ex = dev.get(f"{st}.execute_sec")
        if fl is None or not isinstance(ex, dict) or not ex.get("count"):
            continue
        by = dev.get(f"{st}.bytes") or 0.0
        sec, n = float(ex["sum"]), int(ex["count"])
        busy_total += sec
        entry = {
            "flops_per_dispatch": fl,
            "bytes_per_dispatch": by,
            "dispatches": n,
            "execute_sec_total": sec,
            "achieved_flops_per_sec": (fl * n / sec) if sec > 0 else 0.0,
            "arithmetic_intensity": (fl / by) if by else None,
        }
        if wall_sec:
            entry["busy_fraction"] = min(1.0, sec / wall_sec)
        out[st] = entry
    if out and wall_sec:
        out["device_busy_fraction"] = min(1.0, busy_total / wall_sec)
    # programs with a recorded cost but no execute-span pair (the armed
    # suggest tick: its execute time lives in phase_timings, not the
    # device namespace): report the static costs so every gauge has a
    # reader
    costs = {}
    for name, v in dev.items():
        if name.endswith(".flops"):
            st = name[: -len(".flops")]
            if st not in out:
                costs[st] = {"flops_per_dispatch": v,
                             "bytes_per_dispatch": dev.get(f"{st}.bytes", 0.0)}
    if costs:
        out["program_costs"] = costs
    return out


def roofline_table(device_metrics, phases=None, ask_sec=None):
    """Per-program roofline rows: every recorded cost joined with its
    measured execute spans.

    ``{program: {flops_per_dispatch, bytes_per_dispatch, dispatches,
    execute_sec_total, achieved_flops_per_sec, arithmetic_intensity,
    pct_of_ask}}`` — ``pct_of_ask`` is the program's execute total as a
    fraction of the run's ``suggest`` phase wall clock (``ask_sec``
    overrides; ``phases`` is the ``{name: {"sec", "count"}}`` dict the
    tracer/report already carry), answering "which program actually owns
    the ask latency" from the artifacts alone.  Programs with a captured
    cost but no execute spans yet report the static half only — every
    gauge keeps a reader.  Arithmetic intensity is FLOPs per byte
    accessed: with the measured FLOP/s this is everything a roofline plot
    needs."""
    if ask_sec is None and phases:
        ask_sec = (phases.get("suggest") or {}).get("sec")
    rows = {}
    for key, fl in device_metrics.items():
        if not (isinstance(key, str) and key.endswith(".flops")):
            continue
        st = key[: -len(".flops")]
        by = float(device_metrics.get(f"{st}.bytes") or 0.0)
        row = {
            "flops_per_dispatch": float(fl),
            "bytes_per_dispatch": by,
            "arithmetic_intensity": (float(fl) / by) if by else None,
        }
        ex = device_metrics.get(f"{st}.execute_sec")
        if isinstance(ex, dict) and ex.get("count"):
            sec, n = float(ex["sum"]), int(ex["count"])
            row.update(
                dispatches=n,
                execute_sec_total=sec,
                achieved_flops_per_sec=(float(fl) * n / sec) if sec > 0
                else 0.0,
            )
            if ask_sec:
                row["pct_of_ask"] = min(1.0, sec / float(ask_sec))
        rows[st] = row
    return rows


# ---------------------------------------------------------------------------
# multi-controller streams
# ---------------------------------------------------------------------------


def controller_stream_path(path, process_index):
    """Per-controller JSONL path for a multi-process run: ``run.jsonl`` →
    ``run.p<i>.jsonl`` (every controller writes its own stream; merge them
    with ``python -m hyperopt_tpu_torch.obs.report --merge run.p0.jsonl ...``)."""
    root, ext = os.path.splitext(str(path))
    return f"{root}.p{int(process_index)}{ext or '.jsonl'}"
