#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``hyperopt_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on its own:

1. Build every CUDA kernel of the port from ``hyperopt_tpu_torch/csrc``
   (one ``nvcc`` per source, started together) and hold each against its
   plain PyTorch version on the card, timed with CUDA events (median of 25
   launches after warm-up).
2. Check the card's main path against the port's CPU path: the same
   40-evaluation branin ``fmin`` on both devices gives the same trials.
3. The main path: ``fmin`` on branin (BASELINE config 2) with
   ``tpe.suggest`` at ``n_EI_candidates=1024``, 1000 evaluations,
   ``rstate=np.random.default_rng(0)``.  Every proposal must lie in the
   space and every TPE ask must launch the EI kernel.
4. A wide ask on a real-size state (BASELINE config 3's space,
   ``hr_conditional``, 28 labels): a 1000-trial history from
   ``rand.suggest``, then one ``tpe.suggest`` for 1024 new ids at
   ``n_EI_candidates=1024``.
5. ``torch.profiler`` over 20 more branin TPE asks: device busy time,
   kernel launches and the device's idle share per ask.

It imports neither JAX nor the JAX package.  Before the last line it
prints one JSON line describing every kernel and the card's name and power
limit; the last line is ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.
"""

import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time

REPLACES = {"ei_diff": "hyperopt_tpu/megakernel.py:516"}
SOURCES = {"ei_diff": "hyperopt_tpu_torch/csrc/ei_diff.cu"}
# H100 SXM: 132 SMs x 16 special-function results per clock (exp2, log2,
# rcp; CUDA C programming guide, compute capability 9.0) at the 1.98 GHz
# boost clock; 3.35 TB/s of HBM3 (NVIDIA data sheet)
SFU_PER_S = 132 * 16 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
TOL = 1e-4
# sizes of the main path (BASELINE configs 2 and 3)
MAIN_EVALS, MAIN_CANDIDATES = 1000, 1024
WIDE_HISTORY, WIDE_IDS, WIDE_CANDIDATES = 1000, 1024, 1024


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=25, warmup=3):
    """Median milliseconds of ``fn()`` over ``reps`` runs, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def ei_bound(P, n, m):
    """Least time for ``ei_diff`` at (P, n, m): each candidate x component x
    model term needs at least one exp on the special-function units; the
    bytes are x and out once plus six component tables."""
    ops_ms = 2.0 * P * n * m / SFU_PER_S * 1e3
    bytes_ms = 4.0 * (2 * P * n + 6 * P * m) / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def ei_inputs(P, n, m, seed, dead=0):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand(P, n, device="cuda", generator=g) * 6 - 3
    tabs = []
    for _ in range(2):
        w = torch.rand(P, m, device="cuda", generator=g) + 0.1
        if dead:
            w[:, m - dead:] = 0.0
        w = (w / w.sum(1, keepdim=True)).contiguous()
        mu = torch.randn(P, m, device="cuda", generator=g)
        s = torch.rand(P, m, device="cuda", generator=g) * 1.8 + 0.2
        tabs += [w, mu, s]
    return x, tabs


def phase_kernels(report):
    """Build the kernels and hold ei_diff against its plain version."""
    import torch

    from hyperopt_tpu_torch import _build, megakernel

    t0 = time.perf_counter()
    logs = _build.build_all(extra_flags=("-Xptxas", "-v"))
    report["build_sec"] = time.perf_counter() - t0
    for stem, text in logs.items():
        log(f"[nvcc {stem}]\n{text.strip()}")
    log(f"kernels built in {report['build_sec']:.1f} s")

    rows = []
    # (P, n, m, dead components, compare on the first n_cmp candidates)
    shapes = [(1, 24, 129, 0, None), (4, 1000, 257, 0, None), (128, 8192, 1025, 0, None),
              (8, 4096, 513, 100, None),
              (2, 1024, 1025, 0, None),          # branin tick: 2 labels x 1024 candidates
              (27, 1024 * 1024, 1025, 0, 8192)]  # hr_conditional wide ask: 27 labels
    for P, n, m, dead, n_cmp in shapes:
        x, tabs = ei_inputs(P, n, m, seed=P + n + m, dead=dead)
        got = megakernel.ei_diff(x, *tabs)
        torch.cuda.synchronize()
        xs = x if n_cmp is None else x[:, :n_cmp].contiguous()
        want = megakernel.ei_diff_plain(xs, *tabs)
        gs = got if n_cmp is None else got[:, :n_cmp]
        err = (gs - want).abs()
        ok = bool(torch.isfinite(got).all()) and bool(
            (err <= TOL * torch.clamp(want.abs(), min=1.0)).all())
        ms = cuda_ms(lambda: megakernel.ei_diff(x, *tabs))
        plain_ms = cuda_ms(lambda: megakernel.ei_diff_plain(xs, *tabs), reps=5)
        bound_ms, bound_by = ei_bound(P, n, m)
        row = {"shape": [P, n, m], "dead": dead, "compared_candidates": xs.shape[1],
               "max_abs_err": float(err.max()), "ok": ok, "ms": ms,
               "plain_ms": plain_ms, "plain_ms_shape": list(xs.shape) + [m],
               "bound_ms": bound_ms, "bound_by": bound_by}
        rows.append(row)
        log(f"ei_diff {row}")
        del x, tabs, got, want, err
        torch.cuda.empty_cache()
        if not ok:
            raise AssertionError(f"ei_diff disagrees with its plain version at {row}")
    report["ei_diff_shapes"] = rows
    return rows


def in_space(cs, doc):
    """Every active value of a trial doc lies in its label's support."""
    for label, vals in doc["misc"]["vals"].items():
        for v in vals:
            fam, p = cs.params[label].dist.family, cs.params[label].dist.params
            if not math.isfinite(v):
                return False
            if fam == "uniform" and not p[0] <= v <= p[1]:
                return False
            if fam == "loguniform" and not math.exp(p[0]) * (1 - 1e-6) <= v <= math.exp(p[1]) * (1 + 1e-6):
                return False
            if fam == "randint" and not (p[0] <= v < p[1] and v == int(v)):
                return False
    return True


def phase_cpu_agreement(report):
    """The card's fmin gives the CPU path's trials (40 branin evaluations)."""
    import numpy as np

    import hyperopt_tpu_torch as port
    from hyperopt_tpu_torch import zoo

    dom = zoo.ZOO["branin"]
    runs = {}
    for device in ("cpu", "cuda"):
        t = port.Trials(device=device)
        port.fmin(dom.objective, dom.space, algo=port.tpe.suggest, max_evals=40, trials=t,
                  rstate=np.random.default_rng(5), show_progressbar=False)
        runs[device] = t
    same = 0
    for a, b in zip(runs["cpu"].trials, runs["cuda"].trials):
        va, vb = a["misc"]["vals"], b["misc"]["vals"]
        if not all(np.allclose(va[k], vb[k], rtol=1e-4, atol=1e-5) for k in va):
            break
        same += 1
    report["cpu_agreement"] = {"trials": 40, "matching_prefix": same}
    log(f"cpu vs cuda: first {same} of 40 trials agree")
    if same != 40:
        raise AssertionError(f"the card's fmin left the CPU path's stream at trial {same}")


def phase_main(report):
    """Branin fmin, 1000 evaluations, TPE at 1024 candidates."""
    import numpy as np
    import torch

    import hyperopt_tpu_torch as port
    from hyperopt_tpu_torch import megakernel, zoo

    dom = zoo.ZOO["branin"]
    tuned = functools.partial(port.tpe.suggest, n_EI_candidates=MAIN_CANDIDATES)
    ticks = []  # (seconds, ei_diff launches) per TPE ask

    def algo(new_ids, domain, trials, seed):
        tpe_ask = len(trials.trials) >= 20
        before = megakernel.ei_diff.launches
        t0 = time.perf_counter()
        docs = tuned(new_ids, domain, trials, seed)
        if tpe_ask:
            ticks.append((time.perf_counter() - t0, megakernel.ei_diff.launches - before))
        return docs

    trials = port.Trials()
    megakernel.ei_diff.launches = 0
    t0 = time.perf_counter()
    best = port.fmin(dom.objective, dom.space, algo=algo, max_evals=MAIN_EVALS, trials=trials,
                     rstate=np.random.default_rng(0), show_progressbar=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = megakernel.ei_diff.launches
    losses = [l for l in trials.losses() if l is not None]
    out = {"evals": len(trials.trials), "best_loss": float(min(losses)), "argmin": best,
           "wall_sec": wall, "tpe_asks": len(ticks),
           "median_tpe_ask_ms": 1e3 * statistics.median(t for t, _ in ticks),
           "ei_diff_launches": launches,
           "min_launches_per_tpe_ask": min(k for _, k in ticks)}
    report["main_branin"] = out
    log(f"main path: {out}")
    if len(trials.trials) != MAIN_EVALS or len(ticks) != MAIN_EVALS - 20:
        raise AssertionError(f"expected {MAIN_EVALS} trials, all but 20 TPE asks: {out}")
    if not all(in_space(trials_cs(dom), d) for d in trials.trials):
        raise AssertionError("a proposal lies outside the branin space")
    if out["min_launches_per_tpe_ask"] < 1:
        raise AssertionError("a TPE ask did not launch the ei_diff kernel")
    if not out["best_loss"] < dom.loss_target:
        raise AssertionError(f"best loss {out['best_loss']} misses {dom.loss_target}")
    return launches, trials, tuned


def phase_profile(report, trials, tuned, asks=20):
    """Where a main-path TPE ask spends its time: ``torch.profiler`` over
    ``asks`` more asks on the finished branin history (cap 1024)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hyperopt_tpu_torch import zoo
    from hyperopt_tpu_torch.base import Domain

    dom = zoo.ZOO["branin"]
    domain = Domain(dom.objective, dom.space)
    ids = [len(trials.trials)]
    tuned(ids, domain, trials, 0)  # warm: the first ask on a new Domain
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for seed in range(asks):
            tuned(ids, domain, trials, seed + 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [a for a in prof.key_averages()
               if a.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(a.self_device_time_total for a in kernels)
    top = sorted(kernels, key=lambda a: -a.self_device_time_total)[:8]
    ask_ms = report["main_branin"]["median_tpe_ask_ms"]
    out = {"asks": asks, "profiled_wall_ms_per_ask": 1e3 * wall / asks,
           "device_busy_ms_per_ask": busy_us / 1e3 / asks,
           "kernel_launches_per_ask": sum(a.count for a in kernels) / asks,
           "device_idle_share": (1.0 - busy_us / 1e3 / asks / ask_ms) if busy_us else None,
           "top_kernels": [{"name": a.key[:80], "launches_per_ask": a.count / asks,
                            "device_ms_per_ask": a.self_device_time_total / 1e3 / asks}
                           for a in top]}
    report["profile_branin_ask"] = out
    log(f"profile: {out}")


def trials_cs(dom):
    from hyperopt_tpu_torch.spaces import compile_space

    return compile_space(dom.space)


def phase_wide(report):
    """One 1024-id TPE ask on a 1000-trial hr_conditional history."""
    import numpy as np
    import torch

    import hyperopt_tpu_torch as port
    from hyperopt_tpu_torch import megakernel, zoo
    from hyperopt_tpu_torch.base import JOB_STATE_DONE, Domain, spec_from_misc

    dom = zoo.ZOO["hr_conditional"]
    domain = Domain(dom.objective, dom.space)
    trials = port.Trials()
    docs = port.rand.suggest(list(range(WIDE_HISTORY)), domain, trials, seed=1)
    for doc in docs:
        doc["result"] = domain.evaluate(spec_from_misc(doc["misc"]), None)
        doc["state"] = JOB_STATE_DONE
    trials.insert_trial_docs(docs)
    trials.refresh()
    ids = list(range(WIDE_HISTORY, WIDE_HISTORY + WIDE_IDS))
    times, launches = [], []
    for rep in range(4):
        megakernel.ei_diff.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new = port.tpe.suggest(ids, domain, trials, seed=100 + rep,
                               n_EI_candidates=WIDE_CANDIDATES)
        times.append(time.perf_counter() - t0)
        launches.append(megakernel.ei_diff.launches)
        if len(new) != WIDE_IDS or not all(in_space(domain.cs, d) for d in new):
            raise AssertionError("the wide ask returned a bad proposal")
    cap = trials.history_object(domain.cs.labels).cap
    out = {"history": WIDE_HISTORY, "cap": cap, "m": cap + 1, "ids": WIDE_IDS,
           "n_EI_candidates": WIDE_CANDIDATES,
           "first_ask_ms": 1e3 * times[0], "median_ask_ms": 1e3 * statistics.median(times[1:]),
           "ei_diff_launches_per_ask": launches}
    report["wide_hr_conditional"] = out
    log(f"wide ask: {out}")
    if min(launches) < 1:
        raise AssertionError("the wide ask did not launch the ei_diff kernel")
    return launches[0]


def main():
    try:
        import torch
    except ImportError:
        log("chip_smoke: torch is not installed")
        return 1
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs on an NVIDIA card")
        return 1
    try:
        import hyperopt_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"chip_smoke: run from a checkout of the repository ({e})")
        return 1
    # the port does no matrix product, but state the float32 rule anyway
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    t_start = time.perf_counter()
    rows = phase_kernels(report)
    phase_cpu_agreement(report)
    main_launches, trials, tuned = phase_main(report)
    wide_launches = phase_wide(report)
    phase_profile(report, trials, tuned)
    report["total_sec"] = time.perf_counter() - t_start

    tick = rows[4]  # the branin tick's shape
    kernels = [{
        "name": "ei_diff", "route": "cuda", "source": SOURCES["ei_diff"],
        "replaces": REPLACES["ei_diff"], "launches": main_launches,
        "launches_wide_ask": wide_launches,
        "shape": tick["shape"], "max_abs_err": tick["max_abs_err"],
        "max_err": max(r["max_abs_err"] for r in rows),
        "ms": tick["ms"], "plain_ms": tick["plain_ms"], "bound_ms": tick["bound_ms"],
        "bound_by": tick["bound_by"], "library_ms": None,
        "shapes": [{k: r[k] for k in ("shape", "dead", "max_abs_err", "ms", "plain_ms",
                                      "bound_ms")} for r in rows],
    }]
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({**report, "kernels": kernels}, f, indent=1, default=str)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
