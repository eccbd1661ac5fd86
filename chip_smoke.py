#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``hyperopt_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on its own:

1. Build every CUDA kernel of the port from ``hyperopt_tpu_torch/csrc``
   (one ``nvcc`` per source, started together; ``-Xptxas -v`` gives each
   kernel's registers and shared memory) and hold each against its plain
   PyTorch version on the card.  A kernel's ``ms`` is the median of 25
   calls timed with CUDA events, the host's enqueue included (at launch
   scale that is most of it), as earlier versions of this script timed
   it; ``device_ms`` is the kernel's own device time (torch.profiler, mean
   of 10 launches after warm-up); ``plain_ms`` times the plain version
   the first way.  ``ei_diff`` runs at the single-study
   ask's shapes and at the edges of its component split (m = 1, m off the chunk size,
   an all-dead below mixture, n = 1, m = 2049), ``fused_sample_ei`` at the
   cohort's (the service tick, the wide tick, an unbounded group, a group
   with dead components, N = m = 1, phase 13's cohort and one shard of
   it), its candidates equal to the plain
   version's bit for bit.  Each shape records the launch's plan (splits
   or rows, blocks), its registers and shared memory, and
   ``bound_share = bound_ms / device_ms``.
2. Check the card's main path against the port's CPU path: the same
   40-evaluation branin ``fmin`` on both devices gives the same trials.
3. The single-study path: ``fmin`` on branin (BASELINE config 2) with
   ``tpe.suggest`` at ``n_EI_candidates=1024``, 1000 evaluations,
   ``rstate=np.random.default_rng(0)``.  Every proposal must lie in the
   space and every TPE ask must launch the EI kernel.
4. A wide ask on a real-size state (BASELINE config 3's space,
   ``hr_conditional``, 28 labels): a 1000-trial history from
   ``rand.suggest``, then one ``tpe.suggest`` for 1024 new ids at
   ``n_EI_candidates=1024``, four times (each with the caching
   allocator's peak and retries), and once more under ``torch.profiler``:
   device busy time, launches, idle share.
5. ``torch.profiler`` over 20 more branin TPE asks: device busy time,
   kernel launches and the device's idle share per ask; then ``cProfile``
   over 5 asks: the host's time per ask in the port's functions.
6. The study scheduler on the card against the scheduler on the CPU: 8
   studies over branin and hartmann6, 30 trials each, the same trials.
7. The study-batched path: ``make_study_mix(1024)`` through
   ``StudyScheduler`` on the card, startup waves unmeasured, then 20
   measured waves of ``ask_many(n=1)`` + ``tell``: studies per second,
   wave p50/p99, kernel launches per wave, the device's idle share
   (``torch.profiler`` over 5 waves).  Every wave must launch the fused
   kernel, every study must get an answer inside its space.
8. The wide cohort: ``build_suggest_batched`` for 256 hartmann6 studies at
   cap 128, 4 ids, ``n_EI_candidates=1024``, in float32 and int8 storage,
   on the fused route and on the grouped ``ei_diff`` route: the routes
   agree, and the int8 history takes at most 0.30 of the float32 bytes.
9. The on-device loop (``device_fmin``), whose steps are CUDA-graph
   replays with ``ei_diff`` inside the TPE graph: 40 ``DeviceLoopRunner``
   branin trials on the card follow the CPU's (rtol 1e-4), and the graph
   replays equal the eager steps on the card bit for bit; then
   ``fmin_device`` on branin at 1000 evaluations and 1024 candidates,
   cold (warm-up and capture) and warm (no capture), and
   ``fmin(device_loop=True)`` at the same size: best loss below the
   domain's target, every proposal in the space.  One chunk of 10 TPE
   replays under ``torch.profiler`` gives the device time and kernel
   launches per step and must show ``ei_diff``'s kernel once per step.
10. The other suggesters: annealing on ``many_dists``, ``mix.suggest``
    (0.8 TPE, 0.1 annealing, 0.1 random) and aTPE on branin, 40 trials on
    the card and on the CPU each, the same trials (rtol 1e-4); then each
    on branin at 1000 evaluations (BASELINE config 2) and aTPE on
    hartmann6 at 150: wall, median ask, kernel launches, device busy ms
    and idle share per ask (torch.profiler over a few asks).  aTPE's and
    mix's TPE asks must launch ``ei_diff`` once each, annealing never.
11. The widened service wave: ``make_study_mix(1024)`` through
    ``StudyScheduler(widen=True)`` as phase 7 runs it unwidened (wave
    p50/p99, studies/s, launches per wave, beside phase 7's figures): its
    cohorts keep off the fused kernel and score in grouped ``ei_diff``,
    whose every shape on this path phase 1 held against the plain version
    (a shape it did not plan is checked after the phase).  The widened
    scheduler on the card proposes bit for bit as the unwidened grouped
    one (``HYPEROPT_TPU_MEGAKERNEL=0``) and follows the widened scheduler
    on the CPU, 30 trials in 8 studies.
12. The ML zoo domains and the evaluation backends (TF32 off):
    (a) ``Domain(ml_logreg_cv).make_batch_eval()`` over 4096 prior draws,
    4096 four-fold CV fits per dispatch: fits per second, kernels per
    dispatch, the card against the port on the CPU at 16 points of the
    batch; (b) the host loop, ``fmin(ml_logreg_cv, algo=tpe.suggest)`` for
    64 evaluations, every fit on the card; (c) the device loop on both ML
    domains at 40 evaluations (``n_EI_candidates=32``, ``gamma=0.5``):
    graph replays equal eager steps bit for bit, ``fmin_device`` cold and
    warm and ``fmin(device_loop=True)``, capture time, and one profiled
    chunk of replays (kernels and device time per step); (d) ``fmin`` over
    ``ExecutorTrials(traceable=True)`` with queues of 16, each one batch
    evaluation on the card, 64 evaluations; (e) ``fmin`` over
    ``FileTrials`` in a temporary directory served by two ``python -m
    hyperopt_tpu_torch.worker`` processes on the card, 40 evaluations, no
    trial claimed twice, every doc done.  On (b)-(e) ``ei_diff`` launches
    (eager plus graph replays) equal the TPE asks (steps), and every shape
    it launched at is held against the plain version (phase 1 plans them;
    one it missed is checked after the phase).
13. The multi-device path on ``hpob_surrogate`` (BASELINE config 5's
    surrogate), every mesh naming the one card more than once:
    (a) ``suggest_batch_sharded`` on a 2x1 (trials x cand) mesh against a
    1-entry mesh, and ``propose_sharded_candidates`` on a 1x2 mesh
    against every shard's candidates in one launch (``_propose_fused_pool``),
    single and batched, 24 and 1000 candidates, 64 keys, on a
    1000-trial history (cap 1024): bit for bit where every launch planned
    the same component splits as its one-device launch (the plans are
    printed), else at rtol 1e-4, atol 1e-5 with at most one flipped
    proposal; (b) ``fmin(algo=tpe.suggest_sharded(...))`` on the 1x2 mesh,
    queues of 16, 64 evaluations: the card follows the same run on the
    CPU, and ``ei_diff`` launches = TPE asks x 2 shards x 3 numeric
    labels; (c) ``HYPEROPT_TPU_SHARD=auto`` on ``tpe.suggest`` and on
    ``StudyScheduler`` equal the knob unset bit for bit, on the one card
    (a 1-entry mesh) and with the card named twice as the local devices
    (every cohort tick split over 2 entries, tells folded into the split
    stack, ``fused_sample_ei`` launched twice where the unsharded tick
    launched once), and ``build_suggest_batched(mesh=<2 entries>)`` for 256
    hartmann6 studies equals the unsharded cohort bit for bit with one
    ``fused_sample_ei`` launch per shard and tick; (d)
    ``fmin_multihost`` at the driver's defaults, batch 1024, 4096
    evaluations (one startup and three TPE generations, cap 4096): in this
    process (``_force_single``; once more with one proposal profiled),
    then as two controller processes sharing the card over gloo, whose
    checksums must equal the single run's: wall, propose and evaluate ms
    per generation, ``ei_diff`` launches and shapes, peak memory, the idle
    share of a proposal; (e) ``fmin_multihost(fleet_dir=...)`` with two
    controller processes for 2 generations equals the collective run, and
    one controller resuming the store for a third generation too.  A
    controller that fails fails the phase; every collective has a
    deadline.  Every shape either kernel launched at in the phase and
    phase 1 did not plan is then held against its plain version on
    every candidate (``plain_cmp``).

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

REPLACES = {"ei_diff": "hyperopt_tpu/megakernel.py:516",
            "fused_sample_ei": "hyperopt_tpu/megakernel.py:271"}
SOURCES = {"ei_diff": "hyperopt_tpu_torch/csrc/ei_diff.cu",
           "fused_sample_ei": "hyperopt_tpu_torch/csrc/fused_sample_ei.cu"}
# H100 SXM: 132 SMs x 16 special-function results per clock (exp2, log2,
# rcp; CUDA C programming guide, compute capability 9.0) at the 1.98 GHz
# boost clock; 3.35 TB/s of HBM3 (NVIDIA data sheet)
SFU_PER_S = 132 * 16 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
TOL = 1e-4
# the plain ei_diff materializes [P, n, m] float32 tensors, a few at once:
# up to 2**31 elements (8 GiB each) it takes every candidate of a launch;
# only the wide ask (27 x 1M x 1025, ~113 GB each) compares a prefix
PLAIN_CMP_ELEMS = 2 ** 31
DEVICE = "cuda"  # where the study-batched phases run (a rehearsal sets "cpu")
# sizes of the main path (BASELINE configs 2 and 3)
MAIN_EVALS, MAIN_CANDIDATES = 1000, 1024
WIDE_HISTORY, WIDE_IDS, WIDE_CANDIDATES = 1000, 1024, 1024
# the study-batched path: the standing mix's documented scale (1k studies)
# and the wide cohort (256 studies, cap 128, 4 ids, 1024 candidates)
SERVICE_STUDIES, SERVICE_STARTUP, SERVICE_WAVES, SERVICE_PROFILED = 1024, 5, 20, 5
COHORT_STUDIES, COHORT_TRIALS = 8, 30
WIDE_COHORT = dict(studies=256, cap=128, ids=4, candidates=1024)
# the device loop: card vs CPU and graph vs eager on 40 runner trials, then
# the main size (BASELINE config 2: branin, 1000 evaluations)
LOOP_CHECK_TRIALS, LOOP_STARTUP = 40, 20
# the other suggesters (phase 10): card vs CPU on 40 trials, then branin at
# MAIN_EVALS and aTPE on hartmann6 at ATPE_H6_EVALS; asks profiled per run
SUGGEST_CHECK_TRIALS, ATPE_H6_EVALS, SUGGEST_PROFILED = 40, 150, 5
# ei_diff shapes (P, n, m, dead components, compare on the first n_cmp
# candidates, all-dead below mixture)
EI_SHAPES = [(1, 24, 129, 0, None, False), (4, 1000, 257, 0, None, False),
             (128, 8192, 1025, 0, None, False), (8, 4096, 513, 100, None, False),
             (2, 1024, 1025, 0, None, False),          # branin tick: 2 labels x 1024 candidates
             (2, 1024, 1001, 0, None, False),          # the device loop's TPE step, cap 1000
             (27, 1024 * 1024, 1025, 0, 8192, False),  # hr_conditional wide ask: 27 labels
             # edges of the component split
             (3, 1024, 1, 0, None, False), (3, 2000, 300, 0, None, False),
             (4, 1000, 129, 0, None, True), (8, 1, 1025, 0, None, False),
             (1, 1024, 2049, 0, None, False),
             # phase 10: aTPE's branin ask (32 candidates), its hartmann6
             # ask (64), mix's TPE branch (24)
             (2, 32, 1025, 0, None, False), (6, 64, 257, 0, None, False),
             (2, 24, 1025, 0, None, False),
             # phase 11: the widened wave's numeric groups, S slots x G
             # labels (hartmann6 6, rosenbrock4 4, hpob_surrogate 3, branin
             # 2, quadratic1 1), 24 candidates, caps 16 and 32
             *[(256 * G, 24, m, 0, None, False) for G in (6, 4, 3, 2, 1) for m in (17, 33)],
             # phase 12: ml_logreg_cv's TPE asks at cap 128 with queues of
             # 1, 2 and 16 ids, and the device loop's steps at cap 40 (its
             # 3 and model selection's 5 numeric labels, 32 candidates)
             (3, 24, 129, 0, None, False), (3, 48, 129, 0, None, False),
             (3, 384, 129, 0, None, False), (3, 32, 41, 0, None, False),
             (5, 32, 41, 0, None, False)]
# fused_sample_ei shapes (P, N, m, dead components, bounded): the service
# tick (256 slots x 6 labels, 24 candidates), the wide tick (4 x 1024
# candidates), an unbounded group, a group with dead components, N = m = 1,
# and phase 13's cohort of 256 hartmann6 studies (4 ids x 24 candidates,
# cap 128) unsharded and one shard of it on a 2-entry mesh
FUSED_SHAPES = [(256 * 6, 24, 65, 0, True), (256 * 6, 4 * 1024, 129, 0, True),
                (256 * 2, 24, 65, 0, False), (64, 1000, 300, 77, True), (64, 1, 1, 0, True),
                (256 * 6, 4 * 24, 129, 0, True), (128 * 6, 4 * 24, 129, 0, True)]
# what the kernels line keeps of each phase-1 shape
SHAPE_KEYS = ("shape", "dead", "below_all_dead", "bounded", "max_abs_err", "ms", "device_ms",
              "plain_ms", "bound_ms", "bound_share", "per_thread", "splits", "cols", "rows",
              "blocks", "registers", "smem_bytes")


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


def device_ms(fn, fragment, reps=10):
    """Mean device time per call of the kernel whose name holds
    ``fragment``, over ``reps`` calls of ``fn`` (torch.profiler, CUPTI):
    the kernel alone, without the host's enqueue time that ``cuda_ms``
    includes at launch scale.  Raises if the profiler saw no launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [a for a in prof.key_averages()
            if a.device_type == torch.autograd.DeviceType.CUDA and fragment in a.key]
    if not hits:
        raise AssertionError(f"the profiler saw no launch of {fragment}")
    return sum(a.self_device_time_total for a in hits) / 1e3 / reps


def ei_bound(P, n, m):
    """Least time for ``ei_diff`` at (P, n, m): each candidate x component x
    model term needs at least one exp on the special-function units; the
    bytes are x and out once plus six component tables."""
    ops_ms = 2.0 * P * n * m / SFU_PER_S * 1e3
    bytes_ms = 4.0 * (2 * P * n + 6 * P * m) / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def fused_bound(P, N, m):
    """Least time for ``fused_sample_ei`` at (P, N, m): two exp per
    candidate x component (one per model) plus one ``ndtri`` per candidate
    on the special-function units; the bytes are the two uniforms and two
    outputs once, nine tables and the two bounds."""
    ops_ms = (2.0 * P * N * m + P * N) / SFU_PER_S * 1e3
    bytes_ms = (16.0 * P * N + 36.0 * P * m + 8.0 * P) / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def fused_inputs(P, N, m, seed, dead=0, bounded=True):
    """Uniforms and the nine tables the cohort hands the fused kernel,
    built by the port's own table code from seeded mixtures."""
    import torch

    from hyperopt_tpu_torch.algos import tpe

    g = torch.Generator(device="cuda").manual_seed(seed)
    uc = torch.rand(P, N, device="cuda", generator=g)
    u0 = torch.rand(P, N, device="cuda", generator=g)
    tabs = {}
    for side in "ba":
        w = torch.rand(P, m, device="cuda", generator=g) + 0.1
        if dead:
            w[:, m - dead:] = 0.0
        tabs["w" + side] = (w / w.sum(1, keepdim=True)).contiguous()
        tabs["m" + side] = torch.randn(P, m, device="cuda", generator=g)
        tabs["s" + side] = torch.rand(P, m, device="cuda", generator=g) * 1.8 + 0.2
    low = torch.full((P,), -2.0, device="cuda")
    high = torch.full((P,), 2.5, device="cuda")
    cdf, ab, bb = tpe._sample_tables(tabs["wb"], tabs["mb"], tabs["sb"], low, high, bounded)
    return [t.contiguous() for t in (uc, u0, cdf, tabs["mb"], tabs["sb"], ab, bb, tabs["wb"],
                                      tabs["wa"], tabs["ma"], tabs["sa"], low, high)]


def ei_inputs(P, n, m, seed, dead=0, below_dead=False):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand(P, n, device="cuda", generator=g) * 6 - 3
    tabs = []
    for side in range(2):
        w = torch.rand(P, m, device="cuda", generator=g) + 0.1
        if dead:
            w[:, m - dead:] = 0.0
        w = (w / w.sum(1, keepdim=True)).contiguous()
        if below_dead and side == 0:
            w.zero_()
        mu = torch.randn(P, m, device="cuda", generator=g)
        s = torch.rand(P, m, device="cuda", generator=g) * 1.8 + 0.2
        tabs += [w, mu, s]
    return x, tabs


def phase_kernels(report):
    """Build the kernels and hold both against their plain versions."""
    from hyperopt_tpu_torch import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    report["build_sec"] = time.perf_counter() - t0
    usage = {}
    for stem, text in logs.items():
        log(f"[nvcc {stem}]\n{text.strip()}")
        usage.update(ptxas_usage(text))
    report["ptxas"] = usage
    log(f"kernels built in {report['build_sec']:.1f} s")

    rows = [check_ei(*shape, usage) for shape in EI_SHAPES]
    report["ei_diff_shapes"] = rows

    frows = [check_fused(*shape, usage) for shape in FUSED_SHAPES]
    report["fused_sample_ei_shapes"] = frows
    return rows, frows


def plain_cmp(P, n, m):
    """Candidates of a launch to hold against the plain version: all of
    them, unless its [P, n, m] float32 intermediates pass PLAIN_CMP_ELEMS
    elements (it keeps a few alive at once)."""
    return None if P * n * m <= PLAIN_CMP_ELEMS else PLAIN_CMP_ELEMS // (P * m)


def check_ei(P, n, m, dead, n_cmp, below_dead, usage):
    """Hold ``ei_diff`` at (P, n, m) against its plain version and time
    both; raises when they disagree."""
    import torch

    from hyperopt_tpu_torch import megakernel

    x, tabs = ei_inputs(P, n, m, seed=P + n + m, dead=dead, below_dead=below_dead)
    got = megakernel.ei_diff(x, *tabs)
    torch.cuda.synchronize()
    xs = x if n_cmp is None else x[:, :n_cmp].contiguous()
    want = megakernel.ei_diff_plain(xs, *tabs)
    gs = got if n_cmp is None else got[:, :n_cmp]
    err = (gs - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool(
        (err <= TOL * torch.clamp(want.abs(), min=1.0)).all())
    ms = cuda_ms(lambda: megakernel.ei_diff(x, *tabs))
    dev_ms = device_ms(lambda: megakernel.ei_diff(x, *tabs), "ei_diff_kernel")
    plain_ms = cuda_ms(lambda: megakernel.ei_diff_plain(xs, *tabs), reps=5)
    bound_ms, bound_by = ei_bound(P, n, m)
    plan = megakernel._launch_plan("ei_diff", P, n, m)
    row = {"shape": [P, n, m], "dead": dead, "below_all_dead": below_dead,
           "compared_candidates": xs.shape[1],
           "max_abs_err": float(err.max()), "ok": ok, "ms": ms, "device_ms": dev_ms,
           "plain_ms": plain_ms, "plain_ms_shape": list(xs.shape) + [m],
           "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / dev_ms,
           **plan, **usage_of(usage, f"ei_diff_kernelILi{plan['per_thread']}E")}
    log(f"ei_diff {row}")
    del x, tabs, got, want, err
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"ei_diff disagrees with its plain version at {row}")
    return row


def check_fused(P, N, m, dead, bounded, usage):
    """Hold ``fused_sample_ei`` at (P, N, m) against its plain version and
    time both: x bit for bit, ei within the tolerance; raises when they
    disagree."""
    import torch

    from hyperopt_tpu_torch import megakernel

    args = fused_inputs(P, N, m, seed=P + N + m, dead=dead, bounded=bounded)
    x, ei = megakernel.fused_sample_ei(*args, bounded)
    torch.cuda.synchronize()
    px, pei = megakernel.fused_sample_ei_plain(*args, bounded)
    err_x, err_ei = (x - px).abs(), (ei - pei).abs()
    # x equals the plain version's bit for bit; ei within the tolerance
    ok = (bool(torch.isfinite(x).all()) and bool(torch.isfinite(ei).all())
          and float(err_x.max()) == 0.0
          and bool((err_ei <= TOL * torch.clamp(pei.abs(), min=1.0)).all()))
    if bounded:
        ok = ok and bool((x >= args[-2][:, None]).all()) and bool((x < args[-1][:, None]).all())
    ms = cuda_ms(lambda: megakernel.fused_sample_ei(*args, bounded))
    dev_ms = device_ms(lambda: megakernel.fused_sample_ei(*args, bounded), "fused_kernel")
    plain_ms = cuda_ms(lambda: megakernel.fused_sample_ei_plain(*args, bounded), reps=5)
    bound_ms, bound_by = fused_bound(P, N, m)
    row = {"shape": [P, N, m], "dead": dead, "bounded": bounded,
           "max_abs_err": float(max(err_x.max(), err_ei.max())),
           "max_abs_err_x": float(err_x.max()), "max_abs_err_ei": float(err_ei.max()),
           "ok": ok, "ms": ms, "device_ms": dev_ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "bound_share": bound_ms / dev_ms,
           **megakernel._launch_plan("fused_sample_ei", P, N, m),
           **usage_of(usage, "fused_kernel")}
    log(f"fused_sample_ei {row}")
    del args, x, ei, px, pei, err_x, err_ei
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"fused_sample_ei disagrees with its plain version at {row}")
    return row


def ptxas_usage(text):
    """``{kernel symbol: {"registers": r, "smem_bytes": b, "spill_bytes": s}}``
    from ``nvcc -Xptxas -v`` output."""
    import re

    out, name = {}, None
    for line in text.splitlines():
        hit = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if hit:
            name = hit.group(1)
            out.setdefault(name, {})
        hit = re.search(r"(\d+) bytes spill stores", line)
        if hit and name:
            out[name]["spill_bytes"] = int(hit.group(1))
        hit = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if hit and name:
            out[name].update(registers=int(hit.group(1)), smem_bytes=int(hit.group(2)))
    return out


def usage_of(usage, fragment):
    """The ptxas figures of the one kernel symbol containing ``fragment``."""
    hits = [v for k, v in usage.items() if fragment in k and "registers" in v]
    return hits[0] if len(hits) == 1 else {"registers": None, "smem_bytes": None}


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
            if fam == "quniform" and not (p[0] - p[2] / 2 <= v <= p[1] + p[2] / 2):
                return False
            if fam == "uniformint" and not (p[0] <= v <= p[1] and v == int(v)):
                return False
            if fam == "categorical" and not (0 <= v < len(p) and v == int(v)):
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
    megakernel.ei_diff.launches = megakernel.fused_sample_ei.launches = 0
    t0 = time.perf_counter()
    best = port.fmin(dom.objective, dom.space, algo=algo, max_evals=MAIN_EVALS, trials=trials,
                     rstate=np.random.default_rng(0), show_progressbar=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = megakernel.ei_diff.launches
    report["fmin_path_launches"] = {"ei_diff": launches,
                                    "fused_sample_ei": megakernel.fused_sample_ei.launches}
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


def phase_profile(report, trials, tuned, asks=20, host_asks=5):
    """Where a main-path TPE ask spends its time: ``torch.profiler`` over
    ``asks`` more asks on the finished branin history (cap 1024), then
    ``cProfile`` over ``host_asks`` more."""
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
    out["host"] = host_profile(lambda seed: tuned(ids, domain, trials, seed), host_asks)
    report["profile_branin_ask"] = out
    log(f"profile: {out}")


def host_profile(ask, asks, keep=40):
    """The host's side of ``asks`` calls of ``ask(seed)`` under cProfile:
    wall per ask, the time spent inside C functions (torch's operators,
    which enqueue the launches), and the port's functions by cumulative
    time per ask.  cProfile's own cost inflates every Python figure."""
    import cProfile
    import pstats

    import torch

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    for seed in range(asks):
        ask(1000 + seed)
    torch.cuda.synchronize()
    prof.disable()
    wall = time.perf_counter() - t0
    stats = pstats.Stats(prof).stats  # (file, line, name) -> (cc, calls, self s, cum s, callers)
    builtin_s = sum(v[2] for (path, _, _), v in stats.items() if path == "~")
    rows = [{"function": f"{path.rsplit('hyperopt_tpu_torch/', 1)[-1]}:{line}:{name}",
             "calls_per_ask": calls / asks, "cum_ms_per_ask": 1e3 * cum / asks,
             "self_ms_per_ask": 1e3 * self_s / asks}
            for (path, line, name), (_, calls, self_s, cum, _) in stats.items()
            if "hyperopt_tpu_torch" in path]
    rows.sort(key=lambda r: -r["cum_ms_per_ask"])
    return {"asks": asks, "wall_ms_per_ask": 1e3 * wall / asks,
            "c_functions_ms_per_ask": 1e3 * builtin_s / asks, "port_functions": rows[:keep]}


def trials_cs(dom):
    from hyperopt_tpu_torch.spaces import compile_space

    return compile_space(dom.space)


def phase_wide(report):
    """One 1024-id TPE ask on a 1000-trial hr_conditional history, timed
    four times, then once more under torch.profiler."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

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
    times, launches, peaks, retries = [], [], [], []
    for rep in range(4):
        megakernel.ei_diff.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        t0 = time.perf_counter()
        new = port.tpe.suggest(ids, domain, trials, seed=100 + rep,
                               n_EI_candidates=WIDE_CANDIDATES)
        times.append(time.perf_counter() - t0)
        launches.append(megakernel.ei_diff.launches)
        # the caching allocator's peak, and how often it had to free its
        # cache and retry a cudaMalloc (a synchronizing slow path)
        peaks.append(torch.cuda.max_memory_reserved() / 2**30)
        retries.append(torch.cuda.memory_stats().get("num_alloc_retries", 0) - before)
        if len(new) != WIDE_IDS or not all(in_space(domain.cs, d) for d in new):
            raise AssertionError("the wide ask returned a bad proposal")
    # one more ask under torch.profiler: the device's share of the ask
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        port.tpe.suggest(ids, domain, trials, seed=200, n_EI_candidates=WIDE_CANDIDATES)
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [a for a in prof.key_averages()
               if a.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(a.self_device_time_total for a in kernels) / 1e3
    cap = trials.history_object(domain.cs.labels).cap
    out = {"history": WIDE_HISTORY, "cap": cap, "m": cap + 1, "ids": WIDE_IDS,
           "n_EI_candidates": WIDE_CANDIDATES, "ask_ms": [1e3 * t for t in times],
           "first_ask_ms": 1e3 * times[0], "median_ask_ms": 1e3 * statistics.median(times[1:]),
           "ei_diff_launches_per_ask": launches, "peak_reserved_gib": peaks,
           "alloc_retries": retries, "profiled_ask_ms": prof_ms, "device_busy_ms": busy_ms,
           "kernel_launches": sum(a.count for a in kernels),
           "device_idle_share": 1.0 - busy_ms / prof_ms,
           "top_kernels": [{"name": a.key[:80], "launches": a.count,
                            "device_ms": a.self_device_time_total / 1e3}
                           for a in sorted(kernels, key=lambda a: -a.self_device_time_total)[:8]]}
    report["wide_hr_conditional"] = out
    log(f"wide ask: { {k: v for k, v in out.items() if k != 'top_kernels'} }")
    if min(launches) < 1:
        raise AssertionError("the wide ask did not launch the ei_diff kernel")
    return launches[0]


def drive_waves(sched, sids, objective_of, waves, on_wave=None):
    """``waves`` rounds of one ask per study and one tell per answer;
    returns the seconds of each wave (ask through the last tell)."""
    import torch

    times = []
    for w in range(waves):
        t0 = time.perf_counter()
        answers = sched.ask_many([(sid, 1) for sid in sids])
        if set(answers) != set(sids):
            raise AssertionError(f"wave {w}: {len(sids) - len(answers)} studies got no answer")
        for sid, (a,) in answers.items():
            sched.tell(sid, a["tid"], objective_of[sid](a["params"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if on_wave is not None:
            on_wave(w, answers)
    return times


def phase_cohort_agreement(report):
    """The scheduler on the card serves the CPU scheduler's trials: 8
    studies (4 branin, 4 hartmann6), 30 trials each, 5 startup jobs."""
    import numpy as np

    from hyperopt_tpu_torch import zoo
    from hyperopt_tpu_torch.service import StudyScheduler

    streams = {}
    for device in ("cpu", DEVICE):
        sched = StudyScheduler(device=device)
        doms = [zoo.ZOO["branin" if i % 2 else "hartmann6"] for i in range(COHORT_STUDIES)]
        sids = [sched.create_study(d.space, seed=40 + i, n_startup_jobs=5)
                for i, d in enumerate(doms)]
        drive_waves(sched, sids, {sid: d.objective for sid, d in zip(sids, doms)},
                    COHORT_TRIALS)
        streams[device] = [sched._studies[sid].trials.trials for sid in sids]
    same = []
    for a_trials, b_trials in zip(streams["cpu"], streams[DEVICE]):
        n = 0
        for a, b in zip(a_trials, b_trials):
            va, vb = a["misc"]["vals"], b["misc"]["vals"]
            if not all(np.allclose(va[k], vb[k], rtol=1e-4, atol=1e-5) for k in va):
                break
            n += 1
        same.append(n)
    report["cohort_cpu_agreement"] = {"studies": COHORT_STUDIES, "trials": COHORT_TRIALS,
                                      "matching_prefix_per_study": same}
    log(f"scheduler cpu vs cuda: matching prefixes {same} of {COHORT_TRIALS}")
    if same != [COHORT_TRIALS] * COHORT_STUDIES:
        raise AssertionError(f"the card's scheduler left the CPU's stream: {same}")


def phase_service(report):
    """``make_study_mix(1024)`` through the scheduler on the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hyperopt_tpu_torch import megakernel, zoo
    from hyperopt_tpu_torch.service import StudyScheduler

    sched = StudyScheduler(device=DEVICE)
    mix = zoo.make_study_mix(SERVICE_STUDIES)
    items = {sched.create_study(it.domain.space, seed=it.seed,
                                n_startup_jobs=it.n_startup_jobs): it for it in mix}
    sids = list(items)
    objective_of = {sid: it.domain.objective for sid, it in items.items()}
    t0 = time.perf_counter()
    drive_waves(sched, sids, objective_of, SERVICE_STARTUP)  # prior draws, unmeasured
    startup_sec = time.perf_counter() - t0
    per_wave = []
    bad = []

    def check(w, answers):
        per_wave.append((megakernel.fused_sample_ei.launches, megakernel.ei_diff.launches))
        for sid, (a,) in answers.items():
            doc = {"misc": {"vals": {k: [v] for k, v in a["params"].items()}}}
            if not in_space(sched._studies[sid].domain.cs, doc):
                bad.append((sid, a))

    megakernel.ei_diff.launches = megakernel.fused_sample_ei.launches = 0
    times = drive_waves(sched, sids, objective_of, SERVICE_WAVES, on_wave=check)
    launches = {"fused_sample_ei": megakernel.fused_sample_ei.launches,
                "ei_diff": megakernel.ei_diff.launches}
    fused_per_wave = [b[0] - a[0] for a, b in zip([(0, 0)] + per_wave, per_wave)]
    ei_per_wave = [b[1] - a[1] for a, b in zip([(0, 0)] + per_wave, per_wave)]

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        drive_waves(sched, sids, objective_of, SERVICE_PROFILED)
        prof_wall = time.perf_counter() - t1
    kernels = [a for a in prof.key_averages()
               if a.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(a.self_device_time_total for a in kernels)
    top = sorted(kernels, key=lambda a: -a.self_device_time_total)[:8]
    ms = sorted(1e3 * t for t in times)
    out = {"studies": len(sids), "startup_waves": SERVICE_STARTUP,
           "startup_sec": startup_sec, "measured_waves": SERVICE_WAVES,
           "studies_per_sec": len(sids) * len(times) / sum(times),
           "wave_ms_p50": statistics.median(ms),
           "wave_ms_p99": ms[min(len(ms) - 1, math.ceil(0.99 * len(ms)) - 1)],
           "wave_ms": [1e3 * t for t in times],
           "launches": launches, "fused_launches_per_wave": fused_per_wave,
           "ei_diff_launches_per_wave": ei_per_wave,
           "cohorts": sorted((c.cap, c.n_slots, c.n_live, len(c.cs.labels), c.hist_dtype)
                             for c in sched._cohorts.values()),
           "profiled_waves": SERVICE_PROFILED,
           "profiled_wall_ms_per_wave": 1e3 * prof_wall / SERVICE_PROFILED,
           "device_busy_ms_per_wave": busy_us / 1e3 / SERVICE_PROFILED,
           "kernel_launches_per_wave": sum(a.count for a in kernels) / SERVICE_PROFILED,
           "device_idle_share": (1.0 - busy_us / 1e3 / (1e3 * prof_wall)) if busy_us else None,
           "top_kernels": [{"name": a.key[:80], "launches_per_wave": a.count / SERVICE_PROFILED,
                            "device_ms_per_wave": a.self_device_time_total / 1e3
                            / SERVICE_PROFILED} for a in top]}
    report["service_wave"] = out
    log(f"service wave: { {k: v for k, v in out.items() if k != 'wave_ms'} }")
    if min(fused_per_wave) < 1:
        raise AssertionError(f"a wave launched no fused kernel: {fused_per_wave}")
    if min(ei_per_wave) < 1:
        raise AssertionError(f"a wave launched no ei_diff kernel: {ei_per_wave}")
    if bad:
        raise AssertionError(f"{len(bad)} proposals lie outside their space, e.g. {bad[0]}")
    return launches


def phase_wide_cohort(report):
    """``build_suggest_batched`` for 256 hartmann6 studies at cap 128, 4 ids
    and 1024 candidates: float32 and int8 storage, fused and grouped
    routes."""
    import numpy as np
    import torch

    from hyperopt_tpu_torch import megakernel, quant, zoo
    from hyperopt_tpu_torch.algos import tpe
    from hyperopt_tpu_torch.base import Domain

    S, cap, B, n = (WIDE_COHORT[k] for k in ("studies", "cap", "ids", "candidates"))
    dom = zoo.ZOO["hartmann6"]
    cs = Domain(dom.objective, dom.space).cs
    cfg = {"prior_weight": 1.0, "n_EI_candidates": n, "gamma": 0.25, "LF": 25,
           "ei_select": "argmax", "ei_tau": 1.0, "prior_eps": 0.0}
    rng = np.random.default_rng(9)
    live = rng.integers(cap // 4, cap - 8, S)
    vals = {l: rng.uniform(0, 1, (S, cap)).astype(np.float32) for l in cs.labels}
    active = np.arange(cap)[None, :] < live[:, None]
    losses = np.where(active, np.array([[dom.objective({l: vals[l][s, i] for l in cs.labels})
                                         for i in range(cap)] for s in range(S)]),
                      np.inf).astype(np.float32)
    L = len(cs.labels)
    rows = np.zeros((S, 1, 2 * L + 3), np.float32)
    rows[:, :, -1] = cap
    seeds = np.stack([tpe._seed_words(1000 + s) for s in range(S)])
    ids = (np.arange(S * B).reshape(S, B) + 5000).astype(np.uint32)

    def stack(name):
        qp = quant.space_qparams(cs, name) if quant.is_quant_name(name) else None
        v = {l: (quant.quantize_np(quant.snap_np(vals[l], qp[l], name), qp[l], name)
                 .reshape(S, cap).to(DEVICE) if qp else torch.tensor(vals[l], device=DEVICE))
             for l in cs.labels}
        return {"vals": v, "active": {l: torch.tensor(active, device=DEVICE) for l in cs.labels},
                "losses": torch.tensor(losses, dtype=quant.losses_dtype(name), device=DEVICE),
                "has_loss": torch.tensor(active, device=DEVICE)}

    out = {"studies": S, "cap": cap, "ids": B, "candidates": n, "ticks": {}}
    packed = {}
    knob = os.environ.get("HYPEROPT_TPU_MEGAKERNEL")
    for name in ("float32", "int8"):
        for route in ("on", "0"):
            os.environ["HYPEROPT_TPU_MEGAKERNEL"] = route
            run = tpe.build_suggest_batched(cs, cfg, S, cap, B, donate=False, hist_dtype=name)
            hist = stack(name)
            times = []
            megakernel.ei_diff.launches = megakernel.fused_sample_ei.launches = 0
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, mat = run(hist, rows, seeds, ids)
                mat = mat.cpu().numpy()
                times.append(time.perf_counter() - t0)
            packed[(name, route)] = mat
            out["ticks"][f"{name}/{'fused' if route == 'on' else 'grouped'}"] = {
                "first_ms": 1e3 * times[0], "median_ms": 1e3 * statistics.median(times[1:]),
                "fused_launches": megakernel.fused_sample_ei.launches,
                "ei_diff_launches": megakernel.ei_diff.launches}
    if knob is None:
        os.environ.pop("HYPEROPT_TPU_MEGAKERNEL", None)
    else:
        os.environ["HYPEROPT_TPU_MEGAKERNEL"] = knob

    def value_bytes(h):  # the reference's measure: vals and losses
        return sum(t.numel() * t.element_size() for t in (*h["vals"].values(), h["losses"]))

    def all_bytes(h):
        return value_bytes(h) + sum(t.numel() * t.element_size()
                                    for t in (*h["active"].values(), h["has_loss"]))

    f32, i8 = stack("float32"), stack("int8")
    out["history_value_bytes"] = {"float32": value_bytes(f32), "int8": value_bytes(i8)}
    out["int8_value_bytes_frac"] = value_bytes(i8) / value_bytes(f32)
    out["int8_all_bytes_frac"] = all_bytes(i8) / all_bytes(f32)
    agree = {}
    for name in ("float32", "int8"):
        a, b = packed[(name, "on")], packed[(name, "0")]
        close = np.isclose(a, b, rtol=1e-5, atol=1e-6)
        agree[name] = {"share_close": float(close.mean()),
                       "max_abs_diff": float(np.abs(a - b).max())}
    out["fused_vs_grouped"] = agree
    report["wide_cohort"] = out
    log(f"wide cohort: {out}")
    for name, a in agree.items():
        # the routes pick the same candidate unless two EI scores tie within
        # float32 noise; allow a few such near-ties among S*B*L values
        if a["share_close"] < 0.995:
            raise AssertionError(f"fused and grouped cohorts disagree ({name}): {a}")
    for key, t in out["ticks"].items():
        if key.endswith("fused") and t["fused_launches"] < 4:
            raise AssertionError(f"the fused wide cohort launched no fused kernel: {t}")
    if not all(np.isfinite(m).all() for m in packed.values()):
        raise AssertionError("the wide cohort proposed non-finite values")
    if out["int8_value_bytes_frac"] > 0.30:
        raise AssertionError(f"int8 history takes {out['int8_value_bytes_frac']:.3f} of f32")


def kernel_types(kernels, steps):
    """Launches and device ms per step of profiled kernels, grouped by the
    first element type their name mentions (int64 lanes of the threefry
    PRNG, float64 of the single-rounding steps, float32, bool); copies
    and others name none."""
    out = {}
    for a in kernels:
        name = a.key
        kind = next((t for t, words in (("int64", ("<long", " long")),
                                        ("float64", ("<double", " double")),
                                        ("float32", ("<float", " float")),
                                        ("bool", ("<bool", " bool")))
                     if any(w in name for w in words)), "other")
        n, ms = out.get(kind, (0.0, 0.0))
        out[kind] = (n + a.count / steps, ms + a.self_device_time_total / 1e3 / steps)
    return {k: {"launches_per_step": n, "device_ms_per_step": ms} for k, (n, ms) in out.items()}


def _loop_runner_rows(device, capture, dom, cfg):
    """Rows of ``LOOP_CHECK_TRIALS`` branin trials through a
    ``DeviceLoopRunner`` on ``device`` (chunks of 10, seeds 100 + start),
    and the final state."""
    import numpy as np

    from hyperopt_tpu_torch import device_fmin
    from hyperopt_tpu_torch.base import Domain

    runner = device_fmin.DeviceLoopRunner(Domain(dom.traceable, dom.space), cfg, LOOP_STARTUP,
                                          LOOP_CHECK_TRIALS, device=device, capture=capture)
    state = runner.init_state()
    rows = []
    for start in range(0, LOOP_CHECK_TRIALS, runner.CHUNK):
        state, r = runner.run_chunk(state, start, start + runner.CHUNK, seed=100 + start)
        rows.append(r)
    return np.concatenate(rows), state


def phase_device_loop(report):
    """The on-device loop: card vs CPU, graph vs eager, then
    ``fmin_device`` (cold and warm) and ``fmin(device_loop=True)`` on
    branin at 1000 evaluations, and one profiled chunk of replays."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import hyperopt_tpu_torch as port
    from hyperopt_tpu_torch import device_fmin, megakernel, zoo
    from hyperopt_tpu_torch.base import Domain

    dom = zoo.ZOO["branin"]
    cfg = {"prior_weight": 1.0, "n_EI_candidates": MAIN_CANDIDATES, "gamma": 0.25, "LF": 25}
    out = {}

    # card vs CPU, and graph replays vs eager steps on the card
    cpu, _ = _loop_runner_rows("cpu", True, dom, cfg)
    eager, eager_state = _loop_runner_rows(DEVICE, False, dom, cfg)
    graph, graph_state = _loop_runner_rows(DEVICE, True, dom, cfg)
    L = len(trials_cs(dom).labels)
    same = 0
    for a, b in zip(cpu, graph):
        if not (np.allclose(a[:L], b[:L], rtol=1e-4, atol=1e-5) and np.array_equal(a[L:2 * L],
                                                                                    b[L:2 * L])):
            break
        same += 1
    bitwise = bool(np.array_equal(graph, eager, equal_nan=True)) and all(
        torch.equal(a[l], b[l]) for a, b in zip(graph_state[:2], eager_state[:2]) for l in a
    ) and torch.equal(graph_state[2], eager_state[2])
    out["cpu_agreement"] = {"trials": LOOP_CHECK_TRIALS, "matching_prefix": same}
    out["graph_equals_eager_bitwise"] = bitwise
    log(f"device loop: card follows the CPU on {same} of {LOOP_CHECK_TRIALS} trials; "
        f"graph == eager bit for bit: {bitwise}")
    if same != LOOP_CHECK_TRIALS:
        raise AssertionError(f"the card's device loop left the CPU's stream at trial {same}")
    if not bitwise:
        raise AssertionError("the graph replays differ from the eager steps on the card")

    def counts_zero():
        megakernel.ei_diff.launches = megakernel.ei_diff.captures = 0
        megakernel.ei_diff.graph_launches = 0

    def counts():
        return {"launches": megakernel.ei_diff.launches, "captures": megakernel.ei_diff.captures,
                "graph_launches": megakernel.ei_diff.graph_launches}

    cs = trials_cs(dom)

    # fmin_device, cold (warm-up step and capture of each branch) and warm
    runs = {}
    for phase in ("cold", "warm"):
        counts_zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trials = port.fmin_device(dom.traceable, dom.space, MAIN_EVALS,
                                  n_EI_candidates=MAIN_CANDIDATES, seed=0, return_trials=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = [l for l in trials.losses() if l is not None]
        runs[phase] = {"wall_sec": wall, "best_loss": float(min(losses)),
                       "evals": len(trials.trials), "ei_diff": counts(),
                       "in_space": all(in_space(cs, d) for d in trials.trials)}
    stats = [s for s in device_fmin.loop_stats()
             if s["kind"] == "whole_run" and s["cap"] == MAIN_EVALS]
    runs["capture_sec"] = stats[-1]["capture_sec"] if stats else None
    runs["ei_diff_nodes"] = stats[-1]["ei_diff_nodes"] if stats else None
    out["fmin_device"] = runs
    log(f"fmin_device: {runs}")

    # fmin(device_loop=True): chunks of 10 steps, one readback each
    tuned = functools.partial(port.tpe.suggest, n_EI_candidates=MAIN_CANDIDATES)
    counts_zero()
    trials = port.Trials()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    port.fmin(dom.traceable, dom.space, algo=tuned, max_evals=MAIN_EVALS, trials=trials,
              rstate=np.random.default_rng(0), show_progressbar=False, device_loop=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [l for l in trials.losses() if l is not None]
    out["fmin_device_loop"] = {"wall_sec": wall, "best_loss": float(min(losses)),
                               "evals": len(trials.trials), "ei_diff": counts(),
                               "in_space": all(in_space(cs, d) for d in trials.trials)}
    log(f"fmin(device_loop=True): {out['fmin_device_loop']}")

    # one chunk of 10 TPE replays, timed, then one under torch.profiler
    runner = device_fmin.DeviceLoopRunner(Domain(dom.traceable, dom.space), cfg, LOOP_STARTUP,
                                          MAIN_EVALS)
    state = runner.init_state()
    state, _ = runner.run_chunk(state, 0, 30, seed=1)  # startup, then TPE (warm graphs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = runner.run_chunk(state, 30, 40, seed=2)
    chunk_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = runner.run_chunk(state, 40, 50, seed=3)
        torch.cuda.synchronize()
    kernels = [a for a in prof.key_averages()
               if a.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(a.self_device_time_total for a in kernels) / 1e3
    ei = [a for a in kernels if "ei_diff_kernel" in a.key]
    steps = 10
    out["profiled_chunk"] = {
        "steps": steps, "chunk_ms_per_step": chunk_ms / steps,
        "device_ms_per_step": busy_ms / steps,
        "kernel_launches_per_step": sum(a.count for a in kernels) / steps,
        "ei_diff_kernels": sum(a.count for a in ei),
        "ei_diff_device_ms_per_step": sum(a.self_device_time_total for a in ei) / 1e3 / steps,
        "device_idle_share": 1.0 - busy_ms / chunk_ms,
        "graph_launches": sum(a.count for a in prof.key_averages() if a.key == "cudaGraphLaunch"),
        "by_type": kernel_types(kernels, steps),
        "top_kernels": [{"name": a.key[:80], "launches_per_step": a.count / steps,
                         "device_ms_per_step": a.self_device_time_total / 1e3 / steps}
                        for a in sorted(kernels, key=lambda a: -a.self_device_time_total)[:8]]}
    report["device_loop"] = out
    log(f"device loop profile: { {k: v for k, v in out['profiled_chunk'].items() if k != 'top_kernels'} }")

    for name, r in (("fmin_device cold", runs["cold"]), ("fmin_device warm", runs["warm"]),
                    ("fmin(device_loop=True)", out["fmin_device_loop"])):
        if r["evals"] != MAIN_EVALS or not r["in_space"]:
            raise AssertionError(f"{name}: {r['evals']} trials, in space: {r['in_space']}")
        if not r["best_loss"] < dom.loss_target:
            raise AssertionError(f"{name}: best loss {r['best_loss']} misses {dom.loss_target}")
        if r["ei_diff"]["graph_launches"] < MAIN_EVALS - LOOP_STARTUP - 1:
            raise AssertionError(f"{name}: the TPE graph did not launch ei_diff per step: {r}")
    if runs["warm"]["ei_diff"]["captures"] != 0:
        raise AssertionError(f"the warm fmin_device captured again: {runs['warm']}")
    if out["profiled_chunk"]["ei_diff_kernels"] != steps:
        raise AssertionError(f"the profiled chunk ran ei_diff {out['profiled_chunk']['ei_diff_kernels']}"
                             f" times in {steps} TPE steps")
    return runs["warm"]["ei_diff"]["graph_launches"]


def suggester_algos():
    """The phase-10 suggesters by name, each with its own counter of TPE
    asks (a ``tpe.suggest`` call past its startup draws, counted on the
    host apart from the kernel's count), and aTPE's featurization seconds
    per ask under ``"atpe_featurize"``."""
    from hyperopt_tpu_torch import anneal, atpe, mix, rand, tpe

    tpe_asks = {"mix": 0, "atpe": 0, "atpe_featurize": []}

    def counted(name):
        def suggest(new_ids, domain, trials, seed, **cfg):
            if len(trials.trials) >= cfg.get("n_startup_jobs", tpe._default_n_startup_jobs):
                tpe_asks[name] += 1
            return tpe.suggest(new_ids, domain, trials, seed, **cfg)
        return suggest

    class CountedATPE(atpe.ATPEOptimizer):
        """``atpe.suggest`` (one featurization per ask) with its
        ``tpe.suggest`` call counted."""

        def suggest(self, new_ids, domain, trials, seed):
            t0 = time.perf_counter()
            rec = self.recommend(domain, trials)
            tpe_asks["atpe_featurize"].append(time.perf_counter() - t0)
            return counted("atpe")(new_ids, domain, trials, seed, **rec)

    mixed = functools.partial(mix.suggest, p_suggest=[(0.8, counted("mix")),
                                                      (0.1, anneal.suggest),
                                                      (0.1, rand.suggest)])
    return {"anneal": anneal.suggest, "mix": mixed, "atpe": CountedATPE().suggest}, tpe_asks


def same_prefix(a_trials, b_trials):
    """How many leading trials of two runs propose the same values:
    integers equal, floats within rtol 1e-4."""
    import numpy as np

    n = 0
    for a, b in zip(a_trials, b_trials):
        va, vb = a["misc"]["vals"], b["misc"]["vals"]
        if va.keys() != vb.keys() or any(len(va[k]) != len(vb[k]) for k in va):
            break
        if not all(np.allclose(va[k], vb[k], rtol=1e-4, atol=1e-5) for k in va):
            break
        n += 1
    return n


def profile_asks(ask, asks):
    """``torch.profiler`` over ``asks`` calls of ``ask(seed)``: wall, device
    busy time and kernel launches per ask, and the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for seed in range(asks):
            ask(seed + 1)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [a for a in prof.key_averages()
               if a.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(a.self_device_time_total for a in kernels) / 1e3
    return {"asks": asks, "profiled_wall_ms_per_ask": wall_ms / asks,
            "device_busy_ms_per_ask": busy_ms / asks,
            "kernel_launches_per_ask": sum(a.count for a in kernels) / asks,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "ei_diff_kernels_per_ask": sum(a.count for a in kernels
                                           if "ei_diff_kernel" in a.key) / asks}


def phase_suggesters(report):
    """Annealing, mix and aTPE on the card: CPU agreement on 40 trials, then
    the 1000-evaluation branin run of each and aTPE on hartmann6."""
    import numpy as np
    import torch

    import hyperopt_tpu_torch as port
    from hyperopt_tpu_torch import megakernel, zoo
    from hyperopt_tpu_torch.base import Domain

    out = {"agreement": {}, "runs": {}}
    for name, dom_name in (("anneal", "many_dists"), ("mix", "branin"), ("atpe", "branin")):
        dom = zoo.ZOO[dom_name]
        runs = []
        for device in ("cpu", DEVICE):
            algos, _ = suggester_algos()
            t = port.Trials(device=device)
            port.fmin(dom.objective, dom.space, algo=algos[name], max_evals=SUGGEST_CHECK_TRIALS,
                      trials=t, rstate=np.random.default_rng(5), show_progressbar=False)
            runs.append(t.trials)
        same = same_prefix(*runs)
        out["agreement"][f"{name}/{dom_name}"] = same
        log(f"{name} on {dom_name}: the card follows the CPU on {same} of {SUGGEST_CHECK_TRIALS}")
        if same != SUGGEST_CHECK_TRIALS:
            raise AssertionError(f"{name}: the card left the CPU's stream at trial {same}")

    launches = {}
    for name, dom_name, evals in (("anneal", "branin", MAIN_EVALS), ("mix", "branin", MAIN_EVALS),
                                  ("atpe", "branin", MAIN_EVALS),
                                  ("atpe", "hartmann6", ATPE_H6_EVALS)):
        dom = zoo.ZOO[dom_name]
        algos, tpe_asks = suggester_algos()
        algo = algos[name]
        ask_s = []  # (seconds, whether the ask ran TPE)

        def timed(new_ids, domain, trials, seed, algo=algo, ask_s=ask_s, tpe_asks=tpe_asks):
            before = tpe_asks.get(name, 0)
            t0 = time.perf_counter()
            docs = algo(new_ids, domain, trials, seed)
            ask_s.append((time.perf_counter() - t0, tpe_asks.get(name, 0) > before))
            return docs

        trials = port.Trials()
        megakernel.ei_diff.launches = megakernel.fused_sample_ei.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        port.fmin(dom.objective, dom.space, algo=timed, max_evals=evals, trials=trials,
                  rstate=np.random.default_rng(0), show_progressbar=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_ei = megakernel.ei_diff.launches
        n_fused = megakernel.fused_sample_ei.launches
        n_tpe = tpe_asks.get(name, 0)
        key = f"{name}/{dom_name}"
        launches[key] = n_ei
        losses = [l for l in trials.losses() if l is not None]
        domain = Domain(dom.objective, dom.space)
        ids = [len(trials.trials)]
        algo(ids, domain, trials, 0)  # warm: the first ask on a new Domain
        run = {"evals": len(trials.trials), "wall_sec": wall, "best_loss": float(min(losses)),
               "median_ask_ms": 1e3 * statistics.median(t for t, _ in ask_s),
               "tpe_asks": n_tpe, "ei_diff_launches": n_ei,
               "fused_launches": n_fused,
               "in_space": all(in_space(domain.cs, d) for d in trials.trials),
               "profile": profile_asks(lambda seed: algo(ids, domain, trials, seed),
                                       SUGGEST_PROFILED)}
        if name != "anneal":
            run["median_tpe_ask_ms"] = 1e3 * statistics.median(t for t, tpe in ask_s if tpe)
        if name == "atpe":
            run["median_featurize_ms"] = 1e3 * statistics.median(tpe_asks["atpe_featurize"])
        run["ei_diff_launches_per_ask"] = n_ei / len(ask_s)
        out["runs"][key] = run
        log(f"{key}: {run}")
        if run["evals"] != evals or not run["in_space"]:
            raise AssertionError(f"{key}: {run['evals']} trials, in space: {run['in_space']}")
        if n_fused:
            raise AssertionError(f"{key}: launched the fused kernel {n_fused} times")
        if name == "anneal" and n_ei:
            raise AssertionError(f"anneal launched ei_diff {n_ei} times")
        if name != "anneal" and (n_ei != run["tpe_asks"] or run["tpe_asks"] < 1):
            raise AssertionError(f"{key}: {n_ei} ei_diff launches for {run['tpe_asks']} TPE asks")
        if dom_name == "branin" and not run["best_loss"] < dom.loss_target:
            raise AssertionError(f"{key}: best loss {run['best_loss']} misses {dom.loss_target}")
    report["suggesters"] = out
    return launches


def phase_widened_service(report):
    """``make_study_mix(1024)`` through ``StudyScheduler(widen=True)``, then
    widened vs unwidened grouped on the card (bit for bit) and widened on
    the card vs the CPU, 8 studies x 30 trials."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    from hyperopt_tpu_torch import megakernel, zoo
    from hyperopt_tpu_torch.service import StudyScheduler

    sched = StudyScheduler(device=DEVICE, widen=True)
    mix = zoo.make_study_mix(SERVICE_STUDIES)
    items = {sched.create_study(it.domain.space, seed=it.seed,
                                n_startup_jobs=it.n_startup_jobs): it for it in mix}
    sids = list(items)
    objective_of = {sid: it.domain.objective for sid, it in items.items()}
    t0 = time.perf_counter()
    drive_waves(sched, sids, objective_of, SERVICE_STARTUP)
    startup_sec = time.perf_counter() - t0
    per_wave, bad = [], []
    # the shapes ei_diff launches at on this path, (P, n, m), read from the
    # launch checks every CUDA launch passes
    shapes = collections.Counter()
    launchable = megakernel._launchable

    def recording(name, P, tensors):
        if name == "ei_diff":
            shapes[(P, tensors[0].shape[1], tensors[1].shape[1])] += 1
        return launchable(name, P, tensors)

    def check(w, answers):
        per_wave.append(megakernel.ei_diff.launches)
        for sid, (a,) in answers.items():
            doc = {"misc": {"vals": {k: [v] for k, v in a["params"].items()}}}
            if not in_space(sched._studies[sid].domain.cs, doc):
                bad.append((sid, a))

    megakernel.ei_diff.launches = megakernel.fused_sample_ei.launches = 0
    megakernel._launchable = recording
    try:
        times = drive_waves(sched, sids, objective_of, SERVICE_WAVES, on_wave=check)
    finally:
        megakernel._launchable = launchable
    launches = {"ei_diff": megakernel.ei_diff.launches,
                "fused_sample_ei": megakernel.fused_sample_ei.launches}
    ei_per_wave = [b - a for a, b in zip([0] + per_wave, per_wave)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        drive_waves(sched, sids, objective_of, SERVICE_PROFILED)
        prof_wall = time.perf_counter() - t1
    kernels = [a for a in prof.key_averages()
               if a.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(a.self_device_time_total for a in kernels)
    ms = sorted(1e3 * t for t in times)
    out = {"studies": len(sids), "startup_sec": startup_sec, "measured_waves": SERVICE_WAVES,
           "studies_per_sec": len(sids) * len(times) / sum(times),
           "wave_ms_p50": statistics.median(ms),
           "wave_ms_p99": ms[min(len(ms) - 1, math.ceil(0.99 * len(ms)) - 1)],
           "wave_ms": [1e3 * t for t in times], "launches": launches,
           "ei_diff_launches_per_wave": ei_per_wave,
           "ei_diff_shapes": sorted([list(k), v] for k, v in shapes.items()),
           "cohorts": sorted((c.cap, c.n_slots, c.n_live, len(c.cs.labels))
                             for c in sched._cohorts.values()),
           "profiled_wall_ms_per_wave": 1e3 * prof_wall / SERVICE_PROFILED,
           "device_busy_ms_per_wave": busy_us / 1e3 / SERVICE_PROFILED,
           "kernel_launches_per_wave": sum(a.count for a in kernels) / SERVICE_PROFILED,
           "device_idle_share": (1.0 - busy_us / 1e3 / (1e3 * prof_wall)) if busy_us else None,
           "unwidened": {k: report["service_wave"][k] for k in
                         ("wave_ms_p50", "wave_ms_p99", "studies_per_sec",
                          "kernel_launches_per_wave", "device_busy_ms_per_wave")}}
    log(f"widened service wave: { {k: v for k, v in out.items() if k != 'wave_ms'} }")
    if not all(c.widen for c in sched._cohorts.values()):
        raise AssertionError("a cohort of the study mix did not widen")
    if launches["fused_sample_ei"]:
        raise AssertionError(f"the widened wave launched the fused kernel: {launches}")
    if min(ei_per_wave) < 1:
        raise AssertionError(f"a widened wave launched no ei_diff kernel: {ei_per_wave}")
    if bad:
        raise AssertionError(f"{len(bad)} proposals lie outside their space, e.g. {bad[0]}")

    # bit for bit against the unwidened grouped cohort, and card vs CPU
    knob = os.environ.get("HYPEROPT_TPU_MEGAKERNEL")
    os.environ["HYPEROPT_TPU_MEGAKERNEL"] = "0"
    try:
        streams = {}
        for device, widen in ((DEVICE, False), (DEVICE, True), ("cpu", True)):
            s2 = StudyScheduler(device=device, widen=widen)
            doms = [zoo.ZOO["branin" if i % 2 else "hartmann6"] for i in range(COHORT_STUDIES)]
            ids2 = [s2.create_study(d.space, seed=40 + i, n_startup_jobs=5)
                    for i, d in enumerate(doms)]
            drive_waves(s2, ids2, {sid: d.objective for sid, d in zip(ids2, doms)},
                        COHORT_TRIALS)
            streams[(str(device), widen)] = [s2._studies[sid].trials.trials for sid in ids2]
    finally:
        if knob is None:
            os.environ.pop("HYPEROPT_TPU_MEGAKERNEL", None)
        else:
            os.environ["HYPEROPT_TPU_MEGAKERNEL"] = knob
    wide, grouped = streams[(DEVICE, True)], streams[(DEVICE, False)]
    bitwise = [sum(1 for a, b in zip(ws, gs) if a["misc"]["vals"] == b["misc"]["vals"])
               for ws, gs in zip(wide, grouped)]
    follows = [same_prefix(c, w) for c, w in zip(streams[("cpu", True)], wide)]
    out["widened_equals_grouped_bitwise"] = bitwise
    out["widened_card_follows_cpu"] = follows
    report["widened_service_wave"] = out
    log(f"widened == grouped on the card, trials per study: {bitwise}; "
        f"card follows the CPU: {follows}")
    if bitwise != [COHORT_TRIALS] * COHORT_STUDIES:
        raise AssertionError(f"the widened cohort left the grouped one's bits: {bitwise}")
    if follows != [COHORT_TRIALS] * COHORT_STUDIES:
        raise AssertionError(f"the widened cohort on the card left the CPU's stream: {follows}")
    return launches["ei_diff"], sorted(shapes)


# phase 12: the ML domains and the evaluation backends
ML_BATCH, ML_BATCH_CPU_POINTS, ML_BATCH_REPS = 4096, 16, 3
ML_HOST_EVALS, ML_LOOP_EVALS, ML_EXECUTOR_EVALS, ML_STORE_EVALS = 64, 40, 64, 40
ML_LOOP_CFG = {"n_EI_candidates": 32, "gamma": 0.5}
ML_QUEUE, ML_WORKERS = 16, 2


def _ml_fit(d):
    """``ml_logreg_cv``'s objective, reporting where its fit ran: the file
    store's workers and the host loop both evaluate through it."""
    from hyperopt_tpu_torch import zoo

    loss = zoo.ml_logreg_cv_objective(d)
    return {"loss": float(loss), "status": "ok", "fit_device": loss.device.type}


def counted_tpe(asks, **tuning):
    """``tpe.suggest`` (tuned) counting its TPE asks (calls past the
    startup draws) into ``asks[0]``."""
    from hyperopt_tpu_torch import tpe

    def suggest(new_ids, domain, trials, seed):
        if len(trials.trials) >= tuning.get("n_startup_jobs", tpe._default_n_startup_jobs):
            asks[0] += 1
        return tpe.suggest(new_ids, domain, trials, seed, **tuning)
    return suggest


def ei_counts_zero():
    from hyperopt_tpu_torch import megakernel

    for k in (megakernel.ei_diff, megakernel.fused_sample_ei):
        k.launches = k.captures = k.graph_launches = 0


def ei_counts():
    from hyperopt_tpu_torch import megakernel

    k = megakernel.ei_diff
    return {"launches": k.launches, "captures": k.captures, "graph_launches": k.graph_launches,
            "fused_sample_ei": megakernel.fused_sample_ei.launches}


def _ml_prior_flats(dom, n, device, seed):
    """``n`` prior draws of ``dom``'s space (``rand.suggest`` on ``device``)
    as a flat batch of tensors there: float32, int32 for integer labels."""
    import numpy as np
    import torch

    import hyperopt_tpu_torch as port
    from hyperopt_tpu_torch.base import Domain

    domain = Domain(dom.traceable, dom.space)
    t = port.Trials(device=device)
    docs = port.rand.suggest(list(range(n)), domain, t, seed)
    flat = {}
    for l in domain.cs.labels:
        is_int = domain.cs.params[l].is_int
        vals = [(d["misc"]["vals"][l] or [0])[0] for d in docs]
        flat[l] = torch.as_tensor(np.asarray(vals, np.int32 if is_int else np.float32),
                                  device=device)
    return domain, flat


def _ml_batch(out):
    """(a) ``Domain.make_batch_eval`` of ``ml_logreg_cv`` over 4096 prior
    draws on the card: fits per second, kernels per dispatch, and the
    card against the port on the CPU at a few points of the batch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hyperopt_tpu_torch import zoo

    dom = zoo.ZOO["ml_logreg_cv"]
    domain, flat = _ml_prior_flats(dom, ML_BATCH, DEVICE, 1)
    batch = domain.make_batch_eval()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = batch(flat)
    torch.cuda.synchronize()
    first_sec = time.perf_counter() - t0
    secs = []
    for _ in range(ML_BATCH_REPS):
        t0 = time.perf_counter()
        again = batch(flat)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        batch(flat)
        torch.cuda.synchronize()
        prof_sec = time.perf_counter() - t0
    kernels = [a for a in prof.key_averages()
               if a.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(a.self_device_time_total for a in kernels) / 1e3
    idx = torch.linspace(0, ML_BATCH - 1, ML_BATCH_CPU_POINTS).long().to(DEVICE)
    cpu = batch({l: v[idx].cpu() for l, v in flat.items()})
    card = losses[idx].cpu()
    err = (card - cpu).abs()
    sec = statistics.median(secs)
    out["batch_eval"] = {
        "batch": ML_BATCH, "first_dispatch_sec": first_sec, "dispatch_sec": secs,
        "evals_per_sec": ML_BATCH / sec, "fold_fits_per_sec": 4 * ML_BATCH / sec,
        "kernel_launches_per_dispatch": sum(a.count for a in kernels),
        "device_busy_ms_per_dispatch": busy_ms, "profiled_dispatch_ms": 1e3 * prof_sec,
        "device_idle_share": 1.0 - busy_ms / (1e3 * prof_sec),
        "finite": bool(torch.isfinite(losses).all()), "repeat_bitwise": bool(torch.equal(losses, again)),
        "cpu_points": ML_BATCH_CPU_POINTS, "card_vs_cpu_max_abs_err": float(err.max()),
        "loss_min": float(losses.min()), "loss_median": float(losses.median())}
    log(f"ML batch eval: {out['batch_eval']}")
    if not out["batch_eval"]["finite"] or losses.shape != (ML_BATCH,):
        raise AssertionError(f"the batch evaluation gave {losses.shape}, finite: "
                             f"{out['batch_eval']['finite']}")
    if not bool((err <= TOL * torch.clamp(cpu.abs(), min=1.0) + 1e-5).all()):
        raise AssertionError(f"the card's batch evaluation left the CPU's: {err.tolist()}")


def _ml_host_loop(out):
    """(b) ``fmin(ml_logreg_cv, algo=tpe.suggest)``, the host loop: every
    fit on the card, ``ei_diff`` once per TPE ask."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import hyperopt_tpu_torch as port
    from hyperopt_tpu_torch import zoo
    from hyperopt_tpu_torch.utils import evaluation_device

    dom = zoo.ZOO["ml_logreg_cv"]
    asks = [0]
    trials = port.Trials()
    ei_counts_zero()
    t0 = time.perf_counter()
    port.fmin(_ml_fit, dom.space, algo=counted_tpe(asks), max_evals=ML_HOST_EVALS,
              trials=trials, rstate=np.random.default_rng(0), show_progressbar=False)
    wall = time.perf_counter() - t0
    counts = ei_counts()
    point = {"lr": 0.1, "l2": 1e-3, "momentum": 0.5}
    with evaluation_device(DEVICE):
        zoo.ml_logreg_cv_objective(point)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(5):
            float(zoo.ml_logreg_cv_objective(point))
        eval_ms = 1e3 * (time.perf_counter() - t1) / 5
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            float(zoo.ml_logreg_cv_objective(point))
    kernels = [a for a in prof.key_averages()
               if a.device_type == torch.autograd.DeviceType.CUDA]
    devices = sorted({d["result"]["fit_device"] for d in trials.trials})
    out["host_loop"] = {"evals": len(trials.trials), "wall_sec": wall, "tpe_asks": asks[0],
                        "ei_diff": counts, "fit_devices": devices,
                        "best_loss": float(min(trials.losses())),
                        "eval_ms": eval_ms,
                        "kernel_launches_per_eval": sum(a.count for a in kernels),
                        "device_busy_ms_per_eval":
                            sum(a.self_device_time_total for a in kernels) / 1e3}
    log(f"ML host loop: {out['host_loop']}")
    if devices != ["cuda"]:
        raise AssertionError(f"the host loop's fits ran on {devices}")
    if counts["launches"] != asks[0] or asks[0] < 1:
        raise AssertionError(f"ei_diff launched {counts['launches']} times in {asks[0]} TPE asks")
    return counts["launches"]


def _ml_device_loop(out):
    """(c) the device loop on both ML domains: graph replays equal eager
    steps bit for bit, then ``fmin_device`` and ``fmin(device_loop=True)``
    at 40 evaluations (``n_EI_candidates=32``, ``gamma=0.5``): kernels per
    step, capture time, the warm run's wall, ``ei_diff`` once per TPE step."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import hyperopt_tpu_torch as port
    from hyperopt_tpu_torch import device_fmin, tpe, zoo
    from hyperopt_tpu_torch.base import Domain

    startup = tpe._default_n_startup_jobs
    tpe_steps = ML_LOOP_EVALS - startup
    cfg = {"prior_weight": 1.0, "LF": 25, **ML_LOOP_CFG}
    res = {}
    # graph replays vs eager steps of the runner, on the heavier domain
    dom = zoo.ZOO["ml_model_select_cv"]
    rows = {}
    for capture in (False, True):
        runner = device_fmin.DeviceLoopRunner(Domain(dom.traceable, dom.space), cfg, startup,
                                              ML_LOOP_EVALS, device=DEVICE, capture=capture)
        state = runner.init_state()
        chunks = []
        for start in range(0, ML_LOOP_EVALS, runner.CHUNK):
            state, r = runner.run_chunk(state, start, start + runner.CHUNK, seed=100 + start)
            chunks.append(r)
        rows[capture] = np.concatenate(chunks)
    res["graph_equals_eager_bitwise"] = bool(np.array_equal(rows[True], rows[False],
                                                            equal_nan=True))
    log(f"ML device loop: graph == eager bit for bit: {res['graph_equals_eager_bitwise']}")
    if not res["graph_equals_eager_bitwise"]:
        raise AssertionError("the ML device loop's graph replays differ from its eager steps")
    launches = 0
    for name in ("ml_logreg_cv", "ml_model_select_cv"):
        dom = zoo.ZOO[name]
        runs = {}
        for phase in ("cold", "warm"):
            ei_counts_zero()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trials = port.fmin_device(dom.traceable, dom.space, ML_LOOP_EVALS, seed=0,
                                      return_trials=True, **ML_LOOP_CFG)
            torch.cuda.synchronize()
            runs[phase] = {"wall_sec": time.perf_counter() - t0, "evals": len(trials.trials),
                           "ei_diff": ei_counts(),
                           "best_loss": float(np.nanmin([np.nan if l is None else l
                                                         for l in trials.losses()]))}
        stats = [s for s in device_fmin.loop_stats()
                 if s["kind"] == "whole_run" and s["cap"] == ML_LOOP_EVALS]
        runs["loop_stats"] = stats[-1] if stats else None
        algo = functools.partial(port.tpe.suggest, **ML_LOOP_CFG)
        ei_counts_zero()
        trials = port.Trials()
        t0 = time.perf_counter()
        port.fmin(dom.traceable, dom.space, algo=algo, max_evals=ML_LOOP_EVALS, trials=trials,
                  rstate=np.random.default_rng(0), show_progressbar=False, device_loop=True)
        torch.cuda.synchronize()
        best = trials.best_trial
        runs["fmin_device_loop"] = {"wall_sec": time.perf_counter() - t0,
                                    "evals": len(trials.trials), "ei_diff": ei_counts(),
                                    "best_loss": best["result"]["loss"],
                                    "best_vals": best["misc"]["vals"]}
        stats = [s for s in device_fmin.loop_stats()
                 if s["kind"] == "chunk" and s["cap"] == ML_LOOP_EVALS]
        runs["fmin_device_loop"]["loop_stats"] = stats[-1] if stats else None
        # the last chunk of 10 TPE replays, timed and then (over the same
        # state, the same kernels) under torch.profiler
        runner = device_fmin.DeviceLoopRunner(Domain(dom.traceable, dom.space), cfg, startup,
                                              ML_LOOP_EVALS)
        state = runner.init_state()
        state, _ = runner.run_chunk(state, 0, ML_LOOP_EVALS - 10, seed=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.run_chunk(state, ML_LOOP_EVALS - 10, ML_LOOP_EVALS, seed=2)
        torch.cuda.synchronize()
        chunk_ms = 1e3 * (time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            runner.run_chunk(state, ML_LOOP_EVALS - 10, ML_LOOP_EVALS, seed=2)
            torch.cuda.synchronize()
            prof_ms = 1e3 * (time.perf_counter() - t0)
        kernels = [a for a in prof.key_averages()
                   if a.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(a.self_device_time_total for a in kernels) / 1e3
        runs["profiled_chunk"] = {
            "steps": 10, "chunk_ms_per_step": chunk_ms / 10, "device_ms_per_step": busy_ms / 10,
            "profiled_ms_per_step": prof_ms / 10,
            "kernel_launches_per_step": sum(a.count for a in kernels) / 10,
            "ei_diff_kernels": sum(a.count for a in kernels if "ei_diff_kernel" in a.key),
            "device_idle_share": 1.0 - busy_ms / prof_ms,
            "top_kernels": [{"name": a.key[:80], "launches_per_step": a.count / 10,
                             "device_ms_per_step": a.self_device_time_total / 1e3 / 10}
                            for a in sorted(kernels, key=lambda a: -a.self_device_time_total)[:6]]}
        res[name] = runs
        log(f"ML device loop {name}: {runs}")
        for what, r in (("fmin_device cold", runs["cold"]), ("fmin_device warm", runs["warm"]),
                        ("fmin(device_loop=True)", runs["fmin_device_loop"])):
            ei = r["ei_diff"]
            if r["evals"] != ML_LOOP_EVALS:
                raise AssertionError(f"{name} {what}: {r['evals']} trials")
            if ei["launches"] + ei["graph_launches"] != tpe_steps:
                raise AssertionError(f"{name} {what}: ei_diff ran {ei} in {tpe_steps} TPE steps")
        if runs["warm"]["ei_diff"]["captures"] != 0:
            raise AssertionError(f"{name}: the warm fmin_device captured again")
        if runs["profiled_chunk"]["ei_diff_kernels"] != 10:
            raise AssertionError(f"{name}: the profiled chunk ran ei_diff "
                                 f"{runs['profiled_chunk']['ei_diff_kernels']} times in 10 steps")
        if name == "ml_model_select_cv":  # the inactive family is empty in the docs
            vals = runs["fmin_device_loop"]["best_vals"]
            inactive = "lr_mlp" if vals["model"][0] == 0 else "lr_lin"
            if vals[inactive] != []:
                raise AssertionError(f"an inactive parameter has a value: {vals}")
        launches += runs["fmin_device_loop"]["ei_diff"]["graph_launches"]
    out["device_loop"] = res
    return launches


def _ml_executor(out):
    """(d) ``fmin`` over ``ExecutorTrials(traceable=True)`` with a queue of
    16: each queue is one batch evaluation on the card."""
    import numpy as np

    import hyperopt_tpu_torch as port
    from hyperopt_tpu_torch import zoo
    from hyperopt_tpu_torch.parallel import ExecutorTrials

    dom = zoo.ZOO["ml_logreg_cv"]
    asks = [0]
    trials = ExecutorTrials(n_workers=1, traceable=True)
    ei_counts_zero()
    t0 = time.perf_counter()
    try:
        port.fmin(dom.traceable, dom.space, algo=counted_tpe(asks), max_evals=ML_EXECUTOR_EVALS,
                  max_queue_len=ML_QUEUE, trials=trials, rstate=np.random.default_rng(0),
                  show_progressbar=False)
    finally:
        trials.shutdown()
    wall = time.perf_counter() - t0
    counts = ei_counts()
    states = [d["state"] for d in trials.trials]
    out["executor"] = {"evals": len(trials.trials), "wall_sec": wall, "tpe_asks": asks[0],
                       "ei_diff": counts, "batch_evals": trials.metrics.counter("batch_evals").value,
                       "all_done": states == [2] * len(states),
                       "best_loss": float(min(trials.losses()))}
    log(f"ML executor: {out['executor']}")
    if len(states) != ML_EXECUTOR_EVALS or not out["executor"]["all_done"]:
        raise AssertionError(f"the executor left trials unfinished: {states}")
    if counts["launches"] != asks[0] or asks[0] < 1:
        raise AssertionError(f"ei_diff launched {counts['launches']} times in {asks[0]} TPE asks")
    if out["executor"]["batch_evals"] < 2:
        raise AssertionError("the executor evaluated no queue as one batch")
    return counts["launches"]


def _ml_file_store(out):
    """(e) ``fmin`` over ``FileTrials`` in a temporary directory, served by
    two ``python -m hyperopt_tpu_torch.worker`` processes on the card: no
    trial claimed twice, every doc done, every fit on the card."""
    import tempfile

    import numpy as np

    import hyperopt_tpu_torch as port
    from hyperopt_tpu_torch import zoo
    from hyperopt_tpu_torch.filestore import FileTrials

    dom = zoo.ZOO["ml_logreg_cv"]
    asks = [0]
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    with tempfile.TemporaryDirectory() as store:
        trials = FileTrials(store)
        procs = [subprocess.Popen([sys.executable, "-m", "hyperopt_tpu_torch.worker",
                                   "--store", store, "--poll-interval", "0.02",
                                   "--reserve-timeout", "120"],
                                  env=env, cwd=root, stdout=subprocess.DEVNULL,
                                  stderr=subprocess.PIPE, text=True)
                 for _ in range(ML_WORKERS)]
        ei_counts_zero()
        t0 = time.perf_counter()
        try:
            port.fmin(_ml_fit, dom.space, algo=counted_tpe(asks), max_evals=ML_STORE_EVALS,
                      max_queue_len=ML_WORKERS, trials=trials, rstate=np.random.default_rng(0),
                      show_progressbar=False)
            wall = time.perf_counter() - t0
        finally:
            errs = []
            for p in procs:
                p.terminate()
                try:
                    _, e = p.communicate(timeout=60)
                except subprocess.TimeoutExpired:
                    p.kill()
                    _, e = p.communicate(timeout=60)
                errs.append((e or "")[-2000:])
        counts = ei_counts()
        claims = [e["tid"] for e in trials.store.read_events() if e["event"] == "trial_claimed"]
        done = sorted(os.listdir(os.path.join(store, "done")))
        left = {s: os.listdir(os.path.join(store, s))
                for s in ("new", "running", "error", "cancel")}
        owners = sorted({d["owner"] for d in trials.trials})
        devices = sorted({d["result"].get("fit_device") for d in trials.trials})
    out["file_store"] = {"evals": len(trials.trials), "wall_sec": wall, "tpe_asks": asks[0],
                         "ei_diff": counts, "claims": len(claims),
                         "claimed_twice": len(claims) - len(set(claims)), "done": len(done),
                         "left": {k: len(v) for k, v in left.items()}, "workers": len(owners),
                         "fit_devices": devices, "best_loss": float(min(trials.losses()))}
    log(f"ML file store: {out['file_store']}")
    if len(done) != ML_STORE_EVALS or any(left.values()):
        raise AssertionError(f"the store did not finish every trial: {out['file_store']}; "
                             f"worker stderr: {errs}")
    if len(claims) != len(set(claims)) or len(claims) != ML_STORE_EVALS:
        raise AssertionError(f"claims: {sorted(claims)}")
    if devices != ["cuda"]:
        raise AssertionError(f"the workers' fits ran on {devices}")
    if counts["launches"] != asks[0] or asks[0] < 1:
        raise AssertionError(f"ei_diff launched {counts['launches']} times in {asks[0]} TPE asks")
    return counts["launches"]


def phase_ml_backends(report):
    """Phase 12: the ML zoo domains and the evaluation backends on the
    card, paths (a)-(e); every shape ``ei_diff`` launches at is recorded."""
    import collections

    import torch

    from hyperopt_tpu_torch import megakernel

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matrix products are on")
    out = {}
    shapes = collections.Counter()
    launchable = megakernel._launchable

    def recording(name, P, tensors):
        if name == "ei_diff":
            shapes[(P, tensors[0].shape[1], tensors[1].shape[1])] += 1
        return launchable(name, P, tensors)

    launches = {}
    t_phase = time.perf_counter()
    megakernel._launchable = recording
    try:
        t0 = time.perf_counter()
        _ml_batch(out)
        out["batch_eval"]["phase_sec"] = time.perf_counter() - t0
        for path, fn in (("ml_host_tpe", _ml_host_loop), ("ml_device_loop", _ml_device_loop),
                         ("ml_executor", _ml_executor), ("ml_file_store", _ml_file_store)):
            t0 = time.perf_counter()
            launches[path] = fn(out)
            out[f"{path}_sec"] = time.perf_counter() - t0
    finally:
        megakernel._launchable = launchable
    out["phase_sec"] = time.perf_counter() - t_phase
    out["ei_diff_shapes"] = sorted([list(k), v] for k, v in shapes.items())
    report["ml_backends"] = out
    log(f"phase 12: {out['phase_sec']:.1f} s, ei_diff shapes {out['ei_diff_shapes']}")
    return launches, sorted(shapes)


# phase 13: the multi-device path on BASELINE config 5's surrogate
# (hpob_surrogate).  (a) a 1000-trial history, cap 1024, 64 keys, 24 and an
# indivisible 1000 candidates; (b) suggest_sharded in fmin; (c) the
# HYPEROPT_TPU_SHARD knob and a 2-entry cohort of 256 hartmann6 studies;
# (d) fmin_multihost at the driver's defaults, batch 1024, 4096
# evaluations, in one process and in two controllers on the one card;
# (e) the elastic fleet at (d)'s parameters, 2 generations, then one more
MD_HISTORY, MD_CAP, MD_KEYS, MD_CANDIDATES = 1000, 1024, 64, (24, 1000)
MD_FMIN_EVALS, MD_FMIN_QUEUE, MD_KNOB_EVALS = 64, 16, 40
MD_COHORT = dict(studies=256, cap=128, ids=4, candidates=24, ticks=3)
MD_BATCH, MD_EVALS, MD_SEED = 1024, 4096, 0
MD_FLEET_GENS = 2
MD_CONTROLLER_SEC = 600  # a controller process's limit; collectives time out before it
MD_TOL = (1e-4, 1e-5)  # rtol, atol of a comparison held at the card tolerance


class LaunchLog:
    """The shapes ``ei_diff`` and ``fused_sample_ei`` launch at, in order,
    read from the launch checks every CUDA launch passes; the CPU's plain
    twins pass none."""

    def __init__(self):
        from hyperopt_tpu_torch import megakernel

        self.shapes = []
        self._mk = megakernel
        self._real = megakernel._launchable

    def __enter__(self):
        real = self._real

        def recording(name, P, tensors):
            self.shapes.append((name, P, tensors[0].shape[1], tensors[-1 if name == "ei_diff"
                                                                     else 2].shape[1]))
            return real(name, P, tensors)

        self._mk._launchable = recording
        return self

    def __exit__(self, *exc):
        self._mk._launchable = self._real

    def take(self):
        out, self.shapes = self.shapes, []
        return out


def _md_plans(shapes):
    """The component splits ``ei_diff`` plans for each (name, P, n, m)."""
    from hyperopt_tpu_torch import megakernel

    return [megakernel._launch_plan("ei_diff", P, n, m)["splits"] if DEVICE == "cuda" else None
            for name, P, n, m in shapes if name == "ei_diff"]


def _md_compare(what, got, want, got_shapes, want_shapes, parts):
    """Hold a sharded result against the one-device program's.  Bit for
    bit when every launch of each of the ``parts`` entries planned the
    one-device launch's component splits; otherwise at the card tolerance
    with the flipped proposals counted (at most one allowed)."""
    import torch

    gp, wp = _md_plans(got_shapes), _md_plans(want_shapes)
    k = len(wp)
    same_plans = len(gp) == parts * k and all(gp[p * k + j] == wp[j] for p in range(parts)
                                              for j in range(k))
    got, want = got.cpu(), want.cpu()
    rtol, atol = MD_TOL
    close = torch.isclose(got, want, rtol=rtol, atol=atol).all(dim=-1)
    row = {"what": what, "shapes_sharded": [list(s) for s in got_shapes],
           "shapes_one_device": [list(s) for s in want_shapes],
           "splits_sharded": gp, "splits_one_device": wp, "plans_match": same_plans,
           "bitwise": bool(torch.equal(got, want)), "rows": int(close.numel()),
           "flips": int((~close).sum()),
           "max_abs_diff": float((got - want).abs().max()) if got.numel() else 0.0}
    log(f"phase 13 compare: {row}")
    if same_plans and not row["bitwise"]:
        raise AssertionError(f"{what}: the same plans gave different bits: {row}")
    if not same_plans and row["flips"] > 1:
        raise AssertionError(f"{what}: {row['flips']} flipped proposals: {row}")
    return row


def _md_history(device, n, cap, seed=3):
    """A padded hpob_surrogate history of ``n`` prior draws on ``device``."""
    import numpy as np
    import torch

    from hyperopt_tpu_torch import prng, zoo
    from hyperopt_tpu_torch.spaces import compile_space

    dom = zoo.ZOO["hpob_surrogate"]
    cs = compile_space(dom.space)
    keys = prng.fold_in(prng.PRNGKey(seed, "cpu"), torch.arange(cap))
    flats = {l: v.numpy() for l, v in cs.sample_flat(keys).items()}
    live = np.arange(cap) < n
    losses = np.full(cap, np.inf, np.float32)
    for i in range(n):
        losses[i] = dom.objective(cs.assemble({l: (int(flats[l][i]) if cs.params[l].is_int
                                                   else float(flats[l][i]))
                                               for l in cs.labels}))
    acts = cs.active_flat(flats)
    return cs, {"losses": torch.tensor(losses, device=device),
                "has_loss": torch.tensor(live, device=device),
                "vals": {l: torch.tensor(np.where(live, flats[l], 0).astype(np.float32),
                                         device=device) for l in cs.labels},
                "active": {l: torch.tensor(np.asarray(acts[l]) * np.ones(cap, bool) & live,
                                           device=device) for l in cs.labels}}


def _md_numeric_labels(cs):
    """The labels ``ei_diff`` scores: numeric and un-quantized."""
    from hyperopt_tpu_torch.algos import tpe

    return [l for l in cs.labels if cs.params[l].dist.family not in ("categorical", "randint")
            and tpe._parzen_from(cs.params[l].dist)[4] is None]


def _md_sharded_call(what, step, args, rec, parts, n_numeric):
    """Run one sharded step with ``ei_diff``'s count set to 0 just before
    and read just after; every entry must score every numeric label."""
    from hyperopt_tpu_torch import megakernel

    megakernel.ei_diff.launches = 0
    got = step(*args)
    n_launch = megakernel.ei_diff.launches
    shapes = rec.take()
    rows = sum(P for name, P, _, _ in shapes if name == "ei_diff")
    if n_launch < parts or rows < parts * n_numeric:
        raise AssertionError(f"{what}: {n_launch} ei_diff launches over {rows} label rows "
                             f"for {parts} entries x {n_numeric} numeric labels")
    return got, shapes, n_launch


def _md_sharded_proposals(out, launches):
    """(a) suggest_batch_sharded on a 2x1 mesh of the card's two entries and
    propose_sharded_candidates on a 1x2 mesh, against the one-device
    program: a 1-entry mesh, and every shard's candidates in one launch.
    The launches counted are the sharded calls' own."""
    from hyperopt_tpu_torch import prng
    from hyperopt_tpu_torch.parallel import driver, sharding

    import torch

    cs, hist = _md_history(DEVICE, MD_HISTORY, MD_CAP)
    n_numeric = len(_md_numeric_labels(cs))
    keys = prng.fold_in(prng.PRNGKey(5, DEVICE), torch.arange(MD_KEYS, device=DEVICE))
    two = sharding.make_mesh(devices=[DEVICE, DEVICE])
    one = sharding.make_mesh(devices=[DEVICE])
    cand = sharding.make_mesh(n_cand_shards=2, devices=[DEVICE, DEVICE])
    rows, counted = [], 0
    with LaunchLog() as rec:
        for n_cand in MD_CANDIDATES:
            cfg = dict(driver._default_cfg(MD_KEYS), n_EI_candidates=n_cand)
            what = f"suggest_batch_sharded 2x1, {n_cand} candidates"
            got, got_shapes, n_launch = _md_sharded_call(
                what, sharding.suggest_batch_sharded(cs, cfg, two, packed=True), (hist, keys),
                rec, 2, n_numeric)
            counted += n_launch
            want = sharding.suggest_batch_sharded(cs, cfg, one, packed=True)(hist, keys)
            rows.append(_md_compare(what, got, want, got_shapes, rec.take(), 2))
            for batch in (None, MD_KEYS):
                k = keys if batch else keys[0]
                what = f"propose_sharded_candidates 1x2, batch {batch}, {n_cand} candidates"
                step = sharding.propose_sharded_candidates(cs, cfg, cand, packed=True,
                                                           batch=batch)
                got, got_shapes, n_launch = _md_sharded_call(what, step, (hist, k), rec, 2,
                                                             n_numeric)
                counted += n_launch
                fused = sharding._propose_fused_pool(cs, cfg, cand, packed=True, batch=batch)
                want = fused(hist, k)
                rows.append(_md_compare(what, got, want, got_shapes, rec.take(), 2))
                bad = ~torch.isfinite(got)
                if bool(bad.any()):
                    raise AssertionError("a sharded proposal is not finite")
    launches["sharded_proposals"] = counted
    out["sharded_proposals"] = rows


def _md_counted(algo, asks, n_startup=20):
    def counted(new_ids, domain, trials, seed):
        if len(trials.trials) >= n_startup:
            asks[0] += 1
        return algo(new_ids, domain, trials, seed)
    return counted


def _md_suggest_sharded(out, launches, shapes):
    """(b) fmin(algo=tpe.suggest_sharded(n_cand_shards=2), max_queue_len=16)
    on the 1x2 mesh of the card's two entries, against the same on two CPU
    entries; ei_diff launches = TPE asks x 2 shards x 3 numeric labels."""
    import numpy as np
    import torch

    import hyperopt_tpu_torch as port
    from hyperopt_tpu_torch import megakernel, zoo
    from hyperopt_tpu_torch.parallel import sharding

    dom = zoo.ZOO["hpob_surrogate"]
    runs = {}
    for device in ("cpu", DEVICE):
        mesh = sharding.make_mesh(n_cand_shards=2, devices=[device, device])
        asks = [0]
        algo = _md_counted(port.tpe.suggest_sharded(mesh=mesh), asks)
        t = port.Trials(device=device)
        megakernel.ei_diff.launches = 0
        with LaunchLog() as rec:
            t0 = time.perf_counter()
            port.fmin(dom.objective, dom.space, algo=algo, max_evals=MD_FMIN_EVALS,
                      max_queue_len=MD_FMIN_QUEUE, trials=t, rstate=np.random.default_rng(0),
                      show_progressbar=False)
            if device != "cpu":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        runs[device] = (t, asks[0], megakernel.ei_diff.launches, wall, rec.take())
    t, asks, n_launch, wall, got_shapes = runs[DEVICE]
    shapes.update(tuple(s[1:]) for s in got_shapes if s[0] == "ei_diff")
    same = same_prefix(runs["cpu"][0].trials, t.trials)
    res = {"evals": len(t.trials), "tpe_asks": asks, "ei_diff_launches": n_launch,
           "wall_sec": wall, "card_follows_cpu": same,
           "shapes": sorted({tuple(s) for s in got_shapes}),
           "best_loss": float(min(l for l in t.losses() if l is not None))}
    out["suggest_sharded_fmin"] = res
    launches["suggest_sharded_fmin"] = n_launch
    log(f"phase 13 (b): {res}")
    if same != MD_FMIN_EVALS:
        raise AssertionError(f"the card's sharded fmin left the CPU's stream: {res}")
    if asks < 1 or n_launch != asks * 2 * 3:
        raise AssertionError(f"ei_diff launched {n_launch} times in {asks} TPE asks")
    if not all(in_space(trials_cs(dom), d) for d in t.trials):
        raise AssertionError("a sharded proposal lies outside the space")


def _md_set_env(name, value):
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    return old


def _md_shard_knob(out, launches, shapes, fused_shapes):
    """(c) HYPEROPT_TPU_SHARD=auto on tpe.suggest and on StudyScheduler equal
    the knob unset bit for bit, on the one card (a one-entry mesh) and with
    the card named twice as the local devices (a 2-entry mesh: the
    scheduler's cohorts split their studies over it); then the
    cohort program over a 2-entry mesh for 256 hartmann6 studies equals the
    unsharded cohort bit for bit, one fused_sample_ei launch per shard and
    tick."""
    import numpy as np
    import torch

    import hyperopt_tpu_torch as port
    from hyperopt_tpu_torch import megakernel, zoo
    from hyperopt_tpu_torch.algos import tpe
    from hyperopt_tpu_torch.base import Domain
    from hyperopt_tpu_torch.parallel import sharding
    from hyperopt_tpu_torch.service import StudyScheduler, scheduler

    dom = zoo.ZOO["hpob_surrogate"]
    res = {}
    streams, ticks_of = {}, {}
    rec = LaunchLog()
    real_local, real_tick = sharding.local_devices, scheduler._Cohort.tick
    for knob, entries in ((None, 1), ("auto", 1), ("auto", 2)):
        old = _md_set_env("HYPEROPT_TPU_SHARD", knob)
        ticks_of[knob, entries] = tick_log = []

        def tick(cohort, demand, mesh=None, tick_log=tick_log):
            before = megakernel.fused_sample_ei.launches
            packed = real_tick(cohort, demand, mesh=mesh)
            tick_log.append((mesh.size if mesh is not None else 1,
                             megakernel.fused_sample_ei.launches - before))
            return packed

        # two entries: the one card named twice as this process's devices,
        # as the CPU tests repeat the CPU
        sharding.local_devices = (lambda device=None: real_local(device) * 2) if entries == 2 \
            else real_local
        scheduler._Cohort.tick = tick
        try:
            rec.__enter__()
            t = port.Trials(device=DEVICE)
            port.fmin(dom.objective, dom.space, algo=port.tpe.suggest, max_evals=MD_KNOB_EVALS,
                      trials=t, rstate=np.random.default_rng(2), show_progressbar=False)
            sched = StudyScheduler(device=DEVICE)
            doms = [zoo.ZOO["branin" if i % 2 else "hartmann6"] for i in range(COHORT_STUDIES)]
            sids = [sched.create_study(d.space, seed=40 + i, n_startup_jobs=5)
                    for i, d in enumerate(doms)]
            drive_waves(sched, sids, {sid: d.objective for sid, d in zip(sids, doms)}, 12)
            streams[knob, entries] = (
                [(d["misc"]["vals"], d["result"]) for d in t.trials],
                [[(d["misc"]["vals"], d["result"]) for d in sched._studies[sid].trials]
                 for sid in sids])
        finally:
            rec.__exit__()
            _md_set_env("HYPEROPT_TPU_SHARD", old)
            sharding.local_devices, scheduler._Cohort.tick = real_local, real_tick
        for name, *shape in rec.take():
            (fused_shapes if name == "fused_sample_ei" else shapes).add(tuple(shape))
    want = streams[None, 1]
    res["tpe_suggest_bitwise"] = want[0] == streams["auto", 1][0]
    res["scheduler_bitwise"] = want[1] == streams["auto", 1][1]
    res["tpe_suggest_2_entries_bitwise"] = want[0] == streams["auto", 2][0]
    res["scheduler_2_entries_bitwise"] = want[1] == streams["auto", 2][1]
    plain_ticks, two_ticks = ticks_of[None, 1], ticks_of["auto", 2]
    res["scheduler_ticks"] = len(two_ticks)
    res["scheduler_sharded_ticks"] = sum(n > 1 for n, _ in two_ticks)
    res["scheduler_fused_launches"] = {"unsharded": sum(f for _, f in plain_ticks),
                                       "2_entries": sum(f for _, f in two_ticks)}
    launches["sharded_scheduler_fused"] = res["scheduler_fused_launches"]["2_entries"]
    log(f"phase 13 (c): scheduler ticks {res['scheduler_ticks']}, sharded "
        f"{res['scheduler_sharded_ticks']}, fused_sample_ei {res['scheduler_fused_launches']}")
    if not all(res[k] for k in ("tpe_suggest_bitwise", "scheduler_bitwise",
                                "tpe_suggest_2_entries_bitwise", "scheduler_2_entries_bitwise")):
        raise AssertionError(f"HYPEROPT_TPU_SHARD=auto moved the stream: {res}")
    # every cohort tick splits its slots over both entries and launches
    # the fused kernel once per entry where the unsharded tick launched once
    if (len(two_ticks) != len(plain_ticks) or res["scheduler_sharded_ticks"] != len(two_ticks)
            or any(f2 != n * f1 for (n, f2), (_, f1) in zip(two_ticks, plain_ticks))
            or res["scheduler_fused_launches"]["unsharded"] < 1):
        raise AssertionError(f"the 2-entry scheduler's fused_sample_ei launches {two_ticks} are "
                             f"not 2 x the unsharded ticks' {plain_ticks}")

    S, cap, B, n, ticks = (MD_COHORT[k] for k in ("studies", "cap", "ids", "candidates",
                                                   "ticks"))
    hdom = zoo.ZOO["hartmann6"]
    cs = Domain(hdom.objective, hdom.space).cs
    cfg = {"prior_weight": 1.0, "n_EI_candidates": n, "gamma": 0.25, "LF": 25,
           "ei_select": "argmax", "ei_tau": 1.0, "prior_eps": 0.0}
    rng = np.random.default_rng(13)
    live = rng.integers(cap // 4, cap - 8, S)
    active = np.arange(cap)[None, :] < live[:, None]
    vals = {l: rng.uniform(0, 1, (S, cap)).astype(np.float32) for l in cs.labels}
    losses = np.where(active, rng.normal(size=(S, cap)), np.inf).astype(np.float32)

    def stack():
        return {"vals": {l: torch.tensor(v, device=DEVICE) for l, v in vals.items()},
                "active": {l: torch.tensor(active, device=DEVICE) for l in cs.labels},
                "losses": torch.tensor(losses, device=DEVICE),
                "has_loss": torch.tensor(active, device=DEVICE)}

    rows = np.zeros((S, 1, 2 * len(cs.labels) + 3), np.float32)
    rows[:, :, -1] = cap
    ids = (np.arange(S * B).reshape(S, B) + 77).astype(np.uint32)
    mesh = sharding.suggest_mesh(devices=[DEVICE, DEVICE])
    old = _md_set_env("HYPEROPT_TPU_MEGAKERNEL", "on")
    try:
        plain = tpe.build_suggest_batched(cs, cfg, S, cap, B, donate=False)
        run = tpe.build_suggest_batched(cs, cfg, S, cap, B, mesh=mesh)
        hist_one, hist_two = stack(), stack()
        same, fused = [], 0
        with LaunchLog() as rec:
            for tick in range(ticks):
                seeds = np.stack([tpe._seed_words(100 * tick + s) for s in range(S)])
                _, want = plain(hist_one, rows, seeds, ids)
                rec.take()
                megakernel.fused_sample_ei.launches = 0
                hist_two, got = run(hist_two, rows, seeds, ids)
                fused += megakernel.fused_sample_ei.launches
                cohort_shapes = rec.take()
                res.setdefault("cohort_fused_shapes", sorted({tuple(s) for s in cohort_shapes}))
                fused_shapes.update(tuple(s[1:]) for s in cohort_shapes)
                same.append(bool(torch.equal(got.cpu(), want.cpu())))
    finally:
        _md_set_env("HYPEROPT_TPU_MEGAKERNEL", old)
    res.update(cohort_studies=S, cohort_ticks=ticks, cohort_bitwise=same,
               cohort_fused_launches=fused)
    launches["sharded_cohort_fused"] = fused
    out["shard_knob"] = res
    log(f"phase 13 (c): {res}")
    if not all(same):
        raise AssertionError(f"the sharded cohort left the unsharded one's bits: {res}")
    if fused != 2 * ticks:
        raise AssertionError(f"fused_sample_ei launched {fused} times for 2 shards x {ticks} "
                             "ticks")


def _md_instrument(driver, per_gen, profile_call):
    """Time every proposal call of the driver (synchronized), with its
    ei_diff launches, shapes and peak memory, profile proposal call
    ``profile_call`` (device busy and idle share; None: none), time each
    generation's evaluation (``per_gen`` objective calls each, or one
    window over the run when None), and keep the driver's span totals;
    returns the records, the objective and the undo."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hyperopt_tpu_torch import megakernel, zoo

    rec = {"propose": [], "evaluate": {}}
    real_build = driver.tpe.build_propose

    def build(cs, cfg, **kw):
        propose = real_build(cs, cfg, **kw)

        def timed(history, keys):
            i = len(rec["propose"])
            if DEVICE == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            before = megakernel.ei_diff.launches
            prof = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                    if i == profile_call and DEVICE == "cuda" else None)
            with LaunchLog() as log_:
                if prof is not None:
                    prof.__enter__()
                t0 = time.perf_counter()
                outp = propose(history, keys)
                if DEVICE == "cuda":
                    torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0)
                if prof is not None:
                    prof.__exit__(None, None, None)
            row = {"ms": ms, "keys": int(keys.shape[0]),
                   "ei_diff_launches": megakernel.ei_diff.launches - before,
                   "shapes": [list(s) for s in log_.take()],
                   "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                                if DEVICE == "cuda" else None)}
            if prof is not None:
                kernels = [a for a in prof.key_averages()
                           if a.device_type == torch.autograd.DeviceType.CUDA]
                busy = sum(a.self_device_time_total for a in kernels) / 1e3
                row.update(profiled=True, device_busy_ms=busy, kernel_launches=sum(
                    a.count for a in kernels), device_idle_share=1.0 - busy / ms,
                    top_kernels=[{"name": a.key[:80], "launches": a.count,
                                  "device_ms": a.self_device_time_total / 1e3}
                                 for a in sorted(kernels,
                                                 key=lambda a: -a.self_device_time_total)[:8]])
            rec["propose"].append(row)
            return outp
        return timed

    driver.tpe.build_propose = build
    real_obs = driver._DriverObs

    class Obs(real_obs):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            rec["spans"] = self.tracer.totals

    driver._DriverObs = Obs
    dom = zoo.ZOO["hpob_surrogate"]
    calls = [0]

    def objective(d):
        gen = 0 if per_gen is None else calls[0] // per_gen
        calls[0] += 1
        t = time.perf_counter()
        first = rec["evaluate"].setdefault(gen, [t, t])
        loss = dom.objective(d)
        first[1] = time.perf_counter()
        return loss

    def restore():
        driver.tpe.build_propose = real_build
        driver._DriverObs = real_obs

    return rec, objective, restore


def _md_run(max_evals, fleet_dir=None, single=True, per_gen=MD_BATCH, profile_call=None):
    """One fmin_multihost run at phase 13's parameters, instrumented:
    ``{"checksum", "wall_sec", "propose", "evaluate_ms", "spans", ...}``
    (a profiled run's wall includes the profiler's start and stop)."""
    import torch

    from hyperopt_tpu_torch import megakernel, zoo
    from hyperopt_tpu_torch.parallel import driver

    rec, objective, restore = _md_instrument(driver, per_gen, profile_call)
    megakernel.ei_diff.launches = 0
    try:
        t0 = time.perf_counter()
        res = driver.fmin_multihost(objective, zoo.ZOO["hpob_surrogate"].space, max_evals,
                                    batch=MD_BATCH, seed=MD_SEED, _force_single=single,
                                    fleet_dir=fleet_dir, device=DEVICE)
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        restore()
    return {"checksum": res.checksum, "n_evals": res.n_evals, "best_loss": res.best_loss,
            "wall_sec": wall, "ei_diff_launches": megakernel.ei_diff.launches,
            "propose": rec["propose"], "spans": dict(rec.get("spans", {})),
            "evaluate_ms": [1e3 * (b - a) for _, (a, b) in sorted(rec["evaluate"].items())]}


def md_controller(argv):
    """A controller process of phase 13 (``chip_smoke.py --md-controller
    collective|fleet RANK PORT|DIR OUT DEVICE MAX_EVALS BATCH``): one rank
    of the two-controller gloo run on the card, or one fleet controller."""
    global DEVICE, MD_BATCH
    mode, rank, where, out, DEVICE, max_evals, batch = argv[:7]
    rank, max_evals, MD_BATCH = int(rank), int(max_evals), int(batch)
    from hyperopt_tpu_torch.parallel import multihost

    if mode == "collective":
        kw = {"device": "cpu"} if DEVICE == "cpu" else {"local_device_ids": [0]}
        multihost.initialize(f"127.0.0.1:{where}", 2, rank, timeout=MD_CONTROLLER_SEC, **kw)
        res = _md_run(max_evals, single=False, per_gen=MD_BATCH // 2)
    else:
        res = _md_run(max_evals, fleet_dir=where, per_gen=None)
    with open(f"{out}.{rank}", "w") as f:
        json.dump(res, f)
    return 0


def _md_spawn(mode, where, out, max_evals, n=2):
    """Start ``n`` controller processes; returns them."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "HYPEROPT_TPU_WATCHDOG": "0",
           "HYPEROPT_TPU_ALLGATHER_TIMEOUT": str(MD_CONTROLLER_SEC // 2),
           # two processes share the card: return freed blocks' address space
           "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--md-controller", mode,
                              str(r), str(where), out, DEVICE, str(max_evals),
                              str(MD_BATCH)],
                             env=env, cwd=root, stdout=subprocess.DEVNULL,
                             stderr=subprocess.PIPE, text=True)
            for r in range(n)]


def _md_wait(procs, out, what):
    """Wait for every controller; a controller that fails or times out
    fails the phase.  Returns their result records."""
    errs = []
    deadline = time.monotonic() + MD_CONTROLLER_SEC
    try:
        for p in procs:
            _, e = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            errs.append((e or "")[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(f"{what}: a controller failed: "
                             f"{[(p.returncode, e) for p, e in zip(procs, errs)]}")
    results = []
    for r in range(len(procs)):
        with open(f"{out}.{r}") as f:
            results.append(json.load(f))
    return results


def _md_release():
    """Hand the caching allocator's blocks back to the card before
    controller processes share it."""
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def _md_free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _md_driver(out, launches, shapes):
    """(d) fmin_multihost at the driver's defaults, batch 1024, 4096
    evaluations: in this process (_force_single), then as two controller
    processes on the one card over gloo; the checksums must be equal."""
    import tempfile

    single = _md_run(MD_EVALS)
    # the same run again with the third generation's proposal profiled
    profiled = _md_run(MD_EVALS, profile_call=2)
    out["fmin_multihost"] = {"single": single, "single_profiled": profiled}
    rows = [{k: r.get(k) for k in ("ms", "peak_gib")} for r in single["propose"]]
    log(f"phase 13 (d): single wall {single['wall_sec']:.2f} s, propose {rows}")
    _md_release()
    launches["fmin_multihost"] = single["ei_diff_launches"]
    for row in single["propose"]:
        shapes.update(tuple(s[1:]) for s in row["shapes"] if s[0] == "ei_diff")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = _md_spawn("collective", _md_free_port(), os.path.join(tmp, "c"), MD_EVALS)
        ctl = _md_wait(procs, os.path.join(tmp, "c"), "two controllers")
        wall2 = time.perf_counter() - t0
    for c in ctl:
        for row in c["propose"]:
            shapes.update(tuple(s[1:]) for s in row["shapes"] if s[0] == "ei_diff")
    launches["fmin_multihost_controllers"] = sum(c["ei_diff_launches"] for c in ctl)
    res = out["fmin_multihost"]
    res.update(batch=MD_BATCH, evals=MD_EVALS, controllers=ctl,
               two_controller_wall_sec=wall2,
               checksums_equal=all(c["checksum"] == single["checksum"] for c in ctl))
    log(f"phase 13 (d): two controllers {[round(c['wall_sec'], 2) for c in ctl]} s (spawn to "
        f"exit {wall2:.1f} s), propose {[[round(r['ms'], 1) for r in c['propose']] for c in ctl]}"
        f", checksums equal {res['checksums_equal']}")
    if profiled["checksum"] != single["checksum"]:
        raise AssertionError("the profiled single run left the single run's checksum")
    if not res["checksums_equal"]:
        raise AssertionError(f"two controllers' checksums {[c['checksum'] for c in ctl]} != "
                             f"the single run's {single['checksum']}")
    for run in [single] + ctl:
        if not run["propose"] or min(r["ei_diff_launches"] for r in run["propose"]) < 1:
            raise AssertionError(f"a TPE generation launched no ei_diff kernel: {run}")
    return single


def _md_fleet(out, launches, shapes):
    """(e) the elastic fleet: two controller processes at (d)'s parameters
    for 2 generations equal the collective single run; then one controller
    (this process) resumes the store for one more generation, bit for
    bit."""
    import tempfile

    n1, n2 = MD_FLEET_GENS * MD_BATCH, (MD_FLEET_GENS + 1) * MD_BATCH
    want1, want2 = _md_run(n1), _md_run(n2)
    _md_release()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "fleet")
        t0 = time.perf_counter()
        procs = _md_spawn("fleet", store, os.path.join(tmp, "f"), n1)
        ctl = _md_wait(procs, os.path.join(tmp, "f"), "the fleet")
        wall = time.perf_counter() - t0
        resumed = _md_run(n2, fleet_dir=store, per_gen=None)
    launches["fleet"] = sum(c["ei_diff_launches"] for c in ctl) + resumed["ei_diff_launches"]
    for run in ctl + [resumed]:
        for row in run["propose"]:
            shapes.update(tuple(s[1:]) for s in row["shapes"] if s[0] == "ei_diff")
    res = {"generations": MD_FLEET_GENS, "controllers": ctl, "fleet_wall_sec": wall,
           "resumed": resumed,
           "fleet_equals_collective": all(c["checksum"] == want1["checksum"] for c in ctl),
           "resume_equals_collective": resumed["checksum"] == want2["checksum"]}
    out["fleet"] = res
    log(f"phase 13 (e): fleet {[round(c['wall_sec'], 2) for c in ctl]} s, equal "
        f"{res['fleet_equals_collective']}; resumed {resumed['wall_sec']:.2f} s, equal "
        f"{res['resume_equals_collective']}")
    if not (res["fleet_equals_collective"] and res["resume_equals_collective"]):
        raise AssertionError(f"the fleet left the collective run's checksum: "
                             f"{[c['checksum'] for c in ctl]}, {resumed['checksum']} vs "
                             f"{want1['checksum']}, {want2['checksum']}")


def phase_multi_device(report):
    """Phase 13: the multi-device path on one card, paths (a)-(e); every
    shape ``ei_diff`` and ``fused_sample_ei`` launch at is recorded."""
    out = report["multi_device"] = {}  # filled as the paths finish
    launches = {}
    shapes, fused_shapes = set(), set()
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    _md_sharded_proposals(out, launches)
    for row in out["sharded_proposals"]:
        shapes.update(tuple(s[1:]) for s in row["shapes_sharded"] + row["shapes_one_device"]
                      if s[0] == "ei_diff")
    out["a_sec"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _md_suggest_sharded(out, launches, shapes)
    out["b_sec"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _md_shard_knob(out, launches, shapes, fused_shapes)
    out["c_sec"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _md_driver(out, launches, shapes)
    out["d_sec"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _md_fleet(out, launches, shapes)
    out["e_sec"] = time.perf_counter() - t0
    out["phase_sec"] = time.perf_counter() - t_phase
    out["ei_diff_shapes"] = sorted(list(s) for s in shapes)
    out["fused_sample_ei_shapes"] = sorted(list(s) for s in fused_shapes)
    out["launches"] = launches
    log(f"phase 13: {out['phase_sec']:.1f} s, launches {launches}, "
        f"ei_diff shapes {out['ei_diff_shapes']}, fused_sample_ei shapes "
        f"{out['fused_sample_ei_shapes']}")
    return launches, sorted(shapes), sorted(fused_shapes)


def main():
    if sys.argv[1:2] == ["--md-controller"]:
        return md_controller(sys.argv[2:])
    # torch.profiler leaves CUPTI attached after a session unless told to
    # tear it down, and every later launch pays for it (a branin ask ~30%
    # slower after one session); phase 1 profiles before the timed phases
    os.environ.setdefault("TEARDOWN_CUPTI", "1")
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
    rows, frows = phase_kernels(report)
    phase_cpu_agreement(report)
    main_launches, trials, tuned = phase_main(report)
    wide_launches = phase_wide(report)
    phase_profile(report, trials, tuned)
    phase_cohort_agreement(report)
    service_launches = phase_service(report)
    phase_wide_cohort(report)
    loop_launches = phase_device_loop(report)
    suggest_launches = phase_suggesters(report)
    widened_launches, widened_shapes = phase_widened_service(report)
    ml_launches, ml_shapes = phase_ml_backends(report)
    md_launches, md_shapes, md_fused_shapes = phase_multi_device(report)
    # every shape the widened wave and phases 12-13 gave ei_diff is held
    # against the plain version on every candidate: phase 1 planned them,
    # and any it missed is checked here
    planned = {tuple(r["shape"]) for r in rows}
    extra = [check_ei(P, n, m, 0, plain_cmp(P, n, m), False, report["ptxas"])
             for P, n, m in sorted(set(widened_shapes) | set(ml_shapes) | set(md_shapes))
             if (P, n, m) not in planned]
    report["ei_diff_shapes_unplanned"] = [r["shape"] for r in extra]
    rows += extra
    # and every shape phase 13 gave fused_sample_ei (its spaces are uniform:
    # bounded)
    fplanned = {tuple(r["shape"]) for r in frows}
    fextra = [check_fused(P, N, m, 0, True, report["ptxas"])
              for P, N, m in md_fused_shapes if (P, N, m) not in fplanned]
    report["fused_sample_ei_shapes_unplanned"] = [r["shape"] for r in fextra]
    frows += fextra
    report["total_sec"] = time.perf_counter() - t_start

    tick, ftick = rows[4], frows[0]  # the branin ask's and the service tick's shapes
    loop_tick = rows[5]  # the device loop's TPE step
    kernels = [{
        "name": "ei_diff", "route": "cuda", "source": SOURCES["ei_diff"],
        "replaces": REPLACES["ei_diff"], "launches": main_launches,
        "launches_by_path": {"fmin": main_launches, "wide_ask": wide_launches,
                             "service_wave": service_launches["ei_diff"],
                             "device_loop": loop_launches,
                             "fmin_device_loop":
                                 report["device_loop"]["fmin_device_loop"]["ei_diff"]
                                 ["graph_launches"],
                             **{f"fmin {k}": v for k, v in suggest_launches.items()},
                             "widened_service_wave": widened_launches, **ml_launches,
                             **{k: v for k, v in md_launches.items()
                                if k not in ("sharded_cohort_fused",
                                             "sharded_scheduler_fused")}},
        "shape": tick["shape"], "max_abs_err": tick["max_abs_err"],
        "max_err": max(r["max_abs_err"] for r in rows),
        "ms": tick["ms"], "device_ms": tick["device_ms"], "plain_ms": tick["plain_ms"],
        "bound_ms": tick["bound_ms"], "bound_by": tick["bound_by"],
        "bound_share": tick["bound_share"], "library_ms": None,
        "device_loop_shape": {k: loop_tick[k] for k in SHAPE_KEYS if k in loop_tick},
        "shapes": [{k: r[k] for k in SHAPE_KEYS if k in r} for r in rows],
    }, {
        "name": "fused_sample_ei", "route": "cuda", "source": SOURCES["fused_sample_ei"],
        "replaces": REPLACES["fused_sample_ei"],
        "launches": service_launches["fused_sample_ei"],
        "launches_by_path": {"fmin": report["fmin_path_launches"]["fused_sample_ei"],
                             "service_wave": service_launches["fused_sample_ei"],
                             "sharded_cohort": md_launches["sharded_cohort_fused"],
                             "sharded_scheduler": md_launches["sharded_scheduler_fused"]},
        "shape": ftick["shape"], "max_abs_err": ftick["max_abs_err"],
        "max_err": max(r["max_abs_err"] for r in frows),
        "ms": ftick["ms"], "device_ms": ftick["device_ms"], "plain_ms": ftick["plain_ms"],
        "bound_ms": ftick["bound_ms"], "bound_by": ftick["bound_by"],
        "bound_share": ftick["bound_share"], "library_ms": None,
        "shapes": [{k: r[k] for k in SHAPE_KEYS if k in r} for r in frows],
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
