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

14. The service plane: (a) ``ServiceHTTPServer`` in this process on the
    card over ``StudyScheduler(store_root=<tmp>)`` with its WAL, the mix
    (``make_study_mix(512)``, cut from the mix's 1024, ``SVC_STUDIES``)
    admitted over ``POST /study`` and driven to 10 trials a study (5
    prior, 5 TPE asks) by 128 ``ServiceClient`` threads in 8 processes, 4
    studies each: client ask p50/p99, tells/s, waves, asks
    and kernel launches per wave (each TPE wave launches the kernel of
    every route it asks), WAL bytes and fsyncs per wave, the device's
    idle share over a profiled slice; every answer in its space, every
    study at 30 told, the ladder at level 0, ``drain()`` compacts.  The
    server arms the blackbox prober (``arm_prober``, period 30 s): its
    canary cycles beside the tenants must all be ``ok``, and it reports
    the cycles, the canary's client-view ask p50/p99 and the ``/healthz``
    probe fields.  Then the canary in process (``local_digest``) twice on
    the fused route and twice with ``HYPEROPT_TPU_MEGAKERNEL=off``: one
    digest per route, the fused one equal to the server's first-trusted
    (TOFU) golden; and a short server with ``HYPEROPT_TPU_PROFILE`` armed
    whose ticks chaos corrupts after a clean cycle: the prober turns
    ``mismatch`` (detection latency reported), escalates once, and the
    capture it hands the server is recorded by the leader of a later
    wave and holds its kernels (that wave's ms against the median).  (b)
    ``python -m hyperopt_tpu_torch.service.server`` as a real process on
    a store, SIGKILLed at the ``tick`` site by ``HYPEROPT_TPU_CHAOS`` and
    restarted twice (the first restart armed again) while 64 clients (32
    branin studies on the fused route, 32 ``hpob_surrogate`` on
    ``ei_diff``, budget 24) retry through it: every study's (tid, params)
    stream equals an undisturbed scheduler's in this process, bit for bit
    on the fused route, and on ``ei_diff`` bit for bit or at rtol 1e-4,
    atol 1e-5 with at most one flipped proposal (its component split
    depends on the cohort's slot count); then a fresh root with
    ``corrupt@wal`` armed: ``python -m hyperopt_tpu_torch.service.scrub``
    reports every injected corruption and the reboot quarantines the
    studies it names.  (c) The degrade ladder on 64 mix studies under
    ``ioerr@tick`` and non-finite readbacks at the ``tick`` site: every
    ask answers, the levels walked equal a ``DegradeLadder`` fed the same
    faults, and the ladder climbs back to 0 once disarmed; the shapes the
    kernels launched at on ``half_candidates`` and ``small_caps`` are
    held against the plain versions after the phase.  (d) A WAL-only run
    on the card resumes on the card (every ask regenerated): bit for bit
    wherever every regenerated launch planned its component split as the
    live launch did (the plans are printed), else at the card tolerance
    with at most one flip; and a WAL written on the CPU resumes on the
    card to the same ids, seeds and counts, its next 5 asks per study
    agreeing at the card tolerance (flips counted).
15. The replicated serving fleet: ``make_study_mix(128)`` (cut from the
    mix's 1024, ``FLEET_STUDIES``) on 8 shards, each study to 10 trials
    (5 prior, 5 TPE asks) under one of 4 tenants, by 128
    ``ServiceClient`` threads in 8 processes whose seeds
    are every replica's URL.  The replicas are ``chip_smoke.py
    --fleet-replica`` processes on the one card, each ticking both
    kernels before it joins and then running the port server's own
    ``main([... "--fleet" ...])``: r0 and r1 from the start (balanced 4
    and 4 before the drive), r1 SIGKILLed at its ``tell`` site
    (``HYPEROPT_TPU_CHAOS``) near a third of the acknowledged tells, r2
    started at two thirds, every replica SIGTERMed (drained) at the end.
    It fails unless every acknowledged tell is DONE with its loss when a
    fresh card scheduler resumes every shard's WAL chain, and those docs
    are the answers the clients got; every stream equals an undisturbed
    scheduler's in this process (bit for bit on the fused route, on
    ``ei_diff`` bit for bit or at rtol 1e-4, atol 1e-5 with at most one
    flip); r0 adopted r1's shards after the kill, a shard was handed to
    r2, and the clients followed 307s; ``/fleet/load`` shows the heat of
    every shard that held a study and ``read_heat`` over the root agrees;
    ``/tenants`` shows the 4 tenants; every surviving replica that served
    TPE waves launched both kernels.  Every shape the replicas launched
    at is held against the plain versions after the phase.  It reports
    the wall, client ask p50/p99, tells/s, the time from the kill to the
    adopter's first answer, adoption seconds, launches per wave per
    replica and the card's idle share over the drive (NVML's
    ``utilization.gpu`` from ``nvidia-smi`` every 0.5 s, every process's
    kernels counted).  Before the replicas stop, ``python -m
    hyperopt_tpu_torch.obs.prober --targets <r0>,<r2> --cycles 2`` must
    exit 0 with one digest across the replicas.

16. Run observability on the fmin path (branin, BASELINE config 2, 1000
    evaluations, 1024 candidates, ``rstate=np.random.default_rng(0)``):
    (b) the disarmed run, then (a) the same seed armed
    (``fmin(obs=<tmp>/run.jsonl, obs_http=0, profile=<tmp>/prof)`` with
    ``HYPEROPT_TPU_DEVMEM=1``) in a thread while this thread scrapes
    ``/metrics`` (parsed as Prometheus text), ``/snapshot`` (a roofline
    row for ``suggest.tpe``, device bytes) and ``/profile?sec=1``, which
    the run's loop records on its own thread: the capture must hold
    ``ei_diff`` kernels inside ``fmin.tick`` annotations.  The two runs'
    trials are equal bit for bit, every TPE ask launches ``ei_diff`` once
    in both, and the disarmed ask launches phase 5's kernels per ask
    (counted the same way; the armed count beside it).  It reports the
    median ask armed and disarmed, the tick interval the capture's start
    and stop opened, and the device-memory peak.  (c) ``fmin(device_loop=
    True)`` armed and disarmed at 1000 evaluations: bit for bit, equal
    graph launches, ``chunk.execute_sec`` from CUDA events, the analytic
    ``chunk`` cost gauges and the ``history`` owner's bytes.  (d) The
    port's report renders the armed stream with every section,
    ``--export-trace`` merges the capture and ``scripts/validate_trace.py``
    lints it clean; ``fmin_multihost(obs=...)`` on two controller
    processes (``hpob_surrogate``, batch 64, 256 evaluations) writes
    ``run.p0.jsonl`` and ``run.p1.jsonl``, which ``--merge`` renders.
    The capture's ``prof.stop()`` is reported in parts (the device
    synchronize, torch's ``_disable_profiler`` call, and the teardown
    from two small sessions stopped with ``TEARDOWN_CUPTI=0`` and ``=1``),
    and a stall capture taken on another thread during a device-loop run
    states the kernels it holds.
    Every ``ei_diff`` shape of the phase is held against the plain
    version afterwards.
17. The capacity-sharded device loop (``HYPEROPT_TPU_SHARD`` past
    ``HYPEROPT_TPU_HIST_SHARD_MIN``) on meshes that name the card 8 times
    as this process's devices, as phase 13 (c) names it twice: every
    entry lies on the card, so the runner keeps its state whole and
    replays the unsharded loop's graphs.  (a) branin at 1000 evaluations
    and 1024 candidates, the threshold at 8: ``fmin(device_loop=True)``
    equals the unsharded run bit for bit over all 1000 trials, ``ei_diff``
    launches from the TPE graph on every TPE step (counted from that run
    alone), and the card follows the CPU on the first 40 steps (rtol
    1e-4, atol 1e-5); (b) hartmann6 at the default threshold's capacity,
    65,536 rows, 24 startup and 200 TPE steps by ``DeviceLoopRunner``
    chunks, the unsharded runner and then the sharded one, each counted
    and timed in its own run: rows and states bit for bit, chunk wall per
    TPE step and peak ``torch.cuda.max_memory_allocated`` of each, then
    one profiled chunk (device ms and kernel launches per step).  The
    ``ei_diff`` shapes are held against the plain version afterwards.
18. The end-to-end service gates at their smallest sizes, as the operator
    runs them (``scripts/torch_slo_smoke.py`` and
    ``scripts/torch_store_chaos_smoke.py`` through
    ``scripts/torch_gate_common.py``, started together as three
    processes, the STORE gate's two phases apart, each driving its own
    server processes on the card): one
    traced ask whose trace id agrees across the response, the WAL, the
    timeline, ``obs.report --study`` and the access log; seeded WAL
    corruption that ``scrub`` finds, a restart that quarantines (410),
    healthy studies bit for bit, ``scrub --repair``; ENOSPC answered 507
    with ``Retry-After`` and recovered.  Each gate's in-process reference
    must have launched both kernels, and the phase must end within
    ``GATE_PHASE_SEC``.

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
             (5, 32, 41, 0, None, False),
             # phase 18: a one-label study's tick in the gates (cap 16)
             (1, 24, 17, 0, None, False)]
# fused_sample_ei shapes (P, N, m, dead components, bounded): the service
# tick (256 slots x 6 labels, 24 candidates), the wide tick (4 x 1024
# candidates), an unbounded group, a group with dead components, N = m = 1,
# and phase 13's cohort of 256 hartmann6 studies (4 ids x 24 candidates,
# cap 128) unsharded and one shard of it on a 2-entry mesh
FUSED_SHAPES = [(256 * 6, 24, 65, 0, True), (256 * 6, 4 * 1024, 129, 0, True),
                (256 * 2, 24, 65, 0, False), (64, 1000, 300, 77, True), (64, 1, 1, 0, True),
                (256 * 6, 4 * 24, 129, 0, True), (128 * 6, 4 * 24, 129, 0, True),
                (1, 24, 17, 0, True)]  # phase 18: a one-label study's tick (cap 16)
# what the kernels line keeps of each phase-1 shape
SHAPE_KEYS = ("shape", "dead", "below_all_dead", "bounded", "max_abs_err", "ms", "device_ms",
              "device_ms_by", "plain_ms", "bound_ms", "bound_share", "per_thread", "splits",
              "cols", "rows", "blocks", "registers", "smem_bytes")


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


def graph_ms(fn, reps=10):
    """Mean device milliseconds per call of ``fn``, by CUDA events around
    the replay of a CUDA graph that holds ``reps`` calls: the kernels
    alone, without the host's enqueue time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = cuda_ms(graph.replay, reps=5, warmup=1) / reps
    del graph
    return ms


def device_ms(fn, fragment, reps=10):
    """``(ms, by)``: the mean device time per call of the kernel whose
    name holds ``fragment``, over ``reps`` calls of ``fn``.  ``by`` is
    ``"profiler"`` (torch.profiler, CUPTI) unless the profiler's
    ``key_averages()`` hold no launch of ``fragment``, as happened after
    the sessions phase 14 (a) runs on the server's handler threads: then
    ``"cuda_graph"`` (:func:`graph_ms`).  That the kernel launched is
    shown by the wrapper's count and its output, not here."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    seen = [a for a in prof.key_averages()
            if a.device_type == torch.autograd.DeviceType.CUDA]
    hits = [a for a in seen if fragment in a.key]
    if hits:
        return sum(a.self_device_time_total for a in hits) / 1e3 / reps, "profiler"
    log(f"device_ms: the profiler saw no launch of {fragment} (device events: "
        f"{sorted({a.key for a in seen})}); timed from a CUDA graph of {reps} calls")
    return graph_ms(fn, reps), "cuda_graph"


def _bound(ops, nbytes):
    ops_ms = ops / SFU_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def ei_bound(P, n, m):
    """Least time for ``ei_diff`` at (P, n, m): ``megakernel.ei_cost``'s
    exponentials on the special-function units, or its bytes over HBM."""
    from hyperopt_tpu_torch import megakernel

    return _bound(*megakernel.ei_cost(P, n, m))


def fused_bound(P, N, m):
    """Least time for ``fused_sample_ei`` at (P, N, m):
    ``megakernel.fused_cost``'s exponentials and ``ndtri`` on the
    special-function units, or its bytes over HBM."""
    from hyperopt_tpu_torch import megakernel

    return _bound(*megakernel.fused_cost(P, N, m))


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
    dev_ms, dev_by = device_ms(lambda: megakernel.ei_diff(x, *tabs), "ei_diff_kernel")
    plain_ms = cuda_ms(lambda: megakernel.ei_diff_plain(xs, *tabs), reps=5)
    bound_ms, bound_by = ei_bound(P, n, m)
    plan = megakernel._launch_plan("ei_diff", P, n, m)
    row = {"shape": [P, n, m], "dead": dead, "below_all_dead": below_dead,
           "compared_candidates": xs.shape[1],
           "max_abs_err": float(err.max()), "ok": ok, "ms": ms, "device_ms": dev_ms,
           "device_ms_by": dev_by, "plain_ms": plain_ms, "plain_ms_shape": list(xs.shape) + [m],
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
    dev_ms, dev_by = device_ms(lambda: megakernel.fused_sample_ei(*args, bounded),
                               "fused_kernel")
    plain_ms = cuda_ms(lambda: megakernel.fused_sample_ei_plain(*args, bounded), reps=5)
    bound_ms, bound_by = fused_bound(P, N, m)
    row = {"shape": [P, N, m], "dead": dead, "bounded": bounded,
           "max_abs_err": float(max(err_x.max(), err_ei.max())),
           "max_abs_err_x": float(err_x.max()), "max_abs_err_ei": float(err_ei.max()),
           "ok": ok, "ms": ms, "device_ms": dev_ms, "device_ms_by": dev_by,
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
    """The shapes ``(name, P, n, m)`` ``ei_diff`` and ``fused_sample_ei``
    launch at, in order, read from the launch checks every CUDA launch
    passes (from any thread); the CPU's plain twins pass none.  With
    ``tag``, each entry is ``(tag(), name, P, n, m)``."""

    def __init__(self, tag=None):
        from hyperopt_tpu_torch import megakernel

        self.shapes = []
        self._mk = megakernel
        self._real = megakernel._launchable
        self._tag = tag

    def __enter__(self):
        real, tag = self._real, self._tag

        def recording(name, P, tensors):
            shape = (name, P, tensors[0].shape[1],
                     tensors[-1 if name == "ei_diff" else 2].shape[1])
            self.shapes.append(shape if tag is None else (tag(), *shape))
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

        def tick(cohort, demand, mesh=None, tick_log=tick_log, **kw):
            before = megakernel.fused_sample_ei.launches
            packed = real_tick(cohort, demand, mesh=mesh, **kw)
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
    # a built bundle with no stream: fmin_multihost uses it as it is, and its
    # phase totals stay readable after the run
    obs = driver.RunObs(driver.ObsConfig())
    rec["spans"] = obs.tracer.totals
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

    return rec, objective, restore, obs


def _md_run(max_evals, fleet_dir=None, single=True, per_gen=MD_BATCH, profile_call=None,
            obs_path=None):
    """One fmin_multihost run at phase 13's parameters, instrumented:
    ``{"checksum", "wall_sec", "propose", "evaluate_ms", "spans", ...}``
    (a profiled run's wall includes the profiler's start and stop);
    ``obs_path`` arms the run's stream instead (no phase totals then)."""
    import torch

    from hyperopt_tpu_torch import megakernel, zoo
    from hyperopt_tpu_torch.parallel import driver

    rec, objective, restore, obs = _md_instrument(driver, per_gen, profile_call)
    megakernel.ei_diff.launches = 0
    try:
        t0 = time.perf_counter()
        res = driver.fmin_multihost(objective, zoo.ZOO["hpob_surrogate"].space, max_evals,
                                    batch=MD_BATCH, seed=MD_SEED, _force_single=single,
                                    fleet_dir=fleet_dir, device=DEVICE,
                                    obs=obs_path or obs)
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
    """A controller process of phase 13 or 16 (``chip_smoke.py
    --md-controller collective|obs|fleet RANK PORT|DIR OUT DEVICE MAX_EVALS
    BATCH``): one rank of the two-controller gloo run on the card (``obs``:
    armed, its stream ``OUT.p<rank>.jsonl``), or one fleet controller."""
    global DEVICE, MD_BATCH
    mode, rank, where, out, DEVICE, max_evals, batch = argv[:7]
    rank, max_evals, MD_BATCH = int(rank), int(max_evals), int(batch)
    from hyperopt_tpu_torch.parallel import multihost

    if mode in ("collective", "obs"):
        kw = {"device": "cpu"} if DEVICE == "cpu" else {"local_device_ids": [0]}
        multihost.initialize(f"127.0.0.1:{where}", 2, rank, timeout=MD_CONTROLLER_SEC, **kw)
        res = _md_run(max_evals, single=False, per_gen=MD_BATCH // 2,
                      obs_path=f"{out}.jsonl" if mode == "obs" else None)
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


# ---------------------------------------------------------------------------
# phase 14: the service plane
# ---------------------------------------------------------------------------

# (a) the standing mix over HTTP: 512 studies, 128 client threads of 4
# studies each, every study to 10 trials (5 prior, 5 TPE asks: cut from
# phase 7's 25, and from the mix's 1024 studies so that phase 16 fits the
# script's time, PERF.md §4)
SVC_STUDIES, SVC_CLIENTS, SVC_TRIALS, SVC_STARTUP = 512, 128, 10, 5
SVC_CLIENT_PROCS = 8  # processes the client threads run in, 16 each
SVC_WINDOW = 0.005  # the server's gather window (seconds)
# waves profiled from the half-way point, each in a session on the thread
# that leads it: a session started in another thread records none of the
# wave's kernels, and one over every thread (profile_all_threads) leaves
# the process hanging at exit (torch 2.11); a session's start costs
# seconds, so few
SVC_PROFILED_WAVES = 2
# (b) crash and resume: 32 branin (fused) + 32 hpob_surrogate (ei_diff)
# studies, budget 24, the server killed at these tick hits (the first
# restart armed again), then a fresh root with corrupted WAL appends
SVC_CRASH_STUDIES, SVC_CRASH_BUDGET, SVC_CRASH_KILLS = 32, 24, (40, 30)
SVC_CORRUPT_STUDIES, SVC_CORRUPT_TRIALS, SVC_CORRUPT_P = 16, 10, 0.02
SVC_CHILD_SEC = 600  # a server process's limit
# (c) the degrade ladder: the mix's first 64 studies, injected faults for
# SVC_LADDER_WAVES waves at patience SVC_LADDER_PATIENCE
SVC_LADDER_STUDIES, SVC_LADDER_WAVES, SVC_LADDER_PATIENCE = 64, 30, 2
SVC_LADDER_P = 0.05
# (d) replay: 16 mix studies, WAL only, 4 TPE waves, then 5 more asks each
SVC_REPLAY_STUDIES, SVC_REPLAY_WAVES, SVC_REPLAY_NEXT = 16, 4, 5
# the blackbox prober on (a)'s server: its per-request budget (0.8 x period
# / 9, the prober's own rule) must stay above (a)'s ask p99 (1.2-1.8 s on
# an H100), so the default period; its cycles never overlap the profiled
# waves, whose session start stalls queued asks for seconds
SVC_PROBE_PERIOD = 30.0
# the corrupted-tick server: chaos's silent perturbation of every tick's
# read-back proposals, and the cycles it may take to turn mismatch and to
# record the escalation's capture
SVC_PROBE_CORRUPT, SVC_PROBE_CYCLES = "7:corrupt@tick:1.0", 4


def _svc_reset_counts():
    from hyperopt_tpu_torch import megakernel

    megakernel.ei_diff.launches = megakernel.fused_sample_ei.launches = 0


def _svc_counts():
    from hyperopt_tpu_torch import megakernel

    return {"fused_sample_ei": megakernel.fused_sample_ei.launches,
            "ei_diff": megakernel.ei_diff.launches}


def _svc_route(cs):
    from hyperopt_tpu_torch import megakernel

    return "fused_sample_ei" if megakernel.armed(cs) else "ei_diff"


def svc_client(argv):
    """A client process of phase 14 (a) (``chip_smoke.py --svc-client URL
    FIRST LAST THREADS STUDIES TRIALS OUT``): ``THREADS`` ``ServiceClient``
    threads drive the studies ``FIRST..LAST-1`` of ``make_study_mix(STUDIES)``,
    an equal share each, to ``TRIALS`` trials each, and write each ask's
    (start on the wall clock, ms, TPE or not) and the faults to ``OUT``."""
    import threading

    from hyperopt_tpu_torch import zoo
    from hyperopt_tpu_torch.base import Domain
    from hyperopt_tpu_torch.service import ServiceClient

    url, path = argv[0], argv[6]
    first, last, n_threads, n_studies, n_trials = (int(a) for a in argv[1:6])
    mix = zoo.make_study_mix(n_studies)[first:last]
    cs_of = {it.domain.name: Domain(None, it.domain.space).cs for it in mix}
    per = len(mix) // n_threads
    res = {"asks": [], "bad": [], "errors": []}
    lock = threading.Lock()

    def client(k):
        try:
            c = ServiceClient(url, key=first + k, timeout=600)
            mine = []
            for it in mix[k * per:(k + 1) * per]:
                sid = c.create_study(zoo=it.domain.name, seed=it.seed,
                                     n_startup_jobs=SVC_STARTUP)
                mine.append((sid, it.domain))
            for t in range(n_trials):
                for sid, dom in mine:
                    start, t0 = time.time(), time.perf_counter()
                    (a,) = c.ask(sid)
                    ms = 1e3 * (time.perf_counter() - t0)
                    doc = {"misc": {"vals": {l: [v] for l, v in a["params"].items()}}}
                    if not in_space(cs_of[dom.name], doc) or a.get("degraded"):
                        res["bad"].append((sid, a))
                    c.tell(sid, a["tid"], float(dom.objective(a["params"])))
                    with lock:
                        res["asks"].append((start, ms, t >= SVC_STARTUP))
        except Exception as e:  # noqa: BLE001 - reported to the parent
            res["errors"].append(f"client {first + k}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(k,)) for k in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    with open(path, "w") as f:
        json.dump(res, f, default=str)
    return 0


def _svc_shape_counts(shapes):
    """``{kernel: {(P, n, m): launches}}`` of a :class:`LaunchLog`'s
    entries (launches with no work left out)."""
    out = {"ei_diff": {}, "fused_sample_ei": {}}
    for name, P, n, m in shapes:
        if P and n:
            out[name][(P, n, m)] = out[name].get((P, n, m), 0) + 1
    return out


def _svc_http(out, shapes, fused_shapes):
    """(a) the mix over HTTP: the server in this process on the card, the
    client threads in SVC_CLIENT_PROCS processes (in this process they
    would take the interpreter lock from the wave leader).  Every shape
    the waves launch the kernels at joins ``shapes``/``fused_shapes``."""
    import tempfile
    import urllib.request

    import torch
    from torch.profiler import ProfilerActivity, profile

    from hyperopt_tpu_torch.service import ServiceClient, StudyScheduler
    from hyperopt_tpu_torch.service.server import ServiceHTTPServer

    from hyperopt_tpu_torch.obs.prober import probes_path_for, read_probes

    root = tempfile.mkdtemp(prefix="svc_http_")
    sched = StudyScheduler(device=DEVICE, store_root=root, wave_window=SVC_WINDOW)
    server = ServiceHTTPServer(0, scheduler=sched)
    if not server.start():
        raise AssertionError("the service did not bind")
    waves = []  # (asks, routes asked, fused launches, ei_diff launches, sec, profiled)
    inner = sched._run_wave_inner
    # "active" from the profiled waves' start to the last one's end,
    # "probing" while a probe cycle runs: the two never overlap
    prof_state = {"left": None, "busy_us": 0.0, "windows": [], "active": False,
                  "probing": False}
    prober = server.arm_prober(period=SVC_PROBE_PERIOD)
    probe_cycle = prober.run_cycle

    def cycle(now=None):
        while prof_state["active"]:
            time.sleep(0.05)
        prof_state["probing"] = True
        try:
            return probe_cycle(now)
        finally:
            prof_state["probing"] = False

    prober.run_cycle = cycle

    def counted_wave(reqs):
        before = _svc_counts()
        routes = {_svc_route(r.study.domain.cs) for r in reqs}
        profiled = bool(prof_state["left"])
        t0 = time.perf_counter()
        if profiled:
            prof_state["left"] -= 1
            w0 = time.time()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                inner(reqs)
                torch.cuda.synchronize()
            prof_state["windows"].append((w0, time.time()))
            prof_state["busy_us"] += sum(a.self_device_time_total for a in prof.key_averages()
                                         if a.device_type == torch.autograd.DeviceType.CUDA)
            if not prof_state["left"]:
                prof_state["active"] = False
        else:
            inner(reqs)
        dt = time.perf_counter() - t0
        after = _svc_counts()
        waves.append((len(reqs), sorted(routes), after["fused_sample_ei"] - before["fused_sample_ei"],
                      after["ei_diff"] - before["ei_diff"], dt, profiled))

    sched._run_wave_inner = counted_wave
    per_proc = SVC_STUDIES // SVC_CLIENT_PROCS
    threads = SVC_CLIENTS // SVC_CLIENT_PROCS
    outs = [os.path.join(root, f"client{i}.json") for i in range(SVC_CLIENT_PROCS)]
    env = {**os.environ, "HYPEROPT_TPU_WATCHDOG": "0"}
    total = SVC_STUDIES * SVC_TRIALS
    tells = sched.metrics.counter("service.tells")  # counts every scheduler's tells
    tells0 = tells.value
    with LaunchLog() as rec:
        _svc_reset_counts()
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--svc-client",
                                   server.url, str(i * per_proc), str((i + 1) * per_proc),
                                   str(threads), str(SVC_STUDIES), str(SVC_TRIALS), outs[i]],
                                  env=env)
                 for i in range(SVC_CLIENT_PROCS)]
        while any(p.poll() is None for p in procs):
            if (prof_state["left"] is None and tells.value - tells0 >= total // 2
                    and not prof_state["probing"]):
                prof_state["active"] = True
                prof_state["left"] = SVC_PROFILED_WAVES
            if time.perf_counter() - t0 > SVC_CHILD_SEC:
                for p in procs:
                    p.kill()
                raise AssertionError(f"the clients did not finish in {SVC_CHILD_SEC} s")
            time.sleep(0.05)
        wall = time.perf_counter() - t0
        n_tells = tells.value - tells0
        launches = _svc_counts()
    by_shape = _svc_shape_counts(rec.shapes)
    shapes.update(by_shape["ei_diff"])
    fused_shapes.update(by_shape["fused_sample_ei"])
    res_c = {"asks": [], "bad": [], "errors": []}
    for i, (p, path) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or not os.path.exists(path):
            raise AssertionError(f"client process {i} exited {p.returncode}")
        with open(path) as f:
            for k, v in json.load(f).items():
                res_c[k] += v
    if res_c["errors"]:
        raise AssertionError(f"{len(res_c['errors'])} clients failed, e.g. {res_c['errors'][0]}")
    status = ServiceClient(server.url).studies()
    wrong = [s for s in status["studies"] if not s.get("canary")
             and (s.get("n_pending") != 0 or s.get("n_told") != SVC_TRIALS)]
    metrics = urllib.request.urlopen(server.url + "/metrics", timeout=60).read().decode()
    healthz = json.loads(urllib.request.urlopen(server.url + "/healthz", timeout=60).read())
    prober.stop(timeout=60)  # a cycle in flight ends before the view is read
    probes = json.loads(urllib.request.urlopen(server.url + "/probes", timeout=60).read())
    probe_recs, probe_corrupt, _ = read_probes(probes_path_for(root, "single"))
    n_tells -= sum(r.get("asks", 0) for r in probe_recs)  # the canaries' tells
    degrade = sched.degrade.status()
    wal = {"bytes": sched.journal.size_bytes(), "appends": sched.journal.appends,
           "fsyncs": sched.journal.syncs}
    compactions = sched.journal.compactions
    quiesced = server.drain()
    tpe_waves = [w for w in waves if w[0]]
    missed = [w for w in tpe_waves
              if ("fused_sample_ei" in w[1] and w[2] < 1) or ("ei_diff" in w[1] and w[3] < 1)]
    timed = [w[4] for w in tpe_waves if not w[5]]  # the profiled ones pay the profiler
    n_prof = len(tpe_waves) - len(timed)
    busy_ms = prof_state["busy_us"] / 1e3 / n_prof if n_prof else None
    # the latencies leave out the asks that overlapped a profiled wave (its
    # session's start stalls every queued ask for seconds)
    kept = [a for a in res_c["asks"]
            if not any(a[0] < w1 and a[0] + a[1] / 1e3 > w0 for w0, w1 in prof_state["windows"])]
    ms = sorted(a[1] for a in kept)
    tms = sorted(a[1] for a in kept if a[2])

    def pct(xs, q):
        return xs[min(len(xs) - 1, math.ceil(q * len(xs)) - 1)] if xs else None

    n_waves = len(tpe_waves)
    res = {
        "studies": SVC_STUDIES, "clients": SVC_CLIENTS, "client_processes": SVC_CLIENT_PROCS,
        "trials": SVC_TRIALS, "tpe_asks_per_study": SVC_TRIALS - SVC_STARTUP, "wall_sec": wall,
        "asks": len(res_c["asks"]), "asks_overlapping_profiled_waves": len(res_c["asks"]) - len(kept),
        "ask_ms_p50": pct(ms, 0.5), "ask_ms_p99": pct(ms, 0.99),
        "tpe_ask_ms_p50": pct(tms, 0.5), "tpe_ask_ms_p99": pct(tms, 0.99),
        "ask_ms_p99_all": pct(sorted(a[1] for a in res_c["asks"]), 0.99),
        "asks_per_sec": len(res_c["asks"]) / wall, "tells_per_sec": n_tells / wall,
        "tpe_asks_per_sec": sum(1 for a in res_c["asks"] if a[2]) / wall,
        "waves": n_waves, "unprofiled_wave_sec_total": sum(timed),
        "wave_ms_p50": 1e3 * statistics.median(timed) if timed else None,
        "asks_per_wave": statistics.mean(w[0] for w in tpe_waves) if n_waves else 0,
        "asks_per_wave_max": max((w[0] for w in tpe_waves), default=0),
        "launches": launches,
        "fused_launches_per_wave": launches["fused_sample_ei"] / max(n_waves, 1),
        "ei_diff_launches_per_wave": launches["ei_diff"] / max(n_waves, 1),
        "launches_by_shape": {k: sorted(v.items()) for k, v in by_shape.items()},
        "waves_with_both_kernels": sum(1 for w in tpe_waves if w[2] and w[3]),
        "waves_missing_a_kernel": len(missed),
        "wal": wal, "wal_bytes_per_wave": wal["bytes"] / max(n_waves, 1),
        "fsyncs_per_wave": wal["fsyncs"] / max(n_waves, 1),
        # the device's busy ms per TPE wave, read in the profiled waves, and
        # the idle share of the drive extrapolated from it (not a reading:
        # 1 - busy per wave x TPE waves / wall; startup-only waves left out)
        "profiled_waves": n_prof, "device_busy_ms_per_wave": busy_ms,
        "device_idle_share_extrapolated": (1.0 - busy_ms * n_waves / (1e3 * wall)
                                           if busy_ms else None),
        "degrade": degrade, "drain_quiesced": quiesced,
        "drain_compactions": sched.journal.compactions - compactions,
        # the blackbox prober beside the tenants: cycles, verdicts, the
        # canary's client-view ask latency and the /healthz fields
        "probe": {"period_sec": SVC_PROBE_PERIOD, "request_timeout_sec": prober._timeout,
                  "cycles": probes["cycles"], "verdicts": probes["verdicts"],
                  "golden": probes["golden"], "golden_source": probes["golden_source"],
                  "ask_latency_ms": probes.get("ask_latency_ms"),
                  "healthz": healthz.get("probe"), "ledger_records": len(probe_recs),
                  "ledger_corrupt": probe_corrupt,
                  "digests": sorted({r.get("digest") for r in probe_recs})},
    }
    out["http"] = res
    log(f"phase 14 (a): {res}")
    bad = res_c["bad"]
    if bad:
        raise AssertionError(f"{len(bad)} answers out of their space or degraded, e.g. {bad[0]}")
    if missed:
        raise AssertionError(f"{len(missed)} TPE waves did not launch the kernel of a route "
                             f"they asked, e.g. {missed[0]}")
    if not (launches["fused_sample_ei"] and launches["ei_diff"]):
        raise AssertionError(f"a kernel never launched: {launches}")
    if wrong:
        raise AssertionError(f"{len(wrong)} studies not at {SVC_TRIALS} told, e.g. {wrong[0]}")
    if "hyperopt_tpu_service_asks_total" not in metrics:
        raise AssertionError("GET /metrics lacks the service.* family")
    if degrade["level"] != 0 or degrade["faults"] != 0:
        raise AssertionError(f"the ladder moved: {degrade}")
    if not quiesced or res["drain_compactions"] < 1:
        raise AssertionError(f"drain did not quiesce and compact: {quiesced}, "
                             f"{res['drain_compactions']}")
    pr = res["probe"]
    if pr["cycles"] < 2 or pr["verdicts"]["ok"] != pr["cycles"] or pr["ledger_corrupt"]:
        raise AssertionError(f"the prober's verdicts are not all ok: {pr}")
    if pr["digests"] != [pr["golden"]]:
        raise AssertionError(f"the card's canary streams differ: {pr}")
    if not (pr["healthz"] or {}).get("green"):
        raise AssertionError(f"/healthz does not show the prober green: {pr['healthz']}")
    return launches


def _svc_canary_routes(out, shapes, fused_shapes):
    """(f) The prober's canary in process on the card (``local_digest``),
    twice on the fused route and twice with ``HYPEROPT_TPU_MEGAKERNEL=off``
    (grouped ``ei_diff``): each route gives one digest.  Returns the fused
    route's, the route (a)'s server served.  The shapes join the after-phase
    checks."""
    from hyperopt_tpu_torch.obs import prober

    digests = {}
    with LaunchLog() as rec:
        for route, knob in (("fused_sample_ei", "on"), ("ei_diff", "off")):
            old = _md_set_env("HYPEROPT_TPU_MEGAKERNEL", knob)
            try:
                t0 = time.perf_counter()
                runs = [prober.local_digest(device=DEVICE) for _ in range(2)]
                sec = (time.perf_counter() - t0) / 2
            finally:
                _md_set_env("HYPEROPT_TPU_MEGAKERNEL", old)
            digests[route] = {"digests": [d for d, _ in runs], "flagged": [f for _, f in runs],
                              "sec_per_run": sec}
    by_shape = _svc_shape_counts(rec.shapes)
    shapes.update(by_shape["ei_diff"])
    fused_shapes.update(by_shape["fused_sample_ei"])
    res = out["canary_routes"] = {
        **digests, "launches_by_shape": {k: sorted(v.items()) for k, v in by_shape.items()},
        "routes_agree": digests["fused_sample_ei"]["digests"][0]
        == digests["ei_diff"]["digests"][0]}
    log(f"phase 14 canary routes: {res}")
    for route, d in digests.items():
        if len(set(d["digests"])) != 1 or any(d["flagged"]):
            raise AssertionError(f"the canary on the {route} route is not the same twice: {d}")
        if not by_shape[route]:
            raise AssertionError(f"the canary on the {route} route launched no {route}")
    return digests["fused_sample_ei"]["digests"][0]


def _svc_probe_mismatch(out, golden, shapes, fused_shapes):
    """(c) A short server in this process with ``HYPEROPT_TPU_PROFILE``
    armed and the prober on: a clean first cycle pins the card's golden
    (TOFU, equal to ``golden``, the in-process digest), then chaos corrupts
    every tick's read-back proposals (``HYPEROPT_TPU_CHAOS``) and the
    cycles driven from this thread must turn ``mismatch`` and escalate
    once; the escalation's capture is recorded by the leader of a later
    canary wave and must hold that wave's kernels.  Reports the detection
    latency and the wave that held the session's start and stop against
    the median wave."""
    import tempfile

    from hyperopt_tpu_torch import chaos
    from hyperopt_tpu_torch.service import StudyScheduler
    from hyperopt_tpu_torch.service.server import ServiceHTTPServer

    root = tempfile.mkdtemp(prefix="svc_probe_")
    old = _md_set_env("HYPEROPT_TPU_PROFILE", os.path.join(root, "caps"))
    try:
        sched = StudyScheduler(device=DEVICE, store_root=root, wave_window=SVC_WINDOW)
        server = ServiceHTTPServer(0, scheduler=sched)
    finally:
        _md_set_env("HYPEROPT_TPU_PROFILE", old)
    waves = []  # (start epoch, end epoch, ms): the whole wave, capture hooks included
    outer = sched._run_wave

    def timed_wave(reqs):
        t0, p0 = time.time(), time.perf_counter()
        try:
            return outer(reqs)
        finally:
            waves.append((t0, time.time(), 1e3 * (time.perf_counter() - p0)))

    sched._run_wave = timed_wave
    if not server.start():
        raise AssertionError("the probe server did not bind")
    cycles = []
    try:
        with LaunchLog() as rec:
            # the thread's first cycle pins the golden; the rest run here
            prober = server.arm_prober(period=3600.0)
            deadline = time.monotonic() + 120
            while prober.last is None and time.monotonic() < deadline:
                time.sleep(0.05)
            cycles.append(prober.last)
            old_chaos = _md_set_env("HYPEROPT_TPU_CHAOS", SVC_PROBE_CORRUPT)
            chaos.reset()
            try:
                for _ in range(SVC_PROBE_CYCLES):
                    cycles.append(prober.run_cycle())
                    if prober.last_capture is not None:
                        break
                deadline = time.monotonic() + 120
                while prober.last_capture is None and time.monotonic() < deadline:
                    time.sleep(0.05)
            finally:
                _md_set_env("HYPEROPT_TPU_CHAOS", old_chaos)
                chaos.reset()
            cycles.append(prober.run_cycle())  # clean again: the episode ends
            status = prober.status_dict()
    finally:
        server.drain()
    by_shape = _svc_shape_counts(rec.shapes)
    shapes.update(by_shape["ei_diff"])
    fused_shapes.update(by_shape["fused_sample_ei"])
    cap = prober.last_capture or {}
    held = [w for w in waves if cap.get("t0") and w[0] <= cap["t0"] <= w[1]]
    others = sorted(w[2] for w in waves if w not in held)
    verdicts = [c["verdict"] for c in cycles]
    first_bad = next((c for c in cycles if c["verdict"] != "ok"), {})
    res = out["probe_mismatch"] = {
        "verdicts": verdicts, "cycles_to_mismatch": verdicts.index("mismatch")
        if "mismatch" in verdicts else None,
        "detection_latency_sec": first_bad.get("detection_latency_sec"),
        "escalations": status["escalations"], "golden": status["golden"],
        "golden_source": status["golden_source"], "in_process_golden": golden,
        "capture": {k: cap.get(k) for k in ("ok", "error", "reason", "scope", "waves",
                                            "kernels", "sec", "wall_sec", "start_sec",
                                            "stop_sec", "stop_split", "write_sec")},
        "capture_wave_ms": held[0][2] if held else None,
        "median_wave_ms": statistics.median(others) if others else None,
        "waves": len(waves),
        "launches_by_shape": {k: sorted(v.items()) for k, v in by_shape.items()}}
    log(f"phase 14 (a') probe mismatch: {res}")
    if verdicts[0] != "ok" or status["golden"] != golden:
        raise AssertionError(f"the clean cycle did not pin the in-process golden: {res}")
    if "mismatch" not in verdicts[1:] or verdicts[-1] != "ok":
        raise AssertionError(f"the corrupted ticks did not turn the prober mismatch: {res}")
    if status["escalations"] != 1:
        raise AssertionError(f"{status['escalations']} escalations in one episode: {res}")
    if not cap.get("ok") or cap.get("scope") != "wave leader" or not cap.get("kernels"):
        raise AssertionError(f"the escalation's capture holds no wave kernel: {res}")


def _svc_free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _svc_spawn(root, port, chaos=None):
    """``python -m hyperopt_tpu_torch.service.server`` on ``root``; returns
    the process once it announced its URL."""
    env = {**os.environ, "HYPEROPT_TPU_WATCHDOG": "0"}
    env.pop("HYPEROPT_TPU_CHAOS", None)
    if chaos:
        env["HYPEROPT_TPU_CHAOS"] = chaos
    cmd = [sys.executable, "-m", "hyperopt_tpu_torch.service.server", "--port", str(port),
           "--announce", "--store", root]
    if DEVICE == "cpu":
        cmd += ["--device", "cpu"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, env=env)
    line = proc.stdout.readline()
    if not line.startswith("SERVICE_URL "):
        proc.kill()
        raise AssertionError(f"the server did not announce itself: {line!r}")
    return proc


def _svc_stop(proc):
    import signal

    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def _svc_streams_equal(got, want):
    """Per study: bit for bit, or at the card tolerance with the flipped
    proposals counted (a proposal whose values leave the tolerance)."""
    import numpy as np

    rtol, atol = MD_TOL
    bitwise, flips, worst = 0, [], 0.0
    for g, w in zip(got, want):
        if [t for t, _ in g] != [t for t, _ in w]:
            raise AssertionError(f"tids differ: {[t for t, _ in g]} vs {[t for t, _ in w]}")
        if g == w:
            bitwise += 1
            flips.append(0)
            continue
        n = 0
        for (_, pg), (_, pw) in zip(g, w):
            for k in pw:
                a, b = float(pg[k]), float(pw[k])
                worst = max(worst, abs(a - b))
                if not np.isclose(a, b, rtol=rtol, atol=atol):
                    n += 1
                    break
        flips.append(n)
    return bitwise, flips, worst


def _svc_crash(out):
    """(b) SIGKILL and resume of a real server process, then scrub over a
    corrupted WAL."""
    import json as _json
    import tempfile
    import threading
    import urllib.request

    from hyperopt_tpu_torch import zoo
    from hyperopt_tpu_torch.retry import RetryPolicy
    from hyperopt_tpu_torch.service import ServiceClient, StudyScheduler

    doms = ([zoo.ZOO["branin"]] * SVC_CRASH_STUDIES
            + [zoo.ZOO["hpob_surrogate"]] * SVC_CRASH_STUDIES)
    seeds = [300 + i for i in range(len(doms))]
    # the undisturbed run: the port's scheduler in this process
    ref = StudyScheduler(device=DEVICE)
    rsids = [ref.create_study(d.space, seed=s, n_startup_jobs=SVC_STARTUP,
                              max_trials=SVC_CRASH_BUDGET) for d, s in zip(doms, seeds)]
    want = {sid: [] for sid in rsids}
    with LaunchLog() as ref_shapes:
        for _ in range(SVC_CRASH_BUDGET):
            for sid, (a,) in ref.ask_many([(sid, 1) for sid in rsids]).items():
                want[sid].append((a["tid"], a["params"]))
                ref.tell(sid, a["tid"], doms[rsids.index(sid)].objective(a["params"]))
    root = tempfile.mkdtemp(prefix="svc_crash_")
    port = _svc_free_port()
    url = f"http://127.0.0.1:{port}"
    procs = [_svc_spawn(root, port, f"7:kill@tick:{SVC_CRASH_KILLS[0]}")]
    got = [[] for _ in doms]
    errors = []
    retry = RetryPolicy(max_retries=400, base_delay=0.05, max_delay=0.5)

    def client(i):
        try:
            c = ServiceClient(url, retry=retry, key=i, timeout=120)
            sid = c.create_study(zoo=doms[i].name, seed=seeds[i], n_startup_jobs=SVC_STARTUP,
                                 max_trials=SVC_CRASH_BUDGET)
            for _ in range(SVC_CRASH_BUDGET):
                (a,) = c.ask(sid)
                got[i].append((a["tid"], a["params"]))
                c.tell(sid, a["tid"], float(doms[i].objective(a["params"])))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"client {i}: {type(e).__name__}: {e}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(len(doms))]
    for th in threads:
        th.start()
    restarts, kills = [], 0
    while any(th.is_alive() for th in threads):
        if procs[-1].poll() is not None:
            kills += procs[-1].returncode == -9
            t1 = time.perf_counter()
            chaos = (f"8:kill@tick:{SVC_CRASH_KILLS[1]}" if len(procs) == 1 else None)
            procs.append(_svc_spawn(root, port, chaos))
            restarts.append(time.perf_counter() - t1)
        if time.perf_counter() - t0 > SVC_CHILD_SEC:
            break
        time.sleep(0.05)
    for th in threads:
        th.join(timeout=5)
    drive_sec = time.perf_counter() - t0
    status = ServiceClient(url).studies()
    resumes = [_json.loads(urllib.request.urlopen(url + "/snapshot", timeout=60).read())
               .get("wal", {}).get("last_resume")]
    _svc_stop(procs[-1])
    for p in procs:
        _svc_stop(p)
    if errors:
        raise AssertionError(f"{len(errors)} clients failed, e.g. {errors[0]}")
    wants = [want[sid] for sid in rsids]
    n_fused = SVC_CRASH_STUDIES
    fb, fflips, fworst = _svc_streams_equal(got[:n_fused], wants[:n_fused])
    eb, eflips, eworst = _svc_streams_equal(got[n_fused:], wants[n_fused:])
    counts_ok = all(s.get("n_told") == SVC_CRASH_BUDGET and s.get("state") == "done"
                    for s in status["studies"])
    from hyperopt_tpu_torch import megakernel

    plans = sorted({(P, n, m, megakernel._launch_plan("ei_diff", P, n, m)["splits"])
                    for name, P, n, m in ref_shapes.shapes
                    if name == "ei_diff"}) if DEVICE != "cpu" else []
    res = {"studies": len(doms), "budget": SVC_CRASH_BUDGET, "kills": kills,
           "restarts": len(restarts), "restart_sec": restarts, "drive_sec": drive_sec,
           "fused_bitwise": fb, "fused_flips": fflips, "fused_max_abs_diff": fworst,
           "ei_diff_bitwise": eb, "ei_diff_flips": eflips, "ei_diff_max_abs_diff": eworst,
           "undisturbed_ei_diff_plans": plans, "last_resume": resumes[0],
           "counts_ok": counts_ok}
    out["crash"] = res
    log(f"phase 14 (b): {res}")
    if kills < 2 or len(restarts) < 2:
        raise AssertionError(f"the server was killed {kills} times, restarted {len(restarts)}")
    if not counts_ok:
        raise AssertionError(f"studies not done at {SVC_CRASH_BUDGET} told: {status['studies'][:2]}")
    if fb != n_fused:
        raise AssertionError(f"fused-route studies left the undisturbed stream: {fflips}")
    if max(eflips) > 1:
        raise AssertionError(f"ei_diff-route studies flipped more than one proposal: {eflips}")

    # a fresh root, its WAL appends corrupted at random; scrub, then reboot
    root = tempfile.mkdtemp(prefix="svc_corrupt_")
    proc = _svc_spawn(root, port, f"9:corrupt@wal:{SVC_CORRUPT_P}")
    c = ServiceClient(url, retry=retry)
    for i in range(SVC_CORRUPT_STUDIES):
        dom = doms[i % len(doms)]
        sid = c.create_study(zoo=dom.name, seed=500 + i, n_startup_jobs=SVC_STARTUP)
        for _ in range(SVC_CORRUPT_TRIALS):
            (a,) = c.ask(sid)
            c.tell(sid, a["tid"], float(dom.objective(a["params"])))
    metrics = urllib.request.urlopen(url + "/metrics", timeout=60).read().decode()
    import re

    m = re.search(r'hyperopt_tpu_chaos_corrupt_wal_total\{namespace="service"\} ([0-9.e+]+)',
                  metrics)
    injected = int(float(m.group(1))) if m else 0
    os.kill(proc.pid, 9)  # leave the corrupt chain as it is (a drain would compact)
    proc.wait()
    scrub = subprocess.run([sys.executable, "-m", "hyperopt_tpu_torch.service.scrub", root,
                            "--json"], capture_output=True, text=True, timeout=300)
    rep = _json.loads(scrub.stdout)
    corrupt = sum(w["counts"]["corrupt"] for w in rep["wals"])
    scrub_sids = {s for w in rep["wals"] for s in w["corrupt_sids"]}
    proc = _svc_spawn(root, port)
    snap = _json.loads(urllib.request.urlopen(url + "/snapshot", timeout=60).read())
    quarantined = set(snap.get("quarantined") or {})
    _svc_stop(proc)
    res2 = {"injected": injected, "scrub_corrupt_records": corrupt, "scrub_rc": scrub.returncode,
            "scrub_studies": sorted(scrub_sids), "quarantined": sorted(quarantined)}
    out["corrupt"] = res2
    log(f"phase 14 (b) scrub: {res2}")
    if injected < 1:
        raise AssertionError("no WAL record was corrupted; raise the probability")
    if corrupt < injected or scrub.returncode != 2:
        raise AssertionError(f"scrub found {corrupt} corrupt records of {injected} injected")
    if quarantined != scrub_sids:
        raise AssertionError(f"the reboot quarantined {sorted(quarantined)}, scrub reported "
                             f"{sorted(scrub_sids)}")


def _svc_ladder(out, shapes, fused_shapes):
    """(c) the degrade ladder under injected tick faults and non-finite
    readbacks, then its climb back."""
    import random

    import numpy as np

    from hyperopt_tpu_torch import chaos, zoo
    from hyperopt_tpu_torch.service import DegradeLadder, StudyScheduler
    from hyperopt_tpu_torch.service.overload import LADDER_LEVELS

    sched = StudyScheduler(device=DEVICE, degrade=SVC_LADDER_PATIENCE)
    mix = zoo.make_study_mix(SVC_LADDER_STUDIES)
    sids = {sched.create_study(it.domain.space, seed=it.seed,
                               n_startup_jobs=it.n_startup_jobs): it for it in mix}
    events = []  # ("fault" | "clean", level after)
    ladder = sched.degrade
    rec_fault, rec_clean = ladder.record_fault, ladder.record_clean_wave

    def fault():
        events.append(("fault", rec_fault()))
        return ladder.level()

    def clean():
        events.append(("clean", rec_clean()))
        return ladder.level()

    ladder.record_fault, ladder.record_clean_wave = fault, clean
    rng = random.Random(13)
    corrupt_floats = chaos.corrupt_floats
    nonfinite = [0]

    def nan_readback(site, arr, metrics=None):
        if site == "tick" and rng.random() < SVC_LADDER_P:
            arr = np.array(arr, copy=True)
            arr.reshape(arr.shape[0], -1)[:, 0] = np.nan
            nonfinite[0] += 1
        return arr

    answers = degraded = 0
    chaos.configure(f"11:ioerr@tick:{SVC_LADDER_P}")
    chaos.corrupt_floats = nan_readback
    _svc_reset_counts()
    sl = LaunchLog(tag=ladder.level).__enter__()
    try:
        for _ in range(SVC_STARTUP + SVC_LADDER_WAVES):
            got = sched.ask_many([(sid, 1) for sid in sids])
            if set(got) != set(sids):
                raise AssertionError(f"{len(sids) - len(got)} asks got no answer")
            for sid, (a,) in got.items():
                answers += 1
                degraded += bool(a.get("degraded"))
                sched.tell(sid, a["tid"], sids[sid].domain.objective(a["params"]))
    finally:
        sl.__exit__()
        chaos.corrupt_floats = corrupt_floats
        chaos.configure(None)
        chaos.reset()
    launches = _svc_counts()
    level_shapes = {}
    for lv, *shape in sl.shapes:
        level_shapes.setdefault(lv, []).append(tuple(shape))
    level_shapes = {lv: _svc_shape_counts(s) for lv, s in level_shapes.items()}
    armed_levels = [lv for _, lv in events]
    climb = 0
    while ladder.level() and climb < 4 * SVC_LADDER_PATIENCE * len(LADDER_LEVELS):
        got = sched.ask_many([(sid, 1) for sid in sids])
        for sid, (a,) in got.items():
            sched.tell(sid, a["tid"], sids[sid].domain.objective(a["params"]))
        climb += 1
    predicted = DegradeLadder(SVC_LADDER_PATIENCE)
    want = [predicted.record_fault() if kind == "fault" else predicted.record_clean_wave()
            for kind, _ in events]
    got_levels = [lv for _, lv in events]
    res = {"waves": SVC_STARTUP + SVC_LADDER_WAVES, "answers": answers, "degraded": degraded,
           "faults": ladder.faults, "nonfinite_injected": nonfinite[0],
           "levels_walked": sorted(set(armed_levels)), "events": len(events),
           "climb_waves": climb, "final_level": ladder.level(), "launches": launches,
           "launches_by_level_and_shape": {
               LADDER_LEVELS[lv]["name"]: {k: sorted(v.items()) for k, v in s.items()}
               for lv, s in sorted(level_shapes.items())}}
    out["ladder"] = res
    log(f"phase 14 (c): {res}")
    for s in level_shapes.values():
        shapes.update(s["ei_diff"])
        fused_shapes.update(s["fused_sample_ei"])
    if got_levels != want:
        raise AssertionError(f"the ladder walked {got_levels}, a DegradeLadder predicts {want}")
    if not degraded or ladder.faults < 1:
        raise AssertionError(f"no fault was absorbed: {res}")
    if ladder.level() != 0:
        raise AssertionError(f"the ladder did not climb back: level {ladder.level()}")
    return launches


def _svc_replay(out, shapes):
    """(d) a WAL written on the CPU resumes on the card; a WAL written on
    the card resumes on the card (every ask regenerated), with each
    regenerated launch's plan beside the live one's.  Returns the
    launches of the card's live run, of the two resumes and of the asks
    after the resume, each counted on its own."""
    import shutil
    import tempfile

    import numpy as np

    from hyperopt_tpu_torch import zoo
    from hyperopt_tpu_torch.service import StudyScheduler
    from hyperopt_tpu_torch.service import scheduler as sched_mod

    mix = zoo.make_study_mix(SVC_REPLAY_STUDIES)
    root = tempfile.mkdtemp(prefix="svc_replay_")
    ticks = []  # (phase, sids in the tick, ei_diff plans of the tick)
    tick = sched_mod._Cohort.tick
    phase = ["live"]

    def logged_tick(self, demand, mesh=None, cand_scale=1.0):
        with LaunchLog() as sl:
            packed = tick(self, demand, mesh=mesh, cand_scale=cand_scale)
        ticks.append((phase[0], {self.slots[s].study_id for s in demand},
                      tuple((P, n, m) for name, P, n, m in sl.shapes if name == "ei_diff")))
        return packed

    def drive(sched, waves, record):
        sids = [sched.create_study(it.domain.space, seed=it.seed, study_id=f"r{i}",
                                   space_spec={"zoo": it.domain.name},
                                   n_startup_jobs=it.n_startup_jobs)
                for i, it in enumerate(mix)]
        for _ in range(waves):
            for sid, (a,) in sched.ask_many([(sid, 1) for sid in sids]).items():
                record.setdefault(sid, []).append((a["tid"], a["params"]))
                sched.tell(sid, a["tid"], mix[int(sid[1:])].domain.objective(a["params"]))
        return sids

    def stream(sched, sid):
        return [(d["tid"], {k: v[0] for k, v in d["misc"]["vals"].items() if v})
                for d in sched._studies[sid].trials.trials]

    sched_mod._Cohort.tick = logged_tick
    try:
        # the card's live run and its WAL-only resume on the card
        live = {}
        _svc_reset_counts()
        card = StudyScheduler(device=DEVICE, wal=os.path.join(root, "card.wal"))
        sids = drive(card, SVC_STARTUP + SVC_REPLAY_WAVES, live)
        card.drain()
        launches = {"service_replay_live": _svc_counts()}
        phase[0] = "replay"
        _svc_reset_counts()
        back = StudyScheduler(device=DEVICE, wal=os.path.join(root, "card.wal"))
        resumed = _svc_counts()
    finally:
        sched_mod._Cohort.tick = tick
    plans = {}
    from hyperopt_tpu_torch import megakernel

    for ph, ids, ei in ticks:
        splits = tuple(megakernel._launch_plan("ei_diff", *s)["splits"] if DEVICE != "cpu"
                       else 1 for s in ei)
        for sid in ids:
            plans.setdefault((ph, sid), []).append((tuple(ei), splits))
    same_plan = bitwise = tol = flips = 0
    worst = 0.0
    for sid in sids:
        a, b = stream(card, sid), stream(back, sid)
        lp = [p for p in plans.get(("live", sid), []) if p[0]]
        rp = [p for p in plans.get(("replay", sid), []) if p[0]]
        match = [x[1] for x in lp] == [x[1] for x in rp]
        same_plan += match
        if a == b:
            bitwise += 1
            continue
        if match:
            raise AssertionError(f"{sid}: the replay planned every launch as the live run "
                                 "and still left its bits")
        tol += 1
        for (ta, pa), (tb, pb) in zip(a, b):
            assert ta == tb
            d = max(abs(float(pa[k]) - float(pb[k])) for k in pa)
            worst = max(worst, d)
            flips += not all(np.isclose(float(pa[k]), float(pb[k]), rtol=MD_TOL[0],
                                        atol=MD_TOL[1]) for k in pa)
    for ph, _, ei in ticks:
        shapes.update(ei)
    card_res = {"studies": len(sids), "bitwise": bitwise, "same_plans": same_plan,
                "at_tolerance": tol, "flipped_proposals": flips, "max_abs_diff": worst,
                "regenerated": back.last_resume["regenerated"],
                "plans": {ph: sorted({p for (ph2, _), ps in plans.items() if ph2 == ph
                                      for p in ps})
                          for ph in ("live", "replay")}}
    # a WAL written on the CPU, resumed on the card
    cpu_rec = {}
    cpu = StudyScheduler(device="cpu", wal=os.path.join(root, "cpu.wal"))
    sids = drive(cpu, SVC_STARTUP + SVC_REPLAY_WAVES, cpu_rec)
    cpu.journal.sync()
    shutil.copy(os.path.join(root, "cpu.wal"), os.path.join(root, "cpu_copy.wal"))
    _svc_reset_counts()
    t0 = time.perf_counter()
    on_card = StudyScheduler(device=DEVICE, wal=os.path.join(root, "cpu_copy.wal"))
    resume_sec = time.perf_counter() - t0
    launches["service_resume"] = {k: v + resumed[k] for k, v in _svc_counts().items()}
    _svc_reset_counts()
    same_state = all(
        (cpu._studies[s].seed, cpu._studies[s].n_asked, cpu._studies[s].n_told,
         cpu._studies[s].state, cpu._studies[s].rstate.bit_generator.state)
        == (on_card._studies[s].seed, on_card._studies[s].n_asked, on_card._studies[s].n_told,
            on_card._studies[s].state, on_card._studies[s].rstate.bit_generator.state)
        for s in sids)
    flips_next = 0
    worst_next = 0.0
    for _ in range(SVC_REPLAY_NEXT):
        a_cpu = cpu.ask_many([(sid, 1) for sid in sids])
        a_card = on_card.ask_many([(sid, 1) for sid in sids])
        for sid in sids:
            (x,), (y,) = a_cpu[sid], a_card[sid]
            if x["tid"] != y["tid"]:
                raise AssertionError(f"{sid}: tid {x['tid']} on the CPU, {y['tid']} on the card")
            for k in x["params"]:
                worst_next = max(worst_next, abs(float(x["params"][k]) - float(y["params"][k])))
            flips_next += not all(np.isclose(float(x["params"][k]), float(y["params"][k]),
                                             rtol=MD_TOL[0], atol=MD_TOL[1]) for k in x["params"])
            loss = mix[int(sid[1:])].domain.objective(x["params"])
            cpu.tell(sid, x["tid"], loss)
            on_card.tell(sid, y["tid"], loss)
    launches["service_replay_next"] = _svc_counts()
    res = {"card_resume": card_res, "cpu_to_card": {
        "studies": len(sids), "same_ids_seeds_counts": same_state, "resume_sec": resume_sec,
        "regenerated": on_card.last_resume["regenerated"], "next_asks": SVC_REPLAY_NEXT,
        "flipped_proposals": flips_next, "max_abs_diff": worst_next}}
    out["replay"] = res
    log(f"phase 14 (d): {res}")
    if card_res["flipped_proposals"] > 1:
        raise AssertionError(f"the card's resume flipped {flips} proposals")
    if not same_state:
        raise AssertionError("the card's resume of the CPU's WAL left its ids, seeds or counts")
    if flips_next > 1:
        raise AssertionError(f"card against CPU: {flips_next} proposals flipped")
    if not all(all(c.values()) for c in launches.values()):
        raise AssertionError(f"a kernel did not launch on a path of (d): {launches}")
    return launches


def phase_service_plane(report):
    """Phase 14: the service plane on the card, paths (a)-(d)."""
    out = report["service_plane"] = {}
    shapes, fused_shapes = set(), set()
    launches = {}
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    launches["service_http"] = _svc_http(out, shapes, fused_shapes)
    out["a_sec"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    golden = _svc_canary_routes(out, shapes, fused_shapes)
    if golden != out["http"]["probe"]["golden"]:
        raise AssertionError(f"the card's TOFU golden over HTTP {out['http']['probe']['golden']} "
                             f"is not the in-process fused digest {golden}")
    _svc_probe_mismatch(out, golden, shapes, fused_shapes)
    out["probe_sec"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _svc_crash(out)
    out["b_sec"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches["service_ladder"] = _svc_ladder(out, shapes, fused_shapes)
    out["c_sec"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches.update(_svc_replay(out, shapes))
    out["d_sec"] = time.perf_counter() - t0
    out["phase_sec"] = time.perf_counter() - t_phase
    out["launches"] = launches
    log(f"phase 14: {out['phase_sec']:.1f} s, launches {launches}")
    return launches, sorted(shapes), sorted(fused_shapes)


# ---------------------------------------------------------------------------
# phase 15: the replicated serving fleet
# ---------------------------------------------------------------------------

# the mix on 8 shards, 3 replica processes (r0 and r1 from the start, r1
# SIGKILLed at its tell site near a third of the acknowledged tells, r2
# started at two thirds), each study to 10 trials (5 prior, 5 TPE asks:
# phase 14 (a)'s cut) by 128 client threads in 8 processes, each study's
# asks under one of 4 tenants.  Cut from the mix's 1024 studies to 128
# (PERF.md §4): a replica serves each shard through its own scheduler,
# so its waves hold ~4 asks where phase 14 (a)'s hold ~41, and the
# fleet acknowledged 11–16 tells/s on the card; 1024 studies would take
# ~700 s, and 256 took 160–235 s, too long beside phase 16
FLEET_STUDIES, FLEET_TRIALS, FLEET_SHARDS, FLEET_TENANTS = 128, 10, 8, 4
FLEET_CLIENTS, FLEET_CLIENT_PROCS = 128, 8
# the shard-lease TTL: each replica ticks both kernels before it joins,
# so the TTL covers no cold start; the steward and the heartbeat beat
# every TTL/4
FLEET_LEASE_TTL = 5.0
FLEET_SEC = 600  # the drive's limit


def _fleet_loss(idx, tid):
    """The loss told for trial ``tid`` of mix study ``idx``: a function of
    the ids only, so the undisturbed run folds the same history."""
    return float(((tid * 7919 + idx * 104729) % 1009) / 1009.0)


def _fleet_tenant(idx):
    return f"team-{idx % FLEET_TENANTS}"


def fleet_replica(argv):
    """A replica process of phase 15 (``chip_smoke.py --fleet-replica ROOT
    PORT ID OUT DEVICE``): it ticks both kernels on the card before it
    joins, then runs the port server's real ``main([... "--fleet" ...])``.
    It records its kernels' launches and shapes (``LaunchLog``), TPE
    waves, adoptions and first answers per adopted scheduler, writes them
    to ``OUT.partial`` every second (a SIGKILLed replica leaves its last
    one) and, after the SIGTERM drain, prints them as one
    ``FLEET_REPLICA {json}`` line."""
    import faulthandler
    import signal
    import threading

    from hyperopt_tpu_torch import zoo
    from hyperopt_tpu_torch.service import fleet, server

    # SIGUSR1 writes every thread's stack to the replica's log (the
    # parent sends it to a replica that overruns the drive)
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    from hyperopt_tpu_torch.service.scheduler import StudyScheduler

    global DEVICE
    root, port, rid, out, DEVICE = argv[:5]
    warm = StudyScheduler(device=DEVICE, wal=False)
    sids = [warm.create_study(zoo.ZOO[n].space, seed=1, n_startup_jobs=1)
            for n in ("quadratic1", "hpob_surrogate")]
    for _ in range(2):
        for sid, (a,) in warm.ask_many([(s, 1) for s in sids]).items():
            warm.tell(sid, a["tid"], 0.5)
    warmed = _svc_counts()
    _svc_reset_counts()
    stats = {"replica": rid, "warm_launches": warmed, "tpe_waves": 0, "adoptions": [],
             "first_answer": {}, "route_waves": {"fused_sample_ei": 0, "ei_diff": 0}}
    lock = threading.Lock()
    rec = LaunchLog()
    rec.__enter__()

    real_adopt = fleet.FleetReplica.adopt

    def adopt(self, shard):
        t0 = time.time()
        ok = real_adopt(self, shard)
        if ok:
            with lock:
                stats["adoptions"].append({"shard": int(shard), "t0": t0, "t1": time.time(),
                                           "sched": id(self.schedulers.get(shard)),
                                           "epoch": self.epochs.get(shard)})
        return ok

    fleet.FleetReplica.adopt = adopt
    replicas = []
    real_start = fleet.FleetReplica.start

    def start(self):
        replicas.append(self)
        return real_start(self)

    fleet.FleetReplica.start = start
    real_ask = StudyScheduler.ask

    def ask(self, *a, **kw):
        res = real_ask(self, *a, **kw)
        key = str(id(self))
        if key not in stats["first_answer"]:
            stats["first_answer"][key] = time.time()
        return res

    StudyScheduler.ask = ask
    real_inner = StudyScheduler._run_wave_inner

    def inner(self, reqs):
        with lock:
            stats["tpe_waves"] += 1
            for route in {_svc_route(r.study.domain.cs) for r in reqs}:
                stats["route_waves"][route] += 1
        return real_inner(self, reqs)

    StudyScheduler._run_wave_inner = inner
    done = threading.Event()

    def snapshot():
        with lock:
            by_shape = _svc_shape_counts(list(rec.shapes))
            snap = {**stats, "launches": _svc_counts(),
                    "shapes": sorted(by_shape["ei_diff"].items()),
                    "fused_shapes": sorted(by_shape["fused_sample_ei"].items())}
        if replicas:
            r = replicas[0]
            snap.update(handoffs=r.handoffs, leases_lost=r.leases_lost,
                        n_adoptions=r.adoptions, held=sorted(r.schedulers))
        return snap

    def report():
        while not done.wait(1.0):
            tmp = out + ".partial.tmp"
            with open(tmp, "w") as f:
                json.dump(snapshot(), f, default=str)
            os.replace(tmp, out + ".partial")

    threading.Thread(target=report, daemon=True).start()
    rc = server.main(["--port", port, "--announce", "--store", root, "--fleet",
                      "--fleet-shards", str(FLEET_SHARDS), "--replica-id", rid,
                      "--lease-ttl", str(FLEET_LEASE_TTL), "--device", DEVICE])
    done.set()
    rec.__exit__()
    print("FLEET_REPLICA " + json.dumps({**snapshot(), "rc": rc}, default=str), flush=True)
    return rc


def fleet_client(argv):
    """A client process of phase 15 (``chip_smoke.py --fleet-client URLS
    FIRST LAST THREADS STUDIES TRIALS OUT PROGRESS``): ``THREADS`` threads
    drive the mix studies ``FIRST..LAST-1``, each study under its tenant's
    ``ServiceClient`` (every replica's URL a seed), and write each ask
    (start, ms, TPE or not), each answer (study, tid, params), each
    acknowledged tell and the 307s followed to ``OUT``; the count of
    acknowledged tells goes to ``PROGRESS`` as it grows."""
    import threading

    from hyperopt_tpu_torch import zoo
    from hyperopt_tpu_torch.base import Domain
    from hyperopt_tpu_torch.retry import RetryPolicy
    from hyperopt_tpu_torch.service import ServiceClient

    urls, path, progress = argv[0].split(","), argv[6], argv[7]
    first, last, n_threads, n_studies, n_trials = (int(a) for a in argv[1:6])
    mix = zoo.make_study_mix(n_studies)
    cs_of = {it.domain.name: Domain(None, it.domain.space).cs for it in mix[first:last]}
    per = (last - first) // n_threads
    res = {"asks": [], "answers": [], "told": [], "sids": {}, "bad": [], "errors": [],
           "redirects": 0}
    lock = threading.Lock()
    retry = RetryPolicy(max_retries=2000, base_delay=0.05, max_delay=0.5)
    finished = threading.Event()

    def client(k):
        idxs = list(range(first + k * per, first + (k + 1) * per))
        # every other thread seeds with the second replica first, so the
        # studies are created (and placed) on both
        seeds = (urls[:2] if k % 2 == 0 else urls[1::-1]) + urls[2:]
        clients = {t: ServiceClient(seeds, retry=retry, key=first + k, timeout=600, tenant=t)
                   for t in {_fleet_tenant(i) for i in idxs}}
        try:
            mine = []
            for i in idxs:
                it = mix[i]
                c = clients[_fleet_tenant(i)]
                sid = c.create_study(zoo=it.domain.name, seed=it.seed,
                                     n_startup_jobs=SVC_STARTUP)
                mine.append((i, sid, c))
                with lock:
                    res["sids"][i] = sid
            for t in range(n_trials):
                for i, sid, c in mine:
                    start, t0 = time.time(), time.perf_counter()
                    (a,) = c.ask(sid)
                    ms = 1e3 * (time.perf_counter() - t0)
                    doc = {"misc": {"vals": {l: [v] for l, v in a["params"].items()}}}
                    if not in_space(cs_of[mix[i].domain.name], doc) or a.get("degraded"):
                        res["bad"].append((sid, a))
                    loss = _fleet_loss(i, a["tid"])
                    c.tell(sid, a["tid"], loss)
                    with lock:
                        res["asks"].append((start, ms, t >= SVC_STARTUP))
                        res["answers"].append((i, a["tid"], a["params"]))
                        res["told"].append((i, a["tid"], loss))
        except Exception as e:  # noqa: BLE001 - reported to the parent
            res["errors"].append(f"client {first + k}: {type(e).__name__}: {e}")
        finally:
            with lock:
                res["redirects"] += sum(c.redirects for c in clients.values())

    def report():
        while not finished.wait(0.25):
            with open(progress + ".tmp", "w") as f:
                f.write(str(len(res["told"])))
            os.replace(progress + ".tmp", progress)

    threading.Thread(target=report, daemon=True).start()
    threads = [threading.Thread(target=client, args=(k,)) for k in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    finished.set()
    with open(path, "w") as f:
        json.dump(res, f, default=str)
    return 0


def _fleet_spawn(root, port, rid, outdir, chaos=None):
    """A replica process; returns it once it announced its URL (joined and
    holding its first shards).  It serves without a request deadline: an
    ask shed at its deadline voids its draw, which moves its study's
    stream off the undisturbed run's (a shed, not a lost ask), and the
    drive's outages queue asks past the default 30 s."""
    env = {**os.environ, "HYPEROPT_TPU_WATCHDOG": "0", "HYPEROPT_TPU_SERVICE_DEADLINE_MS": "off"}
    env.pop("HYPEROPT_TPU_CHAOS", None)
    if chaos:
        env["HYPEROPT_TPU_CHAOS"] = chaos
    err = open(os.path.join(outdir, f"{rid}.err"), "w")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--fleet-replica", root,
                             str(port), rid, os.path.join(outdir, f"{rid}.json"), DEVICE],
                            stdout=subprocess.PIPE, stderr=err, text=True, env=env)
    line = proc.stdout.readline()
    if not line.startswith("SERVICE_URL "):
        proc.kill()
        raise AssertionError(f"replica {rid} did not announce itself: {line!r}")
    return proc


def _fleet_get(url, path, timeout=60):
    import urllib.request

    return json.loads(urllib.request.urlopen(url + path, timeout=timeout).read())


def _fleet_report(proc, rid, outdir):
    """The replica's FLEET_REPLICA record after it exited (its last partial
    one when it was killed)."""
    if proc.returncode == 0:
        for line in proc.stdout.read().splitlines():
            if line.startswith("FLEET_REPLICA "):
                return json.loads(line[len("FLEET_REPLICA "):])
    path = os.path.join(outdir, f"{rid}.json.partial")
    with open(path) as f:
        return json.load(f)


def _fleet_probe(urls, outdir):
    """(b) The standalone prober against the live replicas, before they
    stop (``python -m hyperopt_tpu_torch.obs.prober --targets ... --cycles
    2``): every verdict ok and one digest across replicas and cycles (the
    cross-replica divergence check; the card trusts its first stream)."""
    from hyperopt_tpu_torch.obs.prober import read_probes

    led = os.path.join(outdir, "probes.jsonl")
    if os.path.exists(led):
        os.remove(led)
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "HYPEROPT_TPU_WATCHDOG": "0",
           "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "hyperopt_tpu_torch.obs.prober", "--targets",
                          ",".join(urls), "--cycles", "2", "--ledger", led, "--replica",
                          "phase15"], env=env, cwd=root, capture_output=True, text=True,
                         timeout=300)
    recs, corrupt, _ = read_probes(led)
    res = {"rc": run.returncode, "sec": time.perf_counter() - t0, "targets": urls,
           "verdicts": [(r["cycle"], r["target"], r["verdict"]) for r in recs],
           "digests": sorted({r.get("digest") for r in recs}), "corrupt": corrupt,
           "golden_source": sorted({r.get("golden_source") for r in recs}),
           "ask_latency_ms": [r.get("latency_ms") for r in recs]}
    log(f"phase 15 (b) prober: {res}")
    if (run.returncode != 0 or len(recs) != 2 * len(urls) or len(res["digests"]) != 1
            or any(v != "ok" for *_, v in res["verdicts"])):
        raise AssertionError(f"the prober across the replicas: {res}; {run.stderr[-2000:]}")
    return res


def phase_fleet(report):
    """Phase 15: the replicated serving fleet on the card."""
    import tempfile
    import threading

    import torch

    from hyperopt_tpu_torch import megakernel, zoo
    from hyperopt_tpu_torch.base import JOB_STATE_DONE
    from hyperopt_tpu_torch.obs.load import read_heat
    from hyperopt_tpu_torch.service import StudyScheduler
    from hyperopt_tpu_torch.service.journal import StudyJournal

    out = report["fleet"] = {}
    t_phase = time.perf_counter()
    mix = zoo.make_study_mix(FLEET_STUDIES)
    # the undisturbed run: one scheduler in this process on the card
    ref = StudyScheduler(device=DEVICE, wal=False)
    rsids = [ref.create_study(it.domain.space, seed=it.seed, n_startup_jobs=SVC_STARTUP,
                              tenant=_fleet_tenant(i)) for i, it in enumerate(mix)]
    want = [[] for _ in mix]
    with LaunchLog() as ref_shapes:
        for _ in range(FLEET_TRIALS):
            answers = ref.ask_many([(sid, 1) for sid in rsids])
            for i, sid in enumerate(rsids):
                (a,) = answers[sid]
                want[i].append((a["tid"], a["params"]))
                ref.tell(sid, a["tid"], _fleet_loss(i, a["tid"]))
    del ref
    if DEVICE != "cpu":
        torch.cuda.empty_cache()  # the replicas need the card's memory
    root = tempfile.mkdtemp(prefix="fleet_")
    # the replicas' logs and reports come back with the run
    outdir = os.path.abspath(os.path.join("chiprun_out", "fleet"))
    os.makedirs(outdir, exist_ok=True)
    ports = [_svc_free_port() for _ in range(3)]
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    total = FLEET_STUDIES * FLEET_TRIALS
    # r1 holds about half the shards, so about half the tells reach it
    kill_at = total // 6
    t0 = time.perf_counter()
    procs = {"r0": _fleet_spawn(root, ports[0], "r0", outdir)}
    procs["r1"] = _fleet_spawn(root, ports[1], "r1", outdir, f"11:kill@tell:{kill_at}")
    t_spawned = time.perf_counter() - t0
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:  # the steward balances 4 + 4 before the drive
        held = [len(_fleet_get(u, "/healthz")["shards_held"]) for u in urls[:2]]
        if held == [FLEET_SHARDS // 2] * 2:
            break
        time.sleep(0.25)
    else:
        raise AssertionError(f"the two replicas did not balance: {held}")
    t_balanced = time.perf_counter() - t0
    per_proc = FLEET_STUDIES // FLEET_CLIENT_PROCS
    threads = FLEET_CLIENTS // FLEET_CLIENT_PROCS
    couts = [os.path.join(outdir, f"client{i}.json") for i in range(FLEET_CLIENT_PROCS)]
    progs = [os.path.join(outdir, f"client{i}.progress") for i in range(FLEET_CLIENT_PROCS)]
    env = {**os.environ, "HYPEROPT_TPU_WATCHDOG": "0"}
    env.pop("HYPEROPT_TPU_CHAOS", None)

    def acked():
        n = 0
        for p in progs:
            try:
                with open(p) as f:
                    n += int(f.read() or 0)
            except (OSError, ValueError):
                pass
        return n

    killed = []  # (wall time, acknowledged tells) when r1 died

    def watch_r1():
        procs["r1"].wait()
        killed.append((time.time(), acked()))

    threading.Thread(target=watch_r1, daemon=True).start()
    # the card's busy share over the drive: NVML's utilization.gpu (the
    # share of each sample period in which a kernel ran, from any process)
    # every 0.5 s.  A torch.profiler session started under traffic
    # stalled a replica ~25 s, and sees one process only
    util_samples, sampling = [], threading.Event()

    def sample_util():
        while not sampling.wait(0.5):
            try:
                q = subprocess.run(["nvidia-smi", "--query-gpu=utilization.gpu",
                                    "--format=csv,noheader,nounits", "-i", "0"],
                                   capture_output=True, text=True, timeout=10)
                util_samples.append(float(q.stdout.strip().splitlines()[0]))
            except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
                util_samples.append(None)

    if DEVICE != "cpu":
        threading.Thread(target=sample_util, daemon=True).start()
    t_drive = time.perf_counter()
    clients = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--fleet-client",
                                 ",".join(urls), str(i * per_proc), str((i + 1) * per_proc),
                                 str(threads), str(FLEET_STUDIES), str(FLEET_TRIALS), couts[i],
                                 progs[i]], env=env)
               for i in range(FLEET_CLIENT_PROCS)]
    marks = {}
    trace = out["progress"] = []  # (s, acknowledged tells, each live replica's shards)

    def note_progress():
        row = [round(time.perf_counter() - t_drive, 1), acked()]
        for k, rid in enumerate(("r0", "r1", "r2")):
            p = procs.get(rid)
            if p is None or p.poll() is not None:
                row.append(None)
                continue
            try:
                h = _fleet_get(urls[k], "/healthz", timeout=5)
                row.append([h["shards_held"], h["adoptions"], h["handoffs"], h["leases_lost"]])
            except Exception as e:  # noqa: BLE001 - a progress probe only
                row.append(type(e).__name__)
        trace.append(row)
        log(f"phase 15 progress: {row}")

    last_note = time.perf_counter()
    try:
        while any(p.poll() is None for p in clients):
            if time.perf_counter() - last_note > 10:
                note_progress()
                last_note = time.perf_counter()
            n = acked()
            if "r2" not in procs and n >= 2 * total // 3:
                marks["r2_start"] = n
                t2 = time.perf_counter()
                procs["r2"] = _fleet_spawn(root, ports[2], "r2", outdir)
                out["r2_spawn_sec"] = time.perf_counter() - t2
            if time.perf_counter() - t_drive > FLEET_SEC:
                import signal

                for p in procs.values():
                    if p.poll() is None:
                        p.send_signal(signal.SIGUSR1)  # stacks to chiprun_out/fleet/*.err
                time.sleep(2)
                raise AssertionError(f"the clients did not finish in {FLEET_SEC} s")
            time.sleep(0.05)
        wall = time.perf_counter() - t_drive
        sampling.set()
        if "r2" not in procs:
            procs["r2"] = _fleet_spawn(root, ports[2], "r2", outdir)
        # the steward hands r2 its shards (within a few sweeps)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if _fleet_get(urls[2], "/healthz")["shards_held"]:
                break
            time.sleep(0.25)
        health = {r: _fleet_get(urls[k], "/healthz") for k, r in ((0, "r0"), (2, "r2"))}
        loads = {r: _fleet_get(urls[k], "/fleet/load") for k, r in ((0, "r0"), (2, "r2"))}
        heat = read_heat(root)
        tenants = _fleet_get(urls[0], "/tenants")
        probe = _fleet_probe([urls[0], urls[2]], outdir)
    finally:
        sampling.set()
        for p in clients:
            if p.poll() is None:
                p.kill()
        for rid, p in procs.items():
            if rid != "r1":
                _svc_stop(p)
        if procs["r1"].poll() is None:
            procs["r1"].kill()
            procs["r1"].wait()
    reps = {rid: _fleet_report(p, rid, outdir) for rid, p in procs.items()}
    res_c = {"asks": [], "answers": [], "told": [], "sids": {}, "bad": [], "errors": [],
             "redirects": 0}
    for i, (p, path) in enumerate(zip(clients, couts)):
        if p.returncode != 0 or not os.path.exists(path):
            raise AssertionError(f"client process {i} exited {p.returncode}")
        with open(path) as f:
            for k, v in json.load(f).items():
                res_c[k] = {**res_c[k], **v} if isinstance(v, dict) else res_c[k] + v
    if res_c["errors"]:
        raise AssertionError(f"{len(res_c['errors'])} clients failed, e.g. {res_c['errors'][0]}")

    # a fresh card scheduler resumes every shard's WAL chain: every
    # acknowledged tell is there, DONE with its loss, and the docs are the
    # answers the clients got
    t_verify = time.perf_counter()
    fresh = StudyScheduler(device=DEVICE, store_root=root, wal=False, quality=False,
                           load=False, tenants=False)
    wal_dir = os.path.join(root, "fleet", "wal")
    chains = {}
    for shard in sorted(os.listdir(wal_dir)):
        chain = sorted(os.listdir(os.path.join(wal_dir, shard)))
        chains[shard] = chain
        for fname in chain:
            fresh.resume(StudyJournal(os.path.join(wal_dir, shard, fname)))
    sids = {int(i): sid for i, sid in res_c["sids"].items()}
    lost, wrong_doc = [], []
    for i, tid, loss in res_c["told"]:
        st = fresh._studies.get(sids[i])
        doc = None if st is None else next(
            (d for d in st.trials._dynamic_trials if d["tid"] == tid), None)
        if doc is None or doc["state"] != JOB_STATE_DONE or doc["result"].get("loss") != loss:
            lost.append((i, tid))
    got = [[] for _ in mix]
    for i, tid, params in sorted(res_c["answers"], key=lambda a: (a[0], a[1])):
        got[i].append((tid, params))
    for i, sid in sids.items():
        st = fresh._studies.get(sid)
        docs = {d["tid"]: d for d in st.trials._dynamic_trials} if st else {}
        for tid, params in got[i]:
            d = docs.get(tid)
            vals = None if d is None else {l: v[0] for l, v in d["misc"]["vals"].items() if v}
            if vals is None or any(float(vals[k]) != float(v) for k, v in params.items()):
                wrong_doc.append((i, tid))
    verify_sec = time.perf_counter() - t_verify

    routes = [_svc_route(fresh._studies[sids[i]].domain.cs) for i in range(len(mix))]
    fused = [i for i, r in enumerate(routes) if r == "fused_sample_ei"]
    eid = [i for i, r in enumerate(routes) if r == "ei_diff"]
    fb, fflips, fworst = _svc_streams_equal([got[i] for i in fused], [want[i] for i in fused])
    eb, eflips, eworst = _svc_streams_equal([got[i] for i in eid], [want[i] for i in eid])
    plans = sorted({(P, n, m, megakernel._launch_plan("ei_diff", P, n, m)["splits"])
                    for name, P, n, m in ref_shapes.shapes
                    if name == "ei_diff"}) if DEVICE != "cpu" else []
    replica_plans = sorted({(P, n, m, megakernel._launch_plan("ei_diff", P, n, m)["splits"])
                            for r in reps.values() for (P, n, m), _ in r["shapes"]}) \
        if DEVICE != "cpu" else []

    # the reclaims of r1's shards (the first adoption of each after the
    # SIGKILL: r0's, or r2's when it joined first) and the adopter's first
    # answer
    t_kill = killed[0][0] if killed else None
    reclaims, firsts = [], []
    for shard in reps["r1"].get("held") or []:
        after = sorted((a["t0"], rid, a) for rid in ("r0", "r2") if rid in reps
                       for a in reps[rid]["adoptions"]
                       if t_kill and a["t0"] >= t_kill and a["shard"] == shard)
        if after:
            _, rid, a = after[0]
            reclaims.append({**a, "replica": rid})
            first = reps[rid]["first_answer"].get(str(a["sched"]))
            if first is not None:
                firsts.append(first)
    ms = sorted(a[1] for a in res_c["asks"])
    tms = sorted(a[1] for a in res_c["asks"] if a[2])

    def pct(xs, q):
        return xs[min(len(xs) - 1, math.ceil(q * len(xs)) - 1)] if xs else None

    per_replica = {}
    for rid, r in reps.items():
        waves = r["tpe_waves"]
        per_replica[rid] = {
            "launches": r["launches"], "tpe_waves": waves, "route_waves": r["route_waves"],
            "launches_per_wave": {k: v / max(waves, 1) for k, v in r["launches"].items()},
            "adoptions": [(a["shard"], a["epoch"], round(a["t1"] - a["t0"], 4))
                          for a in r["adoptions"]],
            "handoffs": r.get("handoffs"), "leases_lost": r.get("leases_lost"),
            "held_at_end": r.get("held"), "warm_launches": r["warm_launches"]}
    util = [u for u in util_samples if u is not None]
    heat_shards = {k: v["heat_ms"] for k, v in heat["shards"].items()}
    res = {
        "studies": FLEET_STUDIES, "trials": FLEET_TRIALS, "shards": FLEET_SHARDS,
        "tenants": FLEET_TENANTS, "clients": FLEET_CLIENTS, "lease_ttl": FLEET_LEASE_TTL,
        "spawn_two_sec": t_spawned, "balanced_sec": t_balanced, "wall_sec": wall,
        "asks": len(res_c["asks"]), "tells": len(res_c["told"]),
        "ask_ms_p50": pct(ms, 0.5), "ask_ms_p99": pct(ms, 0.99),
        "tpe_ask_ms_p50": pct(tms, 0.5), "tpe_ask_ms_p99": pct(tms, 0.99),
        "tells_per_sec": len(res_c["told"]) / wall,
        "acked_at_kill": killed[0][1] if killed else None,
        "acked_at_r2_start": marks.get("r2_start"),
        "kill_site": f"tell hit {kill_at}", "r1_returncode": procs["r1"].returncode,
        "prober": probe,
        "kill_to_first_adopter_answer_sec": (min(firsts) - t_kill) if firsts else None,
        "reclaim_adoptions": [(a["replica"], a["shard"], a["epoch"]) for a in reclaims],
        "reclaim_adopt_sec": [round(a["t1"] - a["t0"], 4) for a in reclaims],
        "redirects_followed": res_c["redirects"],
        "handoffs": {r: h["handoffs"] for r, h in health.items()},
        "adoptions": {r: h["adoptions"] for r, h in health.items()},
        "replicas": per_replica,
        "utilization_samples": len(util),
        "device_idle_share": (1.0 - statistics.mean(util) / 100.0) if util else None,
        "lost_tells": len(lost), "wrong_docs": len(wrong_doc), "verify_sec": verify_sec,
        "wal_chains": {k: len(v) for k, v in chains.items()},
        "fused_studies": len(fused), "fused_bitwise": fb, "fused_max_abs_diff": fworst,
        "ei_diff_studies": len(eid), "ei_diff_bitwise": eb,
        "ei_diff_flips": {n: eflips.count(n) for n in sorted(set(eflips))},
        "ei_diff_max_abs_diff": eworst, "undisturbed_ei_diff_plans": plans,
        "replica_ei_diff_plans": replica_plans,
        "heat_ms_by_shard": heat_shards,
        "fleet_load_local_shards": {r: sorted((l.get("local") or {}).get("shards", {}))
                                    for r, l in loads.items()},
        "tenants_seen": sorted(tenants.get("table", {})),
    }
    out.update(res)
    out["phase_sec"] = time.perf_counter() - t_phase
    log(f"phase 15: {res}")
    if res_c["bad"]:
        raise AssertionError(f"{len(res_c['bad'])} answers out of their space or degraded, "
                             f"e.g. {res_c['bad'][0]}")
    if procs["r1"].returncode != -9 or not killed:
        raise AssertionError(f"r1 was not SIGKILLed at its tell site: {procs['r1'].returncode}")
    if lost or wrong_doc:
        raise AssertionError(f"{len(lost)} acknowledged tells lost (e.g. {lost[:3]}), "
                             f"{len(wrong_doc)} docs differ from the answers")
    if len(res_c["told"]) != total:
        raise AssertionError(f"{len(res_c['told'])} of {total} tells acknowledged")
    if fb != len(fused):
        raise AssertionError(f"fused-route studies left the undisturbed stream: "
                             f"{len(fused) - fb} of {len(fused)}")
    if max(eflips) > 1:
        raise AssertionError(f"ei_diff-route studies flipped more than one proposal: "
                             f"{res['ei_diff_flips']}")
    if len(reclaims) != len(reps["r1"].get("held") or [None]) or not firsts:
        raise AssertionError(f"r1's shards {reps['r1'].get('held')} were not all reclaimed "
                             f"after the kill: {res['reclaim_adoptions']}")
    if not sum(h["handoffs"] for h in health.values()) or not health["r2"]["adoptions"]:
        raise AssertionError(f"no handoff to r2: {res['handoffs']}, {res['adoptions']}")
    if res_c["redirects"] < 1:
        raise AssertionError("the clients followed no 307")
    from hyperopt_tpu_torch.service import shard_of

    # every shard holding a study served its TPE waves
    served = {str(shard_of(sid, FLEET_SHARDS)) for sid in sids.values()}
    cold = [k for k in sorted(served) if not heat_shards.get(k)]
    for r, l in loads.items():
        view = (l.get("fleet") or {}).get("shards", {})
        for k, v in view.items():
            if v["heat_ms"] > heat_shards.get(k, 0.0) + 1e-6:
                raise AssertionError(f"{r}'s /fleet/load heat for shard {k} exceeds the "
                                     f"ledger's: {v} vs {heat_shards.get(k)}")
        if set(view) != set(heat_shards):
            raise AssertionError(f"{r}'s /fleet/load shows heat for shards {sorted(view)}, "
                                 f"the ledger for {sorted(heat_shards)}")
    if cold or len(heat_shards) != FLEET_SHARDS:
        raise AssertionError(f"shards without heat: {cold}, ledger {heat_shards}")
    if res["tenants_seen"] != sorted(_fleet_tenant(i) for i in range(FLEET_TENANTS)):
        raise AssertionError(f"/tenants shows {res['tenants_seen']}")
    # a replica launches the kernel of every route its TPE waves asked (one
    # that joined late may hold only one route's studies), and the
    # surviving replicas launch both
    for rid in ("r0", "r2"):
        r = reps[rid]
        missed = [k for k, n in r["route_waves"].items() if n and not r["launches"][k]]
        if missed:
            raise AssertionError(f"{rid}'s TPE waves asked {missed} but it launched none: "
                                 f"{r['route_waves']}, {r['launches']}")
    if not all(reps["r0"]["launches"][k] + reps["r2"]["launches"][k]
               for k in ("fused_sample_ei", "ei_diff")):
        raise AssertionError(f"the surviving replicas did not launch both kernels: "
                             f"{reps['r0']['launches']}, {reps['r2']['launches']}")
    shapes = {tuple(s) for r in reps.values() for s, _ in r["shapes"]}
    fused_shapes = {tuple(s) for r in reps.values() for s, _ in r["fused_shapes"]}
    launches = {f"fleet_{rid}": r["launches"] for rid, r in reps.items()}
    return launches, sorted(shapes), sorted(fused_shapes)


# ---------------------------------------------------------------------------
# phase 16: run observability on the fmin path
# ---------------------------------------------------------------------------

OBS_CAPTURE_SEC = 1  # GET /profile?sec=1
OBS_PROFILED_ASKS = 5  # asks per launch count on a finished history (phase 5's way)
OBS_MH_EVALS, OBS_MH_BATCH = 256, 64  # the two-controller merge (phase 13's run, smaller)
# item 13's stall capture: a 1 s session started on another thread once
# (c)'s device loop, run again warm (no graph capture), has replayed 880 of
# its 980 TPE steps, so it holds the last ~100 steps and stops after the
# last replay (over a whole run its ~1.1 M kernel events took 20 s to stop
# and ~46 s to write on an H100)
OBS_STALL_SEC, OBS_STALL_AT = 1.0, 880
OBS_SECTIONS = ("== phase-time breakdown", "== trial-state waterfall", "== search health",
                "== kernel roofline", "== device memory", "== device captures")


def _obs_counted(tuned, asks):
    """``tuned`` counting its TPE asks (past the 20 startup draws): each
    appends ``(start, end)`` wall-clock epochs, ms and its ``ei_diff``
    launches to ``asks``."""
    from hyperopt_tpu_torch import megakernel

    def algo(new_ids, domain, trials, seed):
        tpe_ask = len(trials.trials) >= 20
        before = megakernel.ei_diff.launches
        t0, p0 = time.time(), time.perf_counter()
        docs = tuned(new_ids, domain, trials, seed)
        if tpe_ask:
            asks.append((t0, time.time(), 1e3 * (time.perf_counter() - p0),
                         megakernel.ei_diff.launches - before))
        return docs
    return algo


def _obs_launches_per_ask(tuned, trials, health=None, asks=OBS_PROFILED_ASKS):
    """CUDA kernel launches per TPE ask on a finished history, counted as
    phase 5 counts them (one id, a warm ask first, torch.profiler over
    ``asks`` more); ``health`` arms the asks (``trials.obs_health``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hyperopt_tpu_torch import zoo
    from hyperopt_tpu_torch.base import Domain

    dom = zoo.ZOO["branin"]
    domain = Domain(dom.objective, dom.space)
    ids = [len(trials.trials)]
    saved = getattr(trials, "obs_health", None)
    trials.obs_health = health
    try:
        tuned(ids, domain, trials, 0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for seed in range(asks):
                tuned(ids, domain, trials, seed + 1)
            torch.cuda.synchronize()
    finally:
        trials.obs_health = saved
    kernels = [a for a in prof.key_averages() if a.device_type == torch.autograd.DeviceType.CUDA]
    return sum(a.count for a in kernels) / asks


def _obs_trace_check(path):
    """``(ticks, ei_diff kernels, kernels inside an fmin.tick)`` of a
    capture's chrome trace."""
    import bisect
    import gzip

    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    ticks = sorted((e["ts"], e["ts"] + e.get("dur", 0.0)) for e in events
                   if e.get("ph") == "X" and str(e.get("name", "")).startswith("fmin.tick#"))
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "ei_diff_kernel" in str(e.get("name", ""))]
    starts = [a for a, _ in ticks]
    inside = 0
    for k in kernels:
        i = bisect.bisect_right(starts, k["ts"]) - 1
        if i >= 0 and k["ts"] + k.get("dur", 0.0) <= ticks[i][1]:
            inside += 1
    return len(ticks), len(kernels), inside


def _obs_get(url, path, timeout=120):
    import urllib.request

    with urllib.request.urlopen(url + path, timeout=timeout) as r:
        return r.read().decode()


def _obs_prometheus(text):
    """Every sample line of a Prometheus text exposition as (name, value);
    raises on a line that does not parse."""
    samples = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, value = line.rsplit(" ", 1)
        samples.append((name.split("{", 1)[0], float(value)))
    return samples


def _obs_tick_gap(asks, t):
    """The interval between TPE ask starts that holds epoch ``t``, ms."""
    starts = [a[0] for a in asks]
    for a, b in zip(starts, starts[1:]):
        if a <= t < b:
            return 1e3 * (b - a)
    return None


def _obs_armed_fmin(dom, tuned, tmp, out):
    """(a) The armed branin fmin in a thread; the main thread scrapes it,
    captures through ``/profile?sec=1`` and reads the stream."""
    import threading

    import numpy as np

    import hyperopt_tpu_torch as port

    asks = []
    trials = port.Trials()
    box = {}

    def run():
        try:
            port.fmin(dom.objective, dom.space, algo=_obs_counted(tuned, asks),
                      max_evals=MAIN_EVALS, trials=trials, rstate=np.random.default_rng(0),
                      show_progressbar=False, obs=os.path.join(tmp, "run.jsonl"), obs_http=0,
                      profile=os.path.join(tmp, "prof"))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["error"] = e

    os.environ["HYPEROPT_TPU_DEVMEM"] = "1"
    th = threading.Thread(target=run, name="armed-fmin")
    t0 = time.perf_counter()
    th.start()
    try:
        deadline = time.monotonic() + 300
        while len(asks) < 30 and th.is_alive() and time.monotonic() < deadline:
            time.sleep(0.05)
        url = trials.obs_http_url
        if not url or not th.is_alive():
            raise AssertionError(f"the armed run serves no scrape server: {url}, {box}")
        samples = _obs_prometheus(_obs_get(url, "/metrics"))
        snap = json.loads(_obs_get(url, "/snapshot"))
        cap = json.loads(_obs_get(url, f"/profile?sec={OBS_CAPTURE_SEC}"))
        asks_at_capture_end = len(asks)
    finally:
        th.join(timeout=600)
        os.environ.pop("HYPEROPT_TPU_DEVMEM", None)
    wall = time.perf_counter() - t0
    if "error" in box:
        raise box["error"]
    if th.is_alive():
        raise AssertionError("the armed fmin did not finish in 600 s")
    names = {n for n, _ in samples}
    dm = snap.get("devmem") or {}
    dev_bytes = [d.get("bytes_in_use") for d in dm.get("devices", [])]
    out["scrape"] = {"metric_samples": len(samples),
                     "has_suggest_calls": "hyperopt_tpu_suggest_calls_total" in names,
                     "roofline": snap.get("sections", {}).get("roofline"),
                     "devmem_devices": dm.get("devices"), "devmem_census": dm.get("census")}
    if not samples or "hyperopt_tpu_suggest_calls_total" not in names:
        raise AssertionError(f"/metrics lacks the run's counters: {sorted(names)[:20]}")
    if "suggest.tpe" not in (snap.get("sections", {}).get("roofline") or {}):
        raise AssertionError(f"/snapshot has no roofline row for suggest.tpe: {snap.get('sections')}")
    if not dev_bytes or any(b is None for b in dev_bytes):
        raise AssertionError(f"/snapshot has no device bytes: {dm}")
    if not cap.get("ok") or cap.get("thread") != "loop":
        raise AssertionError(f"/profile?sec={OBS_CAPTURE_SEC} failed: {cap}")
    n_ticks, n_kernels, inside = _obs_trace_check(cap["trace_json"])
    out["capture"] = {**{k: cap.get(k) for k in ("sec", "wall_sec", "start_sec", "stop_sec",
                                                 "stop_split", "write_sec", "thread", "scope",
                                                 "kernels", "trace_json")},
                      "trace_bytes": os.path.getsize(cap["trace_json"]),
                      "fmin_tick_annotations": n_ticks, "ei_diff_kernels": n_kernels,
                      "ei_diff_kernels_inside_fmin_tick": inside,
                      "tpe_asks_before_capture_returned": asks_at_capture_end}
    if not (n_ticks and n_kernels and inside):
        raise AssertionError(f"the capture shows no ei_diff kernel inside fmin.tick: "
                             f"{out['capture']}")
    intervals = sorted(1e3 * (b[0] - a[0]) for a, b in zip(asks, asks[1:]))
    out["tick_gap_ms"] = {"median_interval": intervals[len(intervals) // 2],
                          "at_capture_start": _obs_tick_gap(asks, cap["t0"]),
                          "at_capture_stop": _obs_tick_gap(asks, cap["t1"]),
                          "max_interval": intervals[-1]}
    out["armed_wall_sec"] = wall
    return trials, asks, cap


def _obs_check_stream(tmp, cap, out):
    """(d) The port's report renders the armed stream with every section,
    ``--export-trace`` merges the capture, and ``scripts/validate_trace.py``
    lints the merged trace clean."""
    from hyperopt_tpu_torch.obs import read_jsonl, report as obs_report

    path = os.path.join(tmp, "run.jsonl")
    recs = read_jsonl(path)
    text = obs_report.render(recs)
    missing = [s for s in OBS_SECTIONS if s not in text]
    merged = os.path.join(tmp, "merged.json")
    t0 = time.perf_counter()
    rc = obs_report.main(["--export-trace", merged, path])
    export_sec = time.perf_counter() - t0
    root = os.path.dirname(os.path.abspath(__file__))
    lint = subprocess.run([sys.executable, os.path.join(root, "scripts", "validate_trace.py"),
                           merged], capture_output=True, text=True, timeout=600)
    with open(merged) as f:
        events = json.load(f)["traceEvents"]
    device_pids = {e["pid"] for e in events if e.get("ph") != "M" and e["pid"] >= 1000}
    out["report"] = {"records": len(recs), "kinds": sorted({r.get("kind") for r in recs}),
                     "missing_sections": missing, "export_rc": rc, "export_sec": export_sec,
                     "merged_events": len(events), "device_track_groups": len(device_pids),
                     "lint_rc": lint.returncode, "lint": lint.stdout[-400:]}
    with open(os.path.join("chiprun_out", "obs_report.txt"), "w") as f:
        f.write(text)
    if missing or rc != 0 or lint.returncode != 0 or not device_pids:
        raise AssertionError(f"the armed stream's artifacts fail: {out['report']}")
    health = [r for r in recs if r.get("kind") == "health"]
    if len(health) != MAIN_EVALS - 20:
        raise AssertionError(f"{len(health)} health records for {MAIN_EVALS - 20} TPE asks")
    dm = [r for r in recs if r.get("kind") == "devmem"]
    out["devmem_peak_bytes"] = max((d.get("peak_bytes_in_use") or 0)
                                   for r in dm for d in r["devices"])
    out["devmem_history_bytes"] = max(r["census"].get("history", {}).get("bytes", 0)
                                      for r in dm)


def _obs_device_loop(dom, tuned, tmp, out):
    """(c) ``fmin(device_loop=True)`` armed and disarmed: bit for bit,
    ``chunk.execute_sec`` from CUDA events, the analytic cost gauges, the
    ``history`` owner in the census."""
    import numpy as np

    import hyperopt_tpu_torch as port
    from hyperopt_tpu_torch import megakernel
    from hyperopt_tpu_torch.obs import get_metrics, read_jsonl

    runs = {}
    dev = get_metrics("device")
    for mode in ("disarmed", "armed"):
        kw = {}
        if mode == "armed":
            kw = {"obs": os.path.join(tmp, "loop.jsonl")}
            os.environ["HYPEROPT_TPU_DEVMEM"] = "1"
        before = dev.snapshot()["metrics"].get("chunk.execute_sec", {"count": 0, "sum": 0.0})
        megakernel.ei_diff.launches = megakernel.ei_diff.graph_launches = 0
        megakernel.ei_diff.captures = 0
        trials = port.Trials()
        t0 = time.perf_counter()
        try:
            port.fmin(dom.traceable, dom.space, algo=tuned, max_evals=MAIN_EVALS, trials=trials,
                      rstate=np.random.default_rng(0), show_progressbar=False,
                      device_loop=True, **kw)
        finally:
            os.environ.pop("HYPEROPT_TPU_DEVMEM", None)
        wall = time.perf_counter() - t0
        after = dev.snapshot()["metrics"]
        ex = after.get("chunk.execute_sec", {"count": 0, "sum": 0.0})
        # a TPE step launches ei_diff once: eagerly in a branch's warm-up
        # (a run that captures it), else inside a graph replay
        runs[mode] = {"trials": trials, "wall_sec": wall,
                      "ei_diff_launches": (megakernel.ei_diff.launches
                                           + megakernel.ei_diff.graph_launches),
                      "graph_launches": megakernel.ei_diff.graph_launches,
                      "chunks": ex["count"] - before["count"],
                      "execute_sec": ex["sum"] - before["sum"],
                      "chunk_flops": after.get("chunk.flops"),
                      "chunk_bytes": after.get("chunk.bytes")}
    a, d = runs["armed"], runs["disarmed"]
    same = ([t["misc"]["vals"] for t in a["trials"].trials]
            == [t["misc"]["vals"] for t in d["trials"].trials]
            and a["trials"].losses() == d["trials"].losses())
    recs = read_jsonl(os.path.join(tmp, "loop.jsonl"))
    hist = max((r["census"].get("history", {}).get("bytes", 0) for r in recs
                if r.get("kind") == "devmem"), default=0)
    out["device_loop"] = {
        "bitwise": same, "history_bytes": hist,
        **{f"{m}_{k}": v for m, r in runs.items() for k, v in r.items() if k != "trials"},
        "armed_chunk_ms": 1e3 * a["execute_sec"] / max(a["chunks"], 1)}
    log(f"phase 16 (c): {out['device_loop']}")
    if not same:
        raise AssertionError("the armed device loop left the disarmed loop's stream")
    steps = MAIN_EVALS - LOOP_STARTUP
    if (a["ei_diff_launches"] != steps or d["ei_diff_launches"] != steps
            or a["chunks"] != MAIN_EVALS // 10):
        raise AssertionError(f"armed device loop: {out['device_loop']}")
    if not a["chunk_flops"] or not hist:
        raise AssertionError(f"no cost gauges or history bytes: {out['device_loop']}")
    return a["ei_diff_launches"]


def _obs_stop_split(out):
    """(d) Item 12: ``prof.stop()`` in parts.  The capture's own record
    splits the stop on the loop's thread into the device synchronize and
    torch's ``_disable_profiler`` call (CUPTI's flush, the trace's
    processing, the teardown); two small sessions over the same 20
    ``ei_diff`` launches, stopped with ``TEARDOWN_CUPTI=0`` and then ``=1``,
    separate the teardown (the difference of their disable calls)."""
    import torch

    from hyperopt_tpu_torch import megakernel
    from hyperopt_tpu_torch.obs import profiler

    x, tabs = ei_inputs(2, 1024, 1025, seed=11)
    runs = {}
    for flag in ("0", "1"):
        old = _md_set_env("TEARDOWN_CUPTI", flag)
        try:
            t0 = time.perf_counter()
            prof = profiler._start_session()
            start = time.perf_counter() - t0
            for _ in range(20):
                megakernel.ei_diff(x, *tabs)
            runs[flag] = {"start_sec": start, **profiler._stop_timed(prof)}
        finally:
            _md_set_env("TEARDOWN_CUPTI", old)
    on, off = runs["1"], runs["0"]
    tear = (on.get("disable_sec", 0.0) - off.get("disable_sec", 0.0)
            if "disable_sec" in on and "disable_sec" in off else None)
    cap = out["capture"].get("stop_split") or {}
    out["stop_split"] = {
        "teardown_off": off, "teardown_on": on, "teardown_sec": tear,
        "capture_stop": cap,
        "capture_flush_and_process_sec": (cap["disable_sec"] - tear
                                          if tear is not None and "disable_sec" in cap
                                          else None),
        "tick_gap_at_capture_stop_ms": out["tick_gap_ms"]["at_capture_stop"]}
    log(f"phase 16 (d) stop split: {out['stop_split']}")


def _obs_stall_capture(dom, tuned, tmp, out):
    """(d) Item 13: a stall capture taken on another thread while
    ``fmin(device_loop=True)`` replays its chunks (a warm run, its graphs
    captured by (c)): its record states the scope and the kernels it
    holds.  The session outlasts the run, so it stops with no replay in
    flight."""
    import threading

    import numpy as np

    import hyperopt_tpu_torch as port
    from hyperopt_tpu_torch import megakernel
    from hyperopt_tpu_torch.obs.profiler import DeviceProfiler

    box = {}

    def run():
        try:
            port.fmin(dom.traceable, dom.space, algo=tuned, max_evals=MAIN_EVALS,
                      trials=port.Trials(), rstate=np.random.default_rng(0),
                      show_progressbar=False, device_loop=True)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["error"] = e

    prof = DeviceProfiler(os.path.join(tmp, "stall"), stall_capture_sec=OBS_STALL_SEC)
    th = threading.Thread(target=run, name="stalled-loop")
    g0 = megakernel.ei_diff.graph_launches
    t0 = time.perf_counter()
    th.start()
    while megakernel.ei_diff.graph_launches - g0 < OBS_STALL_AT and th.is_alive():
        time.sleep(0.001)
    steps_at_start = megakernel.ei_diff.graph_launches - g0
    stall = {"kind": "stall"}
    rec = prof.capture_on_stall(stall)
    th.join(timeout=300)
    if "error" in box:
        raise box["error"]
    out["stall_capture"] = {**{k: rec.get(k) for k in ("ok", "error", "scope", "kernels",
                                                       "wall_sec", "stop_sec")},
                            "loop_and_capture_sec": time.perf_counter() - t0,
                            "tpe_steps_before_start": steps_at_start,
                            "postmortem": stall.get("capture")}
    log(f"phase 16 (d) stall capture: {out['stall_capture']}")
    if rec.get("scope") != "watchdog thread" or not isinstance(rec.get("kernels"), int):
        raise AssertionError(f"the stall capture does not state its kernels: {rec}")
    if (rec["kernels"] == 0) == bool(rec.get("ok")) or stall.get("capture", {}).get(
            "kernels") != rec["kernels"]:
        raise AssertionError(f"the stall capture's record and postmortem disagree: {rec}, "
                             f"{stall}")


def _obs_multihost(out):
    """(d) ``fmin_multihost(obs=run.jsonl)`` on two controller processes
    sharing the card over gloo: each writes ``run.p<i>.jsonl``, and the
    port's ``obs.report --merge`` renders them.  Returns the controllers'
    ``ei_diff`` shapes."""
    import tempfile

    from hyperopt_tpu_torch.obs import read_jsonl, report as obs_report

    _md_release()
    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, "c")
        root = os.path.dirname(os.path.abspath(__file__))
        env = {**os.environ,
               "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", ""),
               "HYPEROPT_TPU_WATCHDOG": "0",
               "HYPEROPT_TPU_ALLGATHER_TIMEOUT": str(MD_CONTROLLER_SEC // 2)}
        port_ = _md_free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--md-controller",
                                   "obs", str(r), str(port_), base, DEVICE, str(OBS_MH_EVALS),
                                   str(OBS_MH_BATCH)], env=env, cwd=root,
                                  stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
                 for r in range(2)]
        ctl = _md_wait(procs, base, "two armed controllers")
        wall = time.perf_counter() - t0
        streams = [(f"run.p{r}.jsonl", read_jsonl(f"{base}.p{r}.jsonl")) for r in range(2)]
        text = obs_report.render_merged(streams)
        rc = obs_report.main(["--merge", f"{base}.p0.jsonl", f"{base}.p1.jsonl"])
    shapes = set()
    for c in ctl:
        for row in c["propose"]:
            shapes.update(tuple(s[1:]) for s in row["shapes"] if s[0] == "ei_diff")
    out["multihost"] = {"wall_sec": wall, "checksums": [c["checksum"] for c in ctl],
                        "records": [len(r) for _, r in streams], "merge_rc": rc,
                        "shapes": sorted(shapes)}
    log(f"phase 16 (d) merge: {out['multihost']}")
    if rc != 0 or "run.p1.jsonl" not in text or ctl[0]["checksum"] != ctl[1]["checksum"]:
        raise AssertionError(f"the two armed controllers' merge fails: {out['multihost']}")
    return shapes


def phase_obs(report):
    """Phase 16: the run plane on the fmin path (armed vs disarmed host
    loop, the scrape server and a capture mid-run, the armed device loop,
    the report, the merged trace and the two-controller merge)."""
    import tempfile

    import numpy as np
    import torch

    import hyperopt_tpu_torch as port
    from hyperopt_tpu_torch import megakernel, zoo
    from hyperopt_tpu_torch.obs import ObsConfig, RunObs

    out = report["obs"] = {}
    t_phase = time.perf_counter()
    if DEVICE == "cuda":  # the devmem peak is this phase's
        torch.cuda.reset_peak_memory_stats()
    dom = zoo.ZOO["branin"]
    tuned = functools.partial(port.tpe.suggest, n_EI_candidates=MAIN_CANDIDATES)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp, LaunchLog() as shapes_log:
        # (b) the disarmed run, then (a) the armed one at the same seed
        megakernel.ei_diff.launches = 0
        plain_asks = []
        plain = port.Trials()
        port.fmin(dom.objective, dom.space, algo=_obs_counted(tuned, plain_asks),
                  max_evals=MAIN_EVALS, trials=plain, rstate=np.random.default_rng(0),
                  show_progressbar=False)
        launches["obs_fmin_disarmed"] = megakernel.ei_diff.launches
        megakernel.ei_diff.launches = 0
        armed, armed_asks, cap = _obs_armed_fmin(dom, tuned, tmp, out)
        launches["obs_fmin_armed"] = megakernel.ei_diff.launches
        same = ([t["misc"]["vals"] for t in armed.trials]
                == [t["misc"]["vals"] for t in plain.trials]
                and armed.losses() == plain.losses())
        side = RunObs(ObsConfig(level="trace", jsonl_path=os.path.join(tmp, "side.jsonl")))
        try:
            per_ask = {"disarmed": _obs_launches_per_ask(tuned, plain),
                       "armed": _obs_launches_per_ask(tuned, armed, health=side)}
        finally:
            side.finish()
        out["fmin"] = {
            "bitwise": same, "tpe_asks": {"disarmed": len(plain_asks), "armed": len(armed_asks)},
            "ei_diff_launches": {"disarmed": launches["obs_fmin_disarmed"],
                                 "armed": launches["obs_fmin_armed"]},
            "median_tpe_ask_ms": {"disarmed": statistics.median(a[2] for a in plain_asks),
                                  "armed": statistics.median(a[2] for a in armed_asks)},
            "kernel_launches_per_ask": per_ask,
            "phase5_kernel_launches_per_ask":
                report.get("profile_branin_ask", {}).get("kernel_launches_per_ask")}
        log(f"phase 16 (a)/(b): {out['fmin']}; capture {out['capture']}; "
            f"tick gap {out['tick_gap_ms']}")
        if not same:
            raise AssertionError("the armed fmin left the disarmed run's stream")
        for mode, asks in (("disarmed", plain_asks), ("armed", armed_asks)):
            if len(asks) != MAIN_EVALS - 20 or any(k != 1 for *_, k in asks):
                raise AssertionError(f"{mode}: ei_diff launches per TPE ask "
                                     f"{sorted({k for *_, k in asks})} over {len(asks)} asks")
            if launches[f"obs_fmin_{mode}"] != len(asks):
                raise AssertionError(f"{mode}: {launches[f'obs_fmin_{mode}']} ei_diff launches "
                                     f"for {len(asks)} TPE asks")
        want = out["fmin"]["phase5_kernel_launches_per_ask"]
        if want is not None and per_ask["disarmed"] != want:
            raise AssertionError(f"the disarmed ask launches {per_ask['disarmed']} kernels, "
                                 f"phase 5's {want}")
        _obs_check_stream(tmp, cap, out)
        launches["obs_device_loop_armed"] = _obs_device_loop(dom, tuned, tmp, out)
        _obs_stall_capture(dom, tuned, tmp, out)
        shapes = {tuple(s[1:]) for s in shapes_log.take() if s[0] == "ei_diff"}
    shapes |= _obs_multihost(out)
    _obs_stop_split(out)
    out["ei_diff_shapes"] = sorted(shapes)
    out["phase_sec"] = time.perf_counter() - t_phase
    log(f"phase 16: {out['phase_sec']:.1f} s; devmem peak {out.get('devmem_peak_bytes')} B")
    return launches, shapes


# phase 17: the capacity-sharded device loop on meshes that name the card
# 8 times as this process's devices.  Every entry lies on the card, so the
# runner keeps its state whole and replays the unsharded loop's graphs.
# (a) branin at BASELINE config 2's width (1000 evaluations, 1024
# candidates) with the split threshold at 8; (b) hartmann6 at the default
# threshold's capacity (65,536 rows), 24 startup and 200 TPE steps by
# runner chunks, then one profiled chunk
SL_ENTRIES = 8
SL_SHARD_MIN = 8
SL_H6 = dict(cap=65536, startup=24, tpe=200, candidates=1024)


class _ShardedLoop:
    """``HYPEROPT_TPU_SHARD=8`` with the split threshold at ``shard_min``
    (None: the default) and this process's devices named ``n`` times, as
    phase 13 (c) names the card twice; ``n=1`` unsets the knob."""

    def __init__(self, n, shard_min=SL_SHARD_MIN):
        self.n, self.shard_min = n, shard_min

    def __enter__(self):
        from hyperopt_tpu_torch.parallel import sharding

        self._real = real = sharding.local_devices
        self._old = {"HYPEROPT_TPU_SHARD": _md_set_env("HYPEROPT_TPU_SHARD",
                                                       "8" if self.n > 1 else None),
                     "HYPEROPT_TPU_HIST_SHARD_MIN": _md_set_env(
                         "HYPEROPT_TPU_HIST_SHARD_MIN",
                         None if self.shard_min is None else str(self.shard_min))}
        n = self.n
        sharding.local_devices = lambda device=None: real(device) * n
        return self

    def __exit__(self, *exc):
        from hyperopt_tpu_torch.parallel import sharding

        sharding.local_devices = self._real
        for k, v in self._old.items():
            _md_set_env(k, v)


def _sl_runner(dom, cfg, n_startup, cap, device):
    from hyperopt_tpu_torch import device_fmin
    from hyperopt_tpu_torch.base import Domain

    return device_fmin.DeviceLoopRunner(Domain(dom.traceable, dom.space), cfg, n_startup, cap,
                                        device=device)


def _sl_splits(cap):
    """True when ``cap`` splits over the suggest mesh the knob arms."""
    from hyperopt_tpu_torch._env import parse_shard
    from hyperopt_tpu_torch.parallel import sharding

    shard = parse_shard()
    return shard is not None and sharding.should_shard_history(
        cap, sharding.suggest_mesh(shard, device=DEVICE))


def _sl_rows(runner, steps, seed0=100):
    """Rows of ``steps`` steps in chunks of ``runner.CHUNK`` (seeds
    ``seed0 + start``)."""
    import numpy as np

    state, rows = runner.init_state(), []
    for start in range(0, steps, runner.CHUNK):
        state, r = runner.run_chunk(state, start, min(start + runner.CHUNK, steps),
                                    seed=seed0 + start)
        rows.append(r)
    return np.concatenate(rows)


def _sl_branin(out, launches):
    """(a): fmin(device_loop=True) over the card named 8 times against the
    unsharded run, its launches counted from its own run; the card
    against the CPU on 40 steps."""
    import numpy as np

    import hyperopt_tpu_torch as port
    from hyperopt_tpu_torch import zoo

    dom = zoo.ZOO["branin"]
    cfg = {"prior_weight": 1.0, "n_EI_candidates": MAIN_CANDIDATES, "gamma": 0.25, "LF": 25}
    tuned = functools.partial(port.tpe.suggest, n_EI_candidates=MAIN_CANDIDATES)
    cs = trials_cs(dom)
    L = len(cs.labels)
    tpe_steps = MAIN_EVALS - LOOP_STARTUP

    def fmin_stream():
        trials = port.Trials(device=DEVICE)
        _sync()
        t0 = time.perf_counter()
        port.fmin(dom.traceable, dom.space, algo=tuned, max_evals=MAIN_EVALS, trials=trials,
                  rstate=np.random.default_rng(0), show_progressbar=False, device_loop=True)
        _sync()
        wall = time.perf_counter() - t0
        if not all(in_space(cs, d) for d in trials.trials):
            raise AssertionError("phase 17 (a): a proposal outside the space")
        return [(d["misc"]["vals"], d["result"]) for d in trials.trials], wall

    with _ShardedLoop(1):
        want, out["unsharded_fmin_wall_sec"] = fmin_stream()
    with _ShardedLoop(SL_ENTRIES):
        if not _sl_splits(MAIN_EVALS):
            raise AssertionError(f"phase 17 (a): {MAIN_EVALS} rows do not split over "
                                 f"{SL_ENTRIES} entries")
        ei_counts_zero()
        got, wall = fmin_stream()
        counts = ei_counts()
        card = _sl_rows(_sl_runner(dom, cfg, LOOP_STARTUP, MAIN_EVALS, DEVICE),
                        LOOP_CHECK_TRIALS)
        cpu = _sl_rows(_sl_runner(dom, cfg, LOOP_STARTUP, MAIN_EVALS, "cpu"),
                       LOOP_CHECK_TRIALS)
    same = 0
    for a, b in zip(cpu, card):
        if not (np.allclose(a[:L], b[:L], rtol=1e-4, atol=1e-5)
                and np.array_equal(a[L:2 * L], b[L:2 * L])):
            break
        same += 1
    res = out[f"{SL_ENTRIES}_entries"] = {
        "fmin_bitwise": got == want, "fmin_wall_sec": wall, "ei_diff": counts,
        "cpu_agreement": {"trials": LOOP_CHECK_TRIALS, "matching_prefix": same}}
    launches[f"sharded_device_loop_{SL_ENTRIES}"] = counts["graph_launches"] + counts["launches"]
    log(f"phase 17 (a): {out}")
    if not res["fmin_bitwise"]:
        raise AssertionError("phase 17 (a): the sharded fmin(device_loop=True) left the "
                             "unsharded stream")
    if same != LOOP_CHECK_TRIALS:
        raise AssertionError(f"phase 17 (a): the card's loop left the CPU's at trial {same}")
    # the unsharded run captured the loop's graphs: every TPE step of the
    # sharded run is a replay of the graph that holds ei_diff
    if counts["graph_launches"] != tpe_steps or counts["launches"] or counts["captures"]:
        raise AssertionError(f"phase 17 (a): ei_diff did not launch from the TPE graph on "
                             f"every one of {tpe_steps} steps: {counts}")


def _sl_profiled_chunk(runner, state, start, seed):
    """One chunk of ``CHUNK`` TPE replays under torch.profiler: device ms
    and kernel launches per step, or None where the session recorded no
    kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    steps = runner.CHUNK
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        runner.run_chunk(state, start, start + steps, seed=seed)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        log("phase 17: the profiler recorded no kernel; launches per step not measured")
        return None
    ei = [e for e in kernels if "ei_diff_kernel" in e.name]
    return {"steps": steps,
            "device_ms_per_step": sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / steps,
            "kernel_launches_per_step": len(kernels) / steps,
            "ei_diff_kernels": len(ei),
            "ei_diff_device_ms_per_step": sum(e.time_range.elapsed_us() for e in ei) / 1e3 / steps}


def _sl_hartmann6(out, launches):
    """(b): hartmann6 at cap 65,536, the unsharded runner and then the one
    over the card named 8 times, each counted and timed in its own run:
    rows and states bit for bit, chunk wall per TPE step, peak memory,
    then one profiled chunk."""
    import numpy as np
    import torch

    from hyperopt_tpu_torch import zoo

    c = SL_H6
    dom = zoo.ZOO["hartmann6"]
    cfg = {"prior_weight": 1.0, "n_EI_candidates": c["candidates"], "gamma": 0.25, "LF": 25}
    steps = c["startup"] + c["tpe"]
    res, rows, states, runners = {}, {}, {}, {}
    for k, n in (("unsharded", 1), ("sharded", SL_ENTRIES)):
        with _ShardedLoop(n, shard_min=None):
            if (k == "sharded") != _sl_splits(c["cap"]):
                raise AssertionError(f"phase 17 (b): the {k} runner's split is not armed as "
                                     f"asked at cap {c['cap']}")
            r = runners[k] = _sl_runner(dom, cfg, c["startup"], c["cap"], DEVICE)
        state, got, ms, counts, peak = r.init_state(), [], [], {}, 0
        for start in range(0, steps, r.CHUNK):
            limit = min(start + r.CHUNK, steps)
            if DEVICE == "cuda":
                torch.cuda.reset_peak_memory_stats()
            _sync()
            ei_counts_zero()  # this runner's chunk alone
            t0 = time.perf_counter()
            state, chunk_rows = r.run_chunk(state, start, limit, seed=500 + start)
            wall = time.perf_counter() - t0
            for name, v in ei_counts().items():
                counts[name] = counts.get(name, 0) + v
            got.append(chunk_rows)
            if start >= c["startup"] + r.CHUNK:  # warm TPE chunks (no capture)
                ms.append(1e3 * wall / (limit - start))
            if DEVICE == "cuda":
                peak = max(peak, torch.cuda.max_memory_allocated())
        rows[k], states[k] = np.concatenate(got), state
        res[k] = {"ei_diff": counts, "peak_gib": peak / 2 ** 30,
                  "chunk_ms_per_tpe_step": {"median": statistics.median(ms), "min": min(ms),
                                            "steps": len(ms) * r.CHUNK}}
    loop = runners["sharded"]._loop
    shared = loop is runners["unsharded"]._loop
    res["capture_sec"] = dict(loop.capture_sec)
    res["ei_diff_nodes"] = dict(loop.kernel_nodes)
    res["rows_bitwise"] = bool(np.array_equal(rows["sharded"], rows["unsharded"],
                                              equal_nan=True))

    def leaves(state):
        vals, active, losses, has_loss = state
        return (*vals.values(), *active.values(), losses, has_loss)

    res["states_bitwise"] = all(torch.equal(a, b) for a, b in
                                zip(leaves(states["sharded"]), leaves(states["unsharded"])))
    res["profiled_chunk"] = (_sl_profiled_chunk(runners["sharded"], states["sharded"], steps,
                                                seed=900) if DEVICE == "cuda" else None)
    counts = res["sharded"]["ei_diff"]
    launches["sharded_device_loop_h6"] = counts["graph_launches"] + counts["launches"]
    out["hartmann6"] = res
    log(f"phase 17 (b): {res}")
    if not (shared and res["rows_bitwise"] and res["states_bitwise"]):
        raise AssertionError(f"phase 17 (b): the sharded runner left the unsharded loop "
                             f"(shared loop {shared}, rows {res['rows_bitwise']}, states "
                             f"{res['states_bitwise']})")
    # the unsharded runner: one eager warm-up, then replays; the sharded
    # one replays the unsharded runner's TPE graph on every step
    plain = res["unsharded"]["ei_diff"]
    if plain["graph_launches"] + plain["launches"] != c["tpe"] or plain["launches"] > 1:
        raise AssertionError(f"phase 17 (b): the unsharded runner's ei_diff {plain} for "
                             f"{c['tpe']} TPE steps")
    if counts["graph_launches"] != c["tpe"] or counts["launches"] or counts["captures"]:
        raise AssertionError(f"phase 17 (b): the sharded runner's ei_diff {counts} for "
                             f"{c['tpe']} TPE steps")
    pc = res["profiled_chunk"]
    if pc is not None and pc["ei_diff_kernels"] != runners["sharded"].CHUNK:
        raise AssertionError(f"phase 17 (b): the profiled chunk ran ei_diff "
                             f"{pc['ei_diff_kernels']} times in {runners['sharded'].CHUNK} steps")


def _sync():
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


def phase_sharded_loop(report):
    """Phase 17: the capacity-sharded device loop on meshes that name the
    card more than once."""
    out = report["sharded_loop"] = {}
    launches = {}
    t_phase = time.perf_counter()
    with LaunchLog() as shapes_log:
        _sl_branin(out, launches)
        _sl_hartmann6(out, launches)
        shapes = {tuple(s[1:]) for s in shapes_log.take() if s[0] == "ei_diff"}
    out["ei_diff_shapes"] = sorted(shapes)
    out["phase_sec"] = time.perf_counter() - t_phase
    log(f"phase 17: {out['phase_sec']:.1f} s; ei_diff shapes {out['ei_diff_shapes']}")
    return launches, shapes


GATE_PHASE_SEC = 90.0
#: the gates phase 18 runs, at their smallest sizes (the sizes of
#: tests/test_torch_gates.py's tier-1 cases, but two SLO studies: a gate's
#: study 1 is on the ei_diff route, the others on the fused one)
_STORE_SMALL = ["scripts/torch_store_chaos_smoke.py", "--n-studies", "4", "--budget", "5",
                "--extra", "2", "--corrupt-p", "0.05", "--enospc-clients", "2",
                "--enospc-budget", "3"]  # past the 2 startup asks: a TPE ask each
GATES = {"slo": ["scripts/torch_slo_smoke.py", "--n-studies", "2"],
         "store_corruption": [*_STORE_SMALL, "--phases", "1"],
         "store_enospc": [*_STORE_SMALL, "--phases", "2"]}


def phase_gates(report):
    """Phase 18: the SLO and STORE gates as subprocesses, side by side."""
    out = report["gates"] = {}
    t_phase = time.perf_counter()
    env = {**os.environ, "HYPEROPT_TPU_WATCHDOG": "0"}
    env.pop("HYPEROPT_TPU_CHAOS", None)
    root = os.path.dirname(os.path.abspath(__file__))
    procs = {name: subprocess.Popen([sys.executable, os.path.join(root, args[0]), *args[1:],
                                     "--device", DEVICE], env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
             for name, args in GATES.items()}
    launches = {}
    for name, proc in procs.items():
        try:
            text, _ = proc.communicate(timeout=GATE_PHASE_SEC * 3)
        except subprocess.TimeoutExpired:
            for p in procs.values():
                p.kill()
            raise AssertionError(f"phase 18: the {name} gate ran past {GATE_PHASE_SEC * 3} s")
        os.makedirs(os.path.join("chiprun_out", "gates"), exist_ok=True)
        with open(os.path.join("chiprun_out", "gates", f"phase18_{name}.log"), "w") as f:
            f.write(text)
        res = [json.loads(ln.split(None, 1)[1]) for ln in text.splitlines()
               if ln.startswith("GATE_RESULT ")]
        if proc.returncode != 0 or not res:
            raise AssertionError(f"phase 18: the {name} gate failed (rc {proc.returncode}):\n"
                                 f"{text[-3000:]}")
        out[name] = res[0]
        k = res[0]["kernels"]
        if DEVICE == "cuda" and not (k["ei_diff"] > 0 and k["fused_sample_ei"] > 0):
            raise AssertionError(f"phase 18: the {name} gate's reference launched {k}")
        launches[f"gate_{name}"] = {"ei_diff": k["ei_diff"],
                                    "fused_sample_ei": k["fused_sample_ei"]}
    out["phase_sec"] = time.perf_counter() - t_phase
    log(f"phase 18: {out['phase_sec']:.1f} s; gates "
        f"{ {k: round(v['wall_s'], 1) for k, v in out.items() if k in GATES} } s; "
        f"reference launches {launches}")
    if out["phase_sec"] > GATE_PHASE_SEC:
        raise AssertionError(f"phase 18 took {out['phase_sec']:.1f} s, past its "
                             f"{GATE_PHASE_SEC} s")
    return launches


def main():
    if sys.argv[1:2] == ["--md-controller"]:
        return md_controller(sys.argv[2:])
    if sys.argv[1:2] == ["--svc-client"]:
        return svc_client(sys.argv[2:])
    if sys.argv[1:2] == ["--fleet-replica"]:
        os.environ.setdefault("TEARDOWN_CUPTI", "1")
        return fleet_replica(sys.argv[2:])
    if sys.argv[1:2] == ["--fleet-client"]:
        return fleet_client(sys.argv[2:])
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
    svc_launches, svc_shapes, svc_fused_shapes = phase_service_plane(report)
    fleet_launches, fleet_shapes, fleet_fused_shapes = phase_fleet(report)
    obs_launches, obs_shapes = phase_obs(report)
    sl_launches, sl_shapes = phase_sharded_loop(report)
    gate_launches = phase_gates(report)
    # every shape the widened wave and phases 12-17 gave ei_diff is held
    # against the plain version on every candidate: phase 1 planned them,
    # and any it missed is checked here
    planned = {tuple(r["shape"]) for r in rows}
    extra = [check_ei(P, n, m, 0, plain_cmp(P, n, m), False, report["ptxas"])
             for P, n, m in sorted(set(widened_shapes) | set(ml_shapes) | set(md_shapes)
                                   | set(svc_shapes) | set(fleet_shapes) | set(obs_shapes)
                                   | set(sl_shapes))
             if (P, n, m) not in planned]
    report["ei_diff_shapes_unplanned"] = [r["shape"] for r in extra]
    rows += extra
    # and every shape phases 13-15 gave fused_sample_ei (the fused route's
    # spaces are uniform: bounded)
    fplanned = {tuple(r["shape"]) for r in frows}
    fextra = [check_fused(P, N, m, 0, True, report["ptxas"])
              for P, N, m in sorted(set(md_fused_shapes) | set(svc_fused_shapes)
                                    | set(fleet_fused_shapes))
              if (P, N, m) not in fplanned]
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
                                             "sharded_scheduler_fused")},
                             **{k: v["ei_diff"] for k, v in svc_launches.items()},
                             **{k: v["ei_diff"] for k, v in fleet_launches.items()},
                             **obs_launches, **sl_launches,
                             **{k: v["ei_diff"] for k, v in gate_launches.items()}},
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
                             "sharded_scheduler": md_launches["sharded_scheduler_fused"],
                             **{k: v["fused_sample_ei"] for k, v in svc_launches.items()},
                             **{k: v["fused_sample_ei"] for k, v in fleet_launches.items()},
                             **{k: v["fused_sample_ei"] for k, v in gate_launches.items()}},
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
