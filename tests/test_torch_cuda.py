"""Tests of the port that need an NVIDIA card (marker ``cuda``); elsewhere
they skip.  This file imports neither JAX nor the JAX package, so it also
runs on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import functools

import numpy as np
import pytest
import torch

import hyperopt_tpu_torch as port
from hyperopt_tpu_torch import device_fmin, hp, megakernel, zoo
from hyperopt_tpu_torch.algos import tpe
from hyperopt_tpu_torch.base import Domain
from hyperopt_tpu_torch.service import StudyScheduler
from test_torch_q_mass import q_inputs, quantized_loop_domain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The CUDA device; skips where there is none (decided when the test
    runs, never at collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run this file with `-m cuda` on the card")
    return torch.device("cuda")


def _inputs(P, n, m, device, dead=0, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(P, n, generator=g) * 6 - 3
    tabs = []
    for _ in range(2):
        w = torch.rand(P, m, generator=g) + 0.1
        w[:, m - dead:] = 0.0
        tabs += [w / w.sum(1, keepdim=True), torch.randn(P, m, generator=g),
                 torch.rand(P, m, generator=g) * 1.8 + 0.2]
    return [t.to(device).contiguous() for t in (x, *tabs)]


# (P, n, m, dead, split): whether the launch splits the component axis
# across a cluster (a grid short of blocks) or not (P x tiles fill the card)
@pytest.mark.parametrize("P,n,m,dead,split", [
    (1, 24, 129, 0, True), (4, 1000, 257, 7, True), (3, 777, 1025, 300, True),
    (2, 1024, 1025, 0, True), (1, 24, 1, 0, False), (1, 1000, 2049, 0, True),
    (5, 300, 2049, 2049, True), (64, 4096, 257, 0, False), (27, 65536, 129, 3, False)])
def test_kernel_matches_plain_and_counts_launches(cuda_device, P, n, m, dead, split):
    args = _inputs(P, n, m, cuda_device, dead=dead % m, seed=P + n)
    if dead == m:  # an all-dead above mixture
        args[4] = torch.zeros_like(args[4])
    plan = megakernel._launch_plan("ei_diff", P, n, m)
    assert (plan["splits"] > 1) == split and plan["splits"] <= min(8, m)
    before = megakernel.ei_diff.launches
    got = megakernel.ei_diff(*args)
    torch.cuda.synchronize()
    assert megakernel.ei_diff.launches == before + 1
    want = megakernel.ei_diff_plain(*args)
    assert torch.isfinite(got).all()
    assert bool(((got - want).abs() <= 1e-4 * want.abs().clamp(min=1.0)).all())


def test_kernel_rejects_strided_input(cuda_device):
    x, *tabs = _inputs(2, 64, 17, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        megakernel.ei_diff(x.t().contiguous().t(), *tabs)


# (row kinds, N, m, dead components, bounded, has_log, candidates held
# against the plain twin): LCBench's generation and its epsilon-prior
# draws, groups without log labels and all-log, the service's cohorts of
# 24 candidates over 17 components, and one component
LCBENCH_ROWS = ("logint", "int", "logint")
Q_CASES = [(LCBENCH_ROWS, 65536, 4097, 0, True, True, 4096),
           (LCBENCH_ROWS, 1024, 4097, 0, True, True, None),
           (("int", "q2"), 1024, 1001, 100, True, False, None),
           (("logq", "logq"), 1024, 1001, 0, False, True, None),
           (("q2", "q2"), 1000, 257, 7, False, False, None),
           (LCBENCH_ROWS * 256, 24, 17, 0, True, True, None),
           (("logint",), 24, 17, 3, True, True, None),
           (("logint", "int"), 300, 1, 0, True, True, None)]


@pytest.mark.parametrize("kinds,N,m,dead,bounded,has_log,n_cmp", Q_CASES)
def test_q_mass_kernel_matches_plain_and_counts_launches(cuda_device, kinds, N, m, dead,
                                                         bounded, has_log, n_cmp):
    args = q_inputs(kinds, N, m, bounded, seed=N + m, dead=dead, device=cuda_device)
    before = megakernel.q_mass_diff.launches
    got = megakernel.q_mass_diff(*args, bounded, has_log)
    again = megakernel.q_mass_diff(*args, bounded, has_log)
    torch.cuda.synchronize()
    assert megakernel.q_mass_diff.launches == before + 2
    assert torch.equal(got, again)  # a fixed order of every sum
    if n_cmp is not None:
        args[0], got = args[0][:, :n_cmp].contiguous(), got[:, :n_cmp]
    want = megakernel.q_mass_diff_plain(*args, bounded, has_log)
    assert torch.isfinite(got).all()
    assert bool(((got - want).abs() <= 1e-5 + 1e-4 * want.abs()).all()), \
        float((got - want).abs().max())


@pytest.mark.parametrize("P,N,m,lanes", [(3, 65536, 4097, 1), (3, 1024, 4097, 16),
                                         (768, 24, 17, 4), (1, 24, 17, 16), (3, 100, 1, 1)])
def test_q_mass_plan_fills_the_card_from_the_shape(cuda_device, P, N, m, lanes):
    plan = megakernel._launch_plan("q_mass_diff", P, N, m)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert plan["lanes"] == lanes and plan["per_block"] * lanes == plan["threads"]
    if P * N >= sms * plan["per_block"]:
        assert plan["blocks"] >= sms  # at least one wave of blocks


def test_q_mass_graph_replay_equals_eager_and_counts_captures(cuda_device):
    args = q_inputs(LCBENCH_ROWS, 1024, 4097, True, device=cuda_device)
    eager = megakernel.q_mass_diff(*args, True, True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        megakernel.q_mass_diff(*args, True, True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = (megakernel.q_mass_diff.launches, megakernel.q_mass_diff.captures)
    with torch.cuda.graph(graph):
        out = megakernel.q_mass_diff(*args, True, True)
    assert (megakernel.q_mass_diff.launches, megakernel.q_mass_diff.captures) == (
        before[0], before[1] + 1)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


def test_fmin_on_the_card_follows_the_cpu_path(cuda_device):
    dom = zoo.ZOO["quadratic1"]
    runs = []
    for device in ("cpu", cuda_device):
        t = port.Trials(device=device)
        port.fmin(dom.objective, dom.space, max_evals=30, trials=t,
                  rstate=np.random.default_rng(2), show_progressbar=False)
        runs.append([d["misc"]["vals"]["x"][0] for d in t.trials])
    np.testing.assert_allclose(runs[0], runs[1], rtol=1e-4, atol=1e-5)


def _fused_inputs(P, N, m, device, dead=0, bounded=True, seed=0):
    g = torch.Generator().manual_seed(seed)
    uc, u0 = torch.rand(P, N, generator=g), torch.rand(P, N, generator=g)
    tabs = {}
    for side in "ba":
        w = torch.rand(P, m, generator=g) + 0.1
        w[:, m - dead:] = 0.0
        tabs["w" + side] = w / w.sum(1, keepdim=True)
        tabs["m" + side] = torch.randn(P, m, generator=g)
        tabs["s" + side] = torch.rand(P, m, generator=g) * 1.8 + 0.2
    low, high = torch.full((P,), -2.0), torch.full((P,), 2.5)
    cdf, ab, bb = tpe._sample_tables(tabs["wb"], tabs["mb"], tabs["sb"], low, high, bounded)
    args = (uc, u0, cdf, tabs["mb"], tabs["sb"], ab, bb, tabs["wb"], tabs["wa"], tabs["ma"],
            tabs["sa"], low, high)
    return [t.to(device).contiguous() for t in args]


@pytest.mark.parametrize("P,N,m,dead,bounded", [(6, 24, 17, 0, True), (1536, 24, 65, 0, True),
                                                (24, 4096, 129, 0, False),
                                                (40, 100, 300, 77, True), (3, 1000, 1025, 5, False),
                                                (7, 1, 1, 0, True), (2, 300, 2049, 0, True)])
def test_fused_kernel_matches_plain_and_counts_launches(cuda_device, P, N, m, dead, bounded):
    args = _fused_inputs(P, N, m, cuda_device, dead=dead, bounded=bounded, seed=P + N + m)
    before = megakernel.fused_sample_ei.launches
    x, ei = megakernel.fused_sample_ei(*args, bounded)
    torch.cuda.synchronize()
    assert megakernel.fused_sample_ei.launches == before + 1
    px, pei = megakernel.fused_sample_ei_plain(*args, bounded)
    assert torch.isfinite(x).all() and torch.isfinite(ei).all()
    # the binary-search pick and the carried ndtri leave x on the plain bits
    assert float((x - px).abs().max()) == 0.0
    assert bool(((ei - pei).abs() <= 1e-4 * pei.abs().clamp(min=1.0)).all())
    if bounded:
        assert bool((x >= -2.0).all()) and bool((x < 2.5).all())


def test_fused_kernel_rejects_wrong_dtype_and_strided_input(cuda_device):
    uc, u0, *rest = _fused_inputs(4, 64, 17, cuda_device)
    with pytest.raises(TypeError, match="float32"):
        megakernel.fused_sample_ei(uc.double(), u0.double(), *rest, True)
    with pytest.raises(ValueError, match="contiguous"):
        megakernel.fused_sample_ei(uc.t().contiguous().t(), u0, *rest, True)
    with pytest.raises(ValueError, match="contiguous"):
        megakernel.ei_diff(uc.t().contiguous().t(), *rest[:6])
    with pytest.raises(TypeError, match="float32"):
        megakernel.ei_diff(uc.half(), *rest[:6])


def test_scheduler_on_the_card_follows_the_cpu_path(cuda_device):
    dom = zoo.ZOO["hartmann6"]
    streams = []
    for device in ("cpu", cuda_device):
        sched = StudyScheduler(device=device)
        sids = [sched.create_study(dom.space, seed=s, n_startup_jobs=5) for s in (3, 4)]
        for _ in range(15):
            for sid, (a,) in sched.ask_many([(sid, 1) for sid in sids]).items():
                sched.tell(sid, a["tid"], dom.objective(a["params"]))
        streams.append([[d["misc"]["vals"]["x0"][0] for d in sched._studies[sid].trials]
                        for sid in sids])
    np.testing.assert_allclose(streams[0], streams[1], rtol=1e-4, atol=1e-5)


def _loop_rows(device, capture, n=40, chunk=10):
    dom = zoo.ZOO["branin"]
    cfg = {"prior_weight": 1.0, "n_EI_candidates": 64, "gamma": 0.25, "LF": 25}
    runner = device_fmin.DeviceLoopRunner(Domain(dom.traceable, dom.space), cfg, 20, n,
                                          device=device, capture=capture)
    state = runner.init_state()
    rows = []
    for start in range(0, n, chunk):
        state, r = runner.run_chunk(state, start, start + chunk, seed=100 + start)
        rows.append(r)
    return np.concatenate(rows), state


def test_device_loop_graph_replay_equals_eager_and_follows_cpu(cuda_device):
    cpu, _ = _loop_rows("cpu", True)
    eager, eager_state = _loop_rows(cuda_device, False)
    before = (megakernel.ei_diff.captures, megakernel.ei_diff.graph_launches)
    graph, graph_state = _loop_rows(cuda_device, True)
    # a replay runs the kernels the eager step runs: the same bits
    np.testing.assert_array_equal(graph, eager)
    for a, b in zip(graph_state[:2], eager_state[:2]):
        for l in a:
            assert torch.equal(a[l], b[l])
    assert torch.equal(graph_state[2], eager_state[2])
    # and the card follows the CPU's stream
    np.testing.assert_allclose(graph, cpu, rtol=1e-4, atol=1e-5)
    stats, = [s for s in device_fmin.loop_stats()
              if s["kind"] == "chunk" and s["cap"] == 40 and s["device"].startswith("cuda")]
    assert stats["ei_diff_nodes"] == {"prior": 0, "tpe": 1}
    # the first TPE step is the eager warm-up, the other 19 are replays
    assert megakernel.ei_diff.captures - before[0] == 1
    assert megakernel.ei_diff.graph_launches - before[1] == stats["replays"]["tpe"] == 19


def test_device_loop_over_a_quantized_group_replays_q_mass_and_follows_cpu(cuda_device):
    cfg = {"prior_weight": 1.0, "n_EI_candidates": 24, "gamma": 0.25, "LF": 25}
    domain = quantized_loop_domain()  # one objective: the eager and graph runs share a loop

    def rows(device, capture):
        runner = device_fmin.DeviceLoopRunner(domain, cfg, 10, 30, device=device,
                                              capture=capture)
        return runner.run_chunk(runner.init_state(), 0, 30, seed=3)[1]

    cpu, eager = rows("cpu", True), rows(cuda_device, False)
    before = (megakernel.q_mass_diff.captures, megakernel.q_mass_diff.graph_launches)
    graph = rows(cuda_device, True)
    np.testing.assert_array_equal(graph, eager)
    np.testing.assert_allclose(graph, cpu, rtol=1e-4, atol=1e-5)
    stats, = [s for s in device_fmin.loop_stats()
              if s["kind"] == "chunk" and s["cap"] == 30 and s["device"].startswith("cuda")]
    assert stats["q_mass_diff_nodes"] == {"prior": 0, "tpe": 1}
    assert megakernel.q_mass_diff.captures - before[0] == 1
    assert megakernel.q_mass_diff.graph_launches - before[1] == stats["replays"]["tpe"] == 19


@pytest.mark.parametrize("entries", [2, 8])
def test_sharded_device_loop_on_repeated_card_entries_equals_unsharded(cuda_device, monkeypatch,
                                                                       entries):
    from hyperopt_tpu_torch.parallel import sharding

    plain, plain_state = _loop_rows(cuda_device, True)
    real = sharding.local_devices
    monkeypatch.setattr(sharding, "local_devices", lambda device=None: real(device) * entries)
    monkeypatch.setenv("HYPEROPT_TPU_SHARD", "8")
    monkeypatch.setenv("HYPEROPT_TPU_HIST_SHARD_MIN", "8")
    before = (megakernel.ei_diff.captures, megakernel.ei_diff.graph_launches)
    graph, graph_state = _loop_rows(cuda_device, True)
    # every entry is the card: the runner replays the unsharded loop's
    # graphs, capturing nothing, and gives its bits
    np.testing.assert_array_equal(graph, plain)
    for a, b in zip(_whole(graph_state), _whole(plain_state)):
        assert torch.equal(a, b)
    assert megakernel.ei_diff.captures == before[0]
    assert megakernel.ei_diff.graph_launches - before[1] == 20  # every TPE step a replay


def _whole(state):
    vals, active, losses, has_loss = state
    return [*vals.values(), *active.values(), losses, has_loss]


def test_device_loop_capture_refuses_a_copy_from_the_host(cuda_device):
    def obj(d):
        # a tensor made from host data on every call: the warm-up runs it,
        # the capture cannot record it
        return (d["x"] - torch.tensor([1.0, 0.0], device=d["x"].device)[0]) ** 2

    with pytest.raises(RuntimeError):
        port.fmin_device(obj, {"x": hp.uniform("x", -5, 5)}, 8, n_startup_jobs=4,
                         device=cuda_device)
    # nothing fell back, and the card still works
    assert float((torch.ones(2, device=cuda_device) * 2).sum()) == 4.0
    best, loss = port.fmin_device(zoo.ZOO["quadratic1"].traceable, zoo.ZOO["quadratic1"].space,
                                  30, device=cuda_device)
    assert np.isfinite(loss)


CYCLE = ("chunk.span_sec", "chunk.gap_sec", "chunk.gap.readback_sec", "chunk.gap.host_sec",
         "chunk.gap.dispatch_sec")


def test_device_loop_chunk_cycle_on_the_card(cuda_device, monkeypatch):
    from hyperopt_tpu_torch.obs.metrics import MetricsRegistry

    reg = MetricsRegistry("device")
    monkeypatch.setattr(device_fmin, "_METRICS", reg)
    dom = zoo.ZOO["branin"]
    algo = functools.partial(port.tpe.suggest, n_EI_candidates=48)
    counts = []
    for seed in (5, 6):  # 6 chunks each; the first search may capture
        port.fmin(dom.traceable, dom.space, max_evals=60, trials=port.Trials(device=cuda_device),
                  rstate=np.random.default_rng(seed), show_progressbar=False, device_loop=True,
                  algo=algo)
        counts.append({name: reg.histogram(name).count for name in CYCLE})
    # a capturing search captures the prior graph in chunk 0 (no gap there
    # anyway) and the TPE graph in chunk 2, which records no cycle
    captured = reg.histogram("chunk.compile_sec").count == 2
    assert counts[0] == dict.fromkeys(CYCLE, 5 - captured)
    assert counts[1] == dict.fromkeys(CYCLE, 10 - captured)
    rings = {name: list(reg.histogram(name)._ring) for name in CYCLE}
    for i, gap in enumerate(rings["chunk.gap_sec"]):
        parts = [rings[f"chunk.gap.{p}_sec"][i] for p in ("readback", "host", "dispatch")]
        assert min(parts) > 0 and abs(sum(parts) - gap) < 1e-6
    # ten graph replays a chunk: each over a millisecond of device work
    assert min(rings["chunk.span_sec"]) > 10 * 1e-4


def _fmin_vals(device, name, algo, n, seed):
    dom = zoo.ZOO[name]
    t = port.Trials(device=device)
    port.fmin(dom.objective, dom.space, algo=algo, max_evals=n, trials=t,
              rstate=np.random.default_rng(seed), show_progressbar=False)
    return [d["misc"]["vals"] for d in t.trials]


@pytest.mark.parametrize("name", ["many_dists", "branin"])
def test_anneal_on_the_card_follows_the_cpu_path(cuda_device, name):
    cpu = _fmin_vals("cpu", name, port.anneal.suggest, 40, 5)
    card = _fmin_vals(cuda_device, name, port.anneal.suggest, 40, 5)
    for a, b in zip(cpu, card):
        assert a.keys() == b.keys()
        for k in a:
            assert len(a[k]) == len(b[k])
            np.testing.assert_allclose(b[k], a[k], rtol=1e-4, atol=1e-5, err_msg=k)


def test_atpe_and_mix_asks_launch_ei_diff(cuda_device):
    """Every TPE ask of aTPE and of mix's TPE branch launches the kernel."""
    import functools

    counted = []

    def counting(algo):
        def ask(new_ids, domain, trials, seed, **kw):
            before = megakernel.ei_diff.launches
            docs = algo(new_ids, domain, trials, seed, **kw)
            counted.append(megakernel.ei_diff.launches - before)
            return docs
        return ask

    dom = zoo.ZOO["branin"]
    mix = functools.partial(port.mix.suggest, p_suggest=[(1.0, counting(port.tpe.suggest))])
    for algo in (counting(port.atpe.suggest), mix):
        port.fmin(dom.objective, dom.space, algo=algo, max_evals=30,
                  trials=port.Trials(device=cuda_device), rstate=np.random.default_rng(0),
                  show_progressbar=False)
    # aTPE: 10 prior draws (its startup floor at this budget), 20 TPE asks;
    # mix's TPE branch: 20 prior draws, 10 TPE asks
    assert counted == [0] * 10 + [1] * 20 + [0] * 20 + [1] * 10


def test_widened_cohort_equals_the_grouped_cohort_on_the_card(cuda_device, monkeypatch):
    """hartmann6 is a space the fused kernel takes; widened, its cohort
    keeps off it and proposes as the grouped ``ei_diff`` cohort does, bit
    for bit."""
    dom = zoo.ZOO["hartmann6"]
    streams = []
    for widen, knob in ((False, "0"), (True, "1")):
        monkeypatch.setenv("HYPEROPT_TPU_MEGAKERNEL", knob)
        megakernel.fused_sample_ei.launches = megakernel.ei_diff.launches = 0
        sched = StudyScheduler(device=cuda_device, widen=widen)
        sids = [sched.create_study(dom.space, seed=s, n_startup_jobs=5) for s in (3, 4)]
        for _ in range(15):
            for sid, (a,) in sched.ask_many([(sid, 1) for sid in sids]).items():
                sched.tell(sid, a["tid"], dom.objective(a["params"]))
        assert all(c.widen == widen for c in sched._cohorts.values())
        assert megakernel.fused_sample_ei.launches == 0 and megakernel.ei_diff.launches > 0
        streams.append([[d["misc"]["vals"] for d in sched._studies[sid].trials]
                        for sid in sids])
    assert streams[0] == streams[1]


@pytest.mark.parametrize("name", ["ml_logreg_cv", "ml_model_select_cv"])
def test_ml_objective_on_the_card_follows_the_cpu(cuda_device, name):
    """Host numbers fit on the card inside the card's evaluation device
    and agree with the CPU's fit (card tolerance); TF32 stays off."""
    from hyperopt_tpu_torch.utils import evaluation_device

    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(2)
    pts = []
    for i in range(4):
        if name == "ml_logreg_cv":
            pts.append({"lr": float(np.exp(rng.uniform(-9, 1))),
                        "l2": float(np.exp(rng.uniform(-13, 0))),
                        "momentum": float(rng.uniform(0, 0.98))})
        else:
            pts.append({"m": i % 2, "lr_lin": float(np.exp(rng.uniform(-9, 1))),
                        "l2_lin": float(np.exp(rng.uniform(-13, 0))),
                        "lr_mlp": float(np.exp(rng.uniform(-9, 0))),
                        "l2_mlp": float(np.exp(rng.uniform(-13, 0))),
                        "w_scale": float(np.exp(rng.uniform(-2.3, 1.1)))})
    fn = zoo.ZOO[name].objective
    for p in pts:
        with evaluation_device(cuda_device):
            card = fn(p)
        with evaluation_device("cpu"):
            cpu = fn(p)
        assert card.device.type == "cuda" and cpu.device.type == "cpu"
        np.testing.assert_allclose(float(card), float(cpu), rtol=1e-4, atol=1e-5)


def test_executor_batch_on_the_card_equals_per_trial_losses(cuda_device):
    """``ExecutorTrials(traceable=True)`` evaluates a queue of 8 as one
    batch on the card; each loss equals the trial's own fit there."""
    from hyperopt_tpu_torch.parallel import ExecutorTrials
    from hyperopt_tpu_torch.utils import evaluation_device

    dom = zoo.ZOO["ml_logreg_cv"]
    et = ExecutorTrials(n_workers=1, traceable=True)
    try:
        port.fmin(dom.traceable, dom.space, algo=port.rand.suggest, max_evals=8, max_queue_len=8,
                  trials=et, rstate=0, show_progressbar=False)
    finally:
        et.shutdown()
    assert et.metrics.counter("batch_evals").value == 1
    for d in et.trials:
        point = {k: v[0] for k, v in d["misc"]["vals"].items()}
        with evaluation_device(cuda_device):
            own = float(dom.objective(point))
        np.testing.assert_allclose(d["result"]["loss"], own, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["ml_logreg_cv", "ml_model_select_cv"])
def test_ml_domain_tpe_asks_launch_ei_diff_once_each(cuda_device, name):
    dom = zoo.ZOO[name]
    asks = [0]

    def counted(new_ids, domain, trials, seed):
        if len(trials.trials) >= 5:
            asks[0] += 1
        return tpe.suggest(new_ids, domain, trials, seed, n_startup_jobs=5)

    before = megakernel.ei_diff.launches
    # a diverged model-selection fit is a NaN loss, an errored trial
    port.fmin(dom.objective, dom.space, algo=counted, max_evals=9, trials=port.Trials(),
              rstate=0, show_progressbar=False, catch_eval_exceptions=True)
    assert asks[0] >= 3
    assert megakernel.ei_diff.launches - before == asks[0]


def _hpob_history(device, n=300, cap=512, seed=3):
    """A padded ``hpob_surrogate`` history of ``n`` prior draws on ``device``."""
    from hyperopt_tpu_torch import prng

    cs = Domain(None, zoo.ZOO["hpob_surrogate"].space).cs
    keys = prng.fold_in(prng.PRNGKey(seed, "cpu"), torch.arange(cap))
    flats = {l: v.numpy() for l, v in cs.sample_flat(keys).items()}
    live = np.arange(cap) < n
    obj = zoo.ZOO["hpob_surrogate"].objective
    losses = np.full(cap, np.inf, np.float32)
    for i in range(n):
        losses[i] = obj(cs.assemble({l: (int(flats[l][i]) if cs.params[l].is_int
                                         else float(flats[l][i])) for l in cs.labels}))
    acts = cs.active_flat(flats)
    hist = {"losses": torch.tensor(losses, device=device),
            "has_loss": torch.tensor(live, device=device),
            "vals": {l: torch.tensor(np.where(live, flats[l], 0).astype(np.float32),
                                     device=device) for l in cs.labels},
            "active": {l: torch.tensor(np.asarray(acts[l]) * np.ones(cap, bool) & live,
                                       device=device) for l in cs.labels}}
    return cs, hist


def test_sharded_proposals_on_repeated_card_entries_equal_one_entry(cuda_device):
    """A mesh that names the card twice: each entry's launches cover half
    the batch (or half the candidates), planned with the same component
    splits as the one-entry launch, so the proposals are the same bits."""
    from hyperopt_tpu_torch import prng
    from hyperopt_tpu_torch.parallel import sharding

    cs, hist = _hpob_history(cuda_device)
    cfg = {"prior_weight": 1.0, "n_EI_candidates": 24, "gamma": 1.0, "LF": 100,
           "ei_select": "softmax", "ei_tau": 0.5, "prior_eps": 0.1}
    keys = prng.fold_in(prng.PRNGKey(5, cuda_device), torch.arange(64, device=cuda_device))
    m = hist["losses"].shape[0] + 1
    assert (megakernel._launch_plan("ei_diff", 3, 64 * 24, m)["splits"]
            == megakernel._launch_plan("ei_diff", 3, 32 * 24, m)["splits"])
    two = sharding.make_mesh(devices=[cuda_device, cuda_device])
    before = megakernel.ei_diff.launches
    got = sharding.suggest_batch_sharded(cs, cfg, two, packed=True)(hist, keys)
    # per entry: the numeric group's candidates, then its prior-mix draws
    assert megakernel.ei_diff.launches == before + 4
    want = port.rand.pack_labels(cs, tpe.build_propose(cs, cfg)(hist, keys))
    assert torch.equal(got, want)
    cand = sharding.make_mesh(n_cand_shards=2, devices=[cuda_device, cuda_device])
    assert (megakernel._launch_plan("ei_diff", 1, 64 * 12, m)["splits"]
            == megakernel._launch_plan("ei_diff", 1, 64 * 24, m)["splits"])
    step = sharding.propose_sharded_candidates(cs, cfg, cand, packed=True, batch=64)
    fused = sharding._propose_fused_pool(cs, cfg, cand, packed=True, batch=64)
    assert torch.equal(step(hist, keys), fused(hist, keys))
    cpu = {k: ({l: t.cpu() for l, t in v.items()} if isinstance(v, dict) else v.cpu())
           for k, v in hist.items()}
    on_cpu = sharding.propose_sharded_candidates(
        cs, cfg, sharding.make_mesh(n_cand_shards=2, devices=["cpu", "cpu"]), packed=True,
        batch=64)(cpu, keys.cpu())
    assert torch.allclose(step(hist, keys).cpu(), on_cpu, rtol=1e-4, atol=1e-5)


def test_sharded_cohort_on_the_card_equals_the_unsharded_cohort(cuda_device, monkeypatch):
    from hyperopt_tpu_torch import convert
    from hyperopt_tpu_torch.parallel import sharding

    monkeypatch.delenv("HYPEROPT_TPU_MEGAKERNEL", raising=False)
    cs = Domain(None, zoo.ZOO["hartmann6"].space).cs
    assert megakernel.armed(cs)
    cfg = {"prior_weight": 1.0, "n_EI_candidates": 24, "gamma": 0.25, "LF": 25,
           "ei_select": "argmax", "ei_tau": 1.0, "prior_eps": 0.0}
    S, cap, B = 8, 32, 2
    rng = np.random.default_rng(0)
    stack = {"vals": {l: rng.uniform(size=(S, cap)).astype(np.float32) for l in cs.labels},
             "active": {l: np.arange(cap)[None].repeat(S, 0) < 20 for l in cs.labels},
             "losses": np.where(np.arange(cap) < 20, rng.uniform(size=(S, cap)),
                                np.inf).astype(np.float32),
             "has_loss": np.arange(cap)[None].repeat(S, 0) < 20}
    rows = np.zeros((S, 1, 2 * len(cs.labels) + 3), np.float32)
    rows[:, :, -1] = cap
    seeds = np.stack([tpe._seed_words(3 * s + 1) for s in range(S)])
    ids = (np.arange(S * B).reshape(S, B) + 7).astype(np.uint32)
    _, want = tpe.build_suggest_batched(cs, cfg, S, cap, B)(
        convert.cohort_stack_from_numpy(stack, cuda_device), rows, seeds, ids)
    mesh = sharding.suggest_mesh(devices=[cuda_device, cuda_device])
    before = megakernel.fused_sample_ei.launches
    _, got = tpe.build_suggest_batched(cs, cfg, S, cap, B, mesh=mesh)(
        convert.cohort_stack_from_numpy(stack, cuda_device), rows, seeds, ids)
    torch.cuda.synchronize()
    assert megakernel.fused_sample_ei.launches == before + 2  # one per shard
    assert torch.equal(got, want)


def _service_stream(sched, sids, objective_of, rounds):
    out = {sid: [] for sid in sids}
    for _ in range(rounds):
        for sid, (a,) in sched.ask_many([(sid, 1) for sid in sids]).items():
            out[sid].append((a["tid"], a["params"]))
            sched.tell(sid, a["tid"], float(objective_of[sid](a["params"])))
    return out


@pytest.mark.parametrize("store", [True, False], ids=["store", "wal_only"])
def test_service_resume_on_the_card_is_bit_for_bit(cuda_device, tmp_path, store):
    """A scheduler on the card stops mid-run (no drain: a crash) and a new
    one resumes its root; each study's stream equals an undisturbed run on
    the card bit for bit.  With the WAL alone every ask regenerates, one
    request a wave: each study sits alone in its cohort here, so every
    regenerated launch plans as the live one did."""
    doms = [zoo.ZOO["branin"], zoo.ZOO["hpob_surrogate"]]
    kw = ({"store_root": str(tmp_path)} if store
          else {"wal": str(tmp_path / "service.wal.jsonl")})

    def admit(sched):
        return [sched.create_study(d.space, seed=70 + i, study_id=f"s{i}",
                                   space_spec={"zoo": d.name}, n_startup_jobs=4)
                for i, d in enumerate(doms)]

    objective_of = {f"s{i}": d.objective for i, d in enumerate(doms)}
    first = StudyScheduler(device=cuda_device, **kw)
    sids = admit(first)
    got = _service_stream(first, sids, objective_of, 9)
    first.journal.sync()
    resumed = StudyScheduler(device=cuda_device, **kw)
    assert resumed.last_resume["errors"] == 0
    assert resumed.last_resume["regenerated"] == (0 if store else 2 * 9)
    more = _service_stream(resumed, sids, objective_of, 6)
    ref = StudyScheduler(device=cuda_device)
    want = _service_stream(ref, admit(ref), objective_of, 15)
    for sid in sids:
        assert got[sid] + more[sid] == want[sid]
        if not store:  # the regenerated docs are the live run's, bit for bit
            live = [(d["tid"], d["misc"]["vals"]) for d in first._studies[sid].trials.trials]
            back = [(d["tid"], d["misc"]["vals"]) for d in resumed._studies[sid].trials.trials]
            assert back[:len(live)] == live


def test_ladder_rungs_launch_the_kernels_at_scaled_candidates(cuda_device, monkeypatch):
    """``half_candidates`` and ``small_caps`` scale ``n_EI_candidates`` by
    0.5 and 0.25 for the tick: the three kernels launch at those widths
    (``hpob_surrogate``'s quantized group in ``q_mass_diff``)."""
    sched = StudyScheduler(device=cuda_device, degrade=100)
    doms = [zoo.ZOO["branin"], zoo.ZOO["hpob_surrogate"]]
    sids = [sched.create_study(d.space, seed=90 + i, n_startup_jobs=2)
            for i, d in enumerate(doms)]
    objective_of = dict(zip(sids, (d.objective for d in doms)))
    _service_stream(sched, sids, objective_of, 2)
    shapes = []
    ei, fused, qm = megakernel.ei_diff, megakernel.fused_sample_ei, megakernel.q_mass_diff
    real = megakernel._launchable

    def recording(name, P, tensors):  # every CUDA launch passes this check
        shapes.append((name, tensors[0].shape[1]))
        return real(name, P, tensors)

    monkeypatch.setattr(megakernel, "_launchable", recording)
    for level, n in ((0, 24), (1, 12), (2, 6)):
        sched.degrade._level = level
        shapes.clear()
        before = (ei.launches, fused.launches, qm.launches)
        answers = sched.ask_many([(sid, 1) for sid in sids])
        assert all(not a[0].get("degraded") for a in answers.values()) == (level == 0)
        assert sorted(set(shapes)) == [("ei_diff", n), ("fused_sample_ei", n), ("q_mass_diff", n)]
        assert (ei.launches - before[0], fused.launches - before[1],
                qm.launches - before[2]) == (1, 1, 1)
        for sid, (a,) in answers.items():
            sched.tell(sid, a["tid"], float(objective_of[sid](a["params"])))


def test_fleet_handoff_on_the_card_is_bit_for_bit(cuda_device, tmp_path):
    """Two replicas on the card: the second joins, the first hands it its
    hottest shard, and every stream equals an undisturbed card scheduler's
    bit for bit; both kernels ran on the replicas' cohort ticks."""
    from hyperopt_tpu_torch.service import FleetReplica, shard_of
    from hyperopt_tpu_torch.service.server import ServiceHTTPServer

    mix = [it for it in zoo.make_study_mix(5)
           if it.domain.name in ("quadratic1", "hpob_surrogate")]

    def loss(i, tid):
        return float(((tid * 7919 + i * 104729) % 1009) / 1009.0)

    def replica(rid):
        return FleetReplica(str(tmp_path), n_shards=2, replica_id=rid, addr=f"http://{rid}",
                            lease_ttl=30.0, scheduler_kwargs={"wave_window": 0.0})

    def drive(route, sids, rounds, out):
        for _ in range(rounds):
            for i, sid in enumerate(sids):
                srv = route(sid)
                status, p = srv.handle("POST", "/ask", {"study_id": sid})
                assert status == 200, p
                t = p["trials"][0]
                assert srv.handle("POST", "/tell", {"study_id": sid, "tid": t["tid"],
                                                    "loss": loss(i, t["tid"])})[0] == 200
                out.append((i, t["tid"], {k: repr(v) for k, v in t["params"].items()}))

    launches = (megakernel.ei_diff.launches, megakernel.fused_sample_ei.launches)
    ra = replica("ra")
    assert ra.device.type == "cuda"
    ra.join()
    ra.steward_once()
    sa = ServiceHTTPServer(0, fleet=ra)
    sids = [sa.handle("POST", "/study", {"zoo": it.domain.name, "seed": it.seed,
                                          "n_startup_jobs": 3})[1]["study_id"] for it in mix]
    got = []
    drive(lambda sid: sa, sids, 5, got)
    rb = replica("rb")
    rb.join()
    ra.manage_once()  # two live replicas: the first hands off its hottest shard
    rb.manage_once()
    assert ra.handoffs == 1 and rb.adoptions == 1
    sb = ServiceHTTPServer(0, fleet=rb)
    drive(lambda sid: sb if shard_of(sid, 2) in rb.schedulers else sa, sids, 5, got)
    assert megakernel.ei_diff.launches > launches[0]
    assert megakernel.fused_sample_ei.launches > launches[1]

    ref = StudyScheduler(wal=False)
    rsids = [ref.create_study(it.domain.space, seed=it.seed, n_startup_jobs=3) for it in mix]
    want = []
    for _ in range(10):
        for i, sid in enumerate(rsids):
            (a,) = ref.ask(sid)
            ref.tell(sid, a["tid"], loss(i, a["tid"]))
            want.append((i, a["tid"], {k: repr(v) for k, v in a["params"].items()}))
    assert got == want
    ra.drain()
    rb.drain()


def test_serving_planes_armed_propose_what_disarmed_do_on_the_card(cuda_device):
    """The quality, cost and tenant planes (on by default) never move a
    proposal on the card: tenants' waves, packed by deficit-round-robin,
    propose bit for bit as with every plane disarmed."""
    mix = zoo.make_study_mix(10)
    streams = []
    for off in ({}, {"quality": False, "load": False, "tenants": False}):
        sched = StudyScheduler(wal=False, **off)
        sids = [sched.create_study(it.domain.space, seed=it.seed, n_startup_jobs=3,
                                   tenant=f"t{i % 3}") for i, it in enumerate(mix)]
        stream = []
        for r in range(7):
            out = sched.ask_many([(sid, 1) for sid in (sids if r % 2 else sids[::-1])])
            for i, sid in enumerate(sids):
                (a,) = out[sid]
                sched.tell(sid, a["tid"], float(((a["tid"] * 13 + i) % 11) / 11.0))
                stream.append((i, a["tid"], {k: repr(v) for k, v in a["params"].items()}))
        streams.append(stream)
        if not off:
            assert sched.load.status()["waves"] > 0 and sched.tenants.status()["tenants"] == 3
    assert streams[0] == streams[1]


def _counted_obs_fmin(device, n=60, trials=None, **kw):
    """A branin ``fmin`` at 64 candidates counting its TPE asks and the
    ``ei_diff`` launches they make."""
    counts = {"asks": 0, "launches": 0}
    tuned = __import__("functools").partial(tpe.suggest, n_startup_jobs=20,
                                            n_EI_candidates=64)

    def algo(new_ids, domain, trials, seed):
        before = megakernel.ei_diff.launches
        docs = tuned(new_ids, domain, trials, seed)
        if len(trials.trials) >= 20:
            counts["asks"] += 1
            counts["launches"] += megakernel.ei_diff.launches - before
        return docs

    dom = zoo.ZOO["branin"]
    t = trials if trials is not None else port.Trials(device=device)
    port.fmin(dom.objective, dom.space, algo=algo, max_evals=n, trials=t,
              rstate=np.random.default_rng(4), show_progressbar=False, **kw)
    return t, counts


def test_armed_obs_run_on_the_card_is_bit_for_bit_and_launches_ei_diff(cuda_device, tmp_path):
    """Armed (stream, scrape server, capture plane), the card's branin run
    proposes what the disarmed one does, every TPE ask launches
    ``ei_diff`` once either way, and a capture asked for on another
    thread while the run goes records the kernel inside ``fmin.tick``."""
    import gzip
    import json
    import threading
    import time

    plain, c_plain = _counted_obs_fmin(cuda_device)
    box = {}
    t = port.Trials(device=cuda_device)

    def ask_capture():
        deadline = time.monotonic() + 60
        # past the prior draws: the loop is running and serves captures
        while len(t.trials) < 25 and time.monotonic() < deadline:
            time.sleep(0.01)
        box["rec"] = t.obs_profiler.capture(0.5)

    th = threading.Thread(target=ask_capture)
    th.start()
    armed, c_armed = _counted_obs_fmin(cuda_device, n=300, trials=t,
                                       obs=str(tmp_path / "run.jsonl"), obs_http=0,
                                       profile=str(tmp_path / "prof"))
    th.join(timeout=120)
    assert not th.is_alive()
    assert c_plain["launches"] == c_plain["asks"] == 40
    assert c_armed["launches"] == c_armed["asks"] == 280
    again, _ = _counted_obs_fmin(cuda_device, n=300)
    assert [d["misc"]["vals"] for d in armed.trials] == [d["misc"]["vals"] for d in again.trials]
    rec = box["rec"]
    assert rec["ok"] and rec["thread"] == "loop", rec
    with gzip.open(rec["trace_json"], "rt") as f:
        events = json.load(f)["traceEvents"]
    ticks = [e for e in events if e.get("ph") == "X"
             and str(e.get("name", "")).startswith("fmin.tick#")]
    kernels = [e for e in events if e.get("cat") == "kernel" and "ei_diff" in e.get("name", "")]
    assert ticks and kernels
    assert any(a["ts"] <= k["ts"] and k["ts"] + k.get("dur", 0) <= a["ts"] + a["dur"]
               for k in kernels for a in ticks)


@pytest.mark.parametrize("route", ["on", "off"])
def test_canary_digest_on_the_card_is_the_same_twice_on_each_route(cuda_device, monkeypatch,
                                                                   route):
    """The prober's canary, served in process on the card, digests the
    same twice on the fused route and on grouped ``ei_diff``, the card's
    committed golden, and its TPE asks launch that route's kernel."""
    from hyperopt_tpu_torch.obs import prober

    monkeypatch.setenv("HYPEROPT_TPU_MEGAKERNEL", route)
    kernel = megakernel.fused_sample_ei if route == "on" else megakernel.ei_diff
    before = kernel.launches
    first = prober.local_digest(device=cuda_device)
    assert kernel.launches - before >= prober.CANARY["asks"] - prober.CANARY["n_startup"]
    assert prober.local_digest(device=cuda_device) == first and not first[1]
    assert first[0] == prober.load_golden(backend="cuda")


def test_server_capture_from_another_thread_holds_the_wave_kernels(cuda_device, tmp_path,
                                                                   monkeypatch):
    """``HYPEROPT_TPU_PROFILE`` arms the server's capture plane; a capture
    asked for on another thread is recorded by the thread that leads the
    next wave, so it holds that wave's kernel."""
    import threading
    import time

    from hyperopt_tpu_torch.service.server import ServiceHTTPServer

    monkeypatch.setenv("HYPEROPT_TPU_PROFILE", str(tmp_path / "caps"))
    srv = ServiceHTTPServer(0, scheduler=StudyScheduler(device=cuda_device, wal=False),
                            trace=False, slo=False)
    sid = srv.handle("POST", "/study", {"zoo": "quadratic1", "seed": 2,
                                        "n_startup_jobs": 1})[1]["study_id"]

    def ask_tell():
        code, a = srv.handle("POST", "/ask", {"study_id": sid})
        assert code == 200
        srv.handle("POST", "/tell", {"study_id": sid, "tid": a["trials"][0]["tid"],
                                     "loss": 1.0})

    ask_tell()  # the startup ask: no tick wave
    box = {}
    th = threading.Thread(target=lambda: box.setdefault(
        "rec", srv.profiler.capture(1.0, reason="test")))
    th.start()
    deadline = time.monotonic() + 60
    while srv.profiler._request is None and time.monotonic() < deadline:
        time.sleep(0.005)
    before = megakernel.fused_sample_ei.launches
    ask_tell()  # this thread leads the wave
    th.join(timeout=180)
    rec = box["rec"]
    assert megakernel.fused_sample_ei.launches == before + 1
    assert rec["ok"] and rec["scope"] == "wave leader" and rec["waves"] == 1, rec
    assert rec["kernels"] >= 1 and set(rec["stop_split"]) >= {"sync_sec", "stop_sec"}


def test_stall_capture_states_its_kernel_count(cuda_device, tmp_path):
    """A stall capture runs on the watchdog's thread while another thread
    launches kernels: its record states its scope and kernel count, and
    with no kernel it is no device trace."""
    import threading

    from hyperopt_tpu_torch.obs.profiler import DeviceProfiler

    prof = DeviceProfiler(str(tmp_path / "caps"), stall_capture_sec=0.5)
    stop = threading.Event()
    args = _inputs(2, 1024, 1025, cuda_device)

    def loop():
        while not stop.is_set():
            megakernel.ei_diff(*args)
            torch.cuda.synchronize()

    th = threading.Thread(target=loop)
    th.start()
    stall = {"kind": "stall"}
    try:
        rec = prof.capture_on_stall(stall)
    finally:
        stop.set()
        th.join()
    assert rec["scope"] == "watchdog thread" and isinstance(rec["kernels"], int)
    assert stall["capture"]["kernels"] == rec["kernels"]
    if rec["kernels"] == 0:
        assert not rec["ok"] and "host_trace_json" in rec and "trace_json" not in rec
    else:
        assert rec["ok"] and "trace_json" in rec
