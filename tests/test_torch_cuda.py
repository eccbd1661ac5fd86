"""Tests of the port that need an NVIDIA card (marker ``cuda``); elsewhere
they skip.  This file imports neither JAX nor the JAX package, so it also
runs on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import hyperopt_tpu_torch as port
from hyperopt_tpu_torch import device_fmin, hp, megakernel, zoo
from hyperopt_tpu_torch.algos import tpe
from hyperopt_tpu_torch.base import Domain
from hyperopt_tpu_torch.service import StudyScheduler

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
