"""The quantized-bin score ``megakernel.q_mass_diff`` on CPU tensors: its
plain twin is the below-minus-above ``tpe._q_lpdf_group`` difference bit
for bit, the wrapper refuses what the kernel does not take, and the TPE
group pipeline scores every quantized candidate and epsilon-prior draw
through it.  ``q_inputs`` also feeds the card tests in
``tests/test_torch_cuda.py``, so this file imports neither JAX nor the
JAX package."""

import math

import numpy as np
import pytest
import torch

from hyperopt_tpu_torch import megakernel
from hyperopt_tpu_torch.algos import tpe

# row kinds: (q, low, high, islog), bounds in t-space (log space for a log
# label): hp.uniformint(1, 5), LCBench's qloguniform(log 16, log 512, 1),
# quniform(-3, 11, 2) and qloguniform(0, 3, 2)
ROW_KINDS = {"int": (1.0, 0.5, 5.5, False),
             "logint": (1.0, math.log(16), math.log(512), True),
             "q2": (2.0, -3.0, 11.0, False),
             "logq": (2.0, 0.0, 3.0, True)}


def q_inputs(kinds, N, m, bounded, seed=0, dead=0, device="cpu"):
    """Seeded arguments of ``q_mass_diff`` for one group: value-space
    candidates ``[G, N]`` on each row's grid, the first eight columns the
    edge inputs (at and past both bounds, a log row's candidates below
    q/2), below/above tables ``[G, m]`` whose last ``dead`` components
    weigh 0, and the tables' in-bounds masses ``[G]``.  An unbounded group
    carries zero bounds, as the group statics do."""
    g = torch.Generator().manual_seed(seed)
    G = len(kinds)
    q, lo, hi = (torch.tensor([ROW_KINDS[k][i] for k in kinds], dtype=torch.float32)
                 for i in range(3))
    islog = torch.tensor([ROW_KINDS[k][3] for k in kinds])
    tabs = []
    for _ in range(2):
        w = torch.rand(G, m, generator=g) + 0.1
        w[:, m - dead:] = 0.0
        w = w / w.sum(1, keepdim=True).clamp(min=1e-12)
        mu = lo[:, None] + (hi - lo)[:, None] * (1.4 * torch.rand(G, m, generator=g) - 0.2)
        s = (hi - lo)[:, None] * (0.5 * torch.rand(G, m, generator=g) + 0.01)
        tabs += [w, mu, s]
    t = lo[:, None] + (hi - lo)[:, None] * (1.2 * torch.rand(G, N, generator=g) - 0.1)
    val = torch.where(islog[:, None], torch.exp(t), t)
    x = torch.round(val / q[:, None]) * q[:, None]
    vlo = torch.where(islog, torch.exp(lo), lo)
    vhi = torch.where(islog, torch.exp(hi), hi)
    edges = torch.stack([vlo, vhi, vlo - q, vhi + q, vhi + 3 * q,
                         torch.where(islog, torch.zeros_like(q), vlo - 3 * q),
                         torch.where(islog, q / 4, vlo), torch.where(islog, -q, vhi)], 1)
    k = min(N, edges.shape[1])
    x[:, :k] = edges[:, :k]
    if not bounded:
        lo, hi = torch.zeros_like(lo), torch.zeros_like(hi)
    p_b = tpe._p_accept_group(*tabs[:3], lo, hi, bounded)
    p_a = tpe._p_accept_group(*tabs[3:], lo, hi, bounded)
    return [a.to(device).contiguous() for a in (x, *tabs, q, lo, hi, islog, p_b, p_a)]


def _former(x, wb, mb, sb, wa, ma, sa, q, lo, hi, islog, p_b, p_a, bounded, has_log):
    """The group score as ``_propose_numeric_group`` wrote it before the
    kernel, each in-bounds mass computed inside ``_q_lpdf_group``."""
    return (tpe._q_lpdf_group(x, wb, mb, sb, lo, hi, q, islog, bounded, has_log)
            - tpe._q_lpdf_group(x, wa, ma, sa, lo, hi, q, islog, bounded, has_log))


# (row kinds, N, m, dead components, bounded, has_log)
CASES = [(("logint", "int", "logint"), 300, 65, 0, True, True),   # LCBench's group
         (("logint", "int", "logint"), 40, 257, 200, True, True),
         (("int", "q2"), 100, 33, 5, True, False),
         (("q2", "q2", "int"), 64, 1, 0, True, False),
         (("logint", "logq"), 50, 17, 0, True, True),
         (("q2", "logq"), 80, 129, 0, False, True),
         (("q2",), 24, 17, 3, False, False),
         (("logq", "logq"), 24, 1, 0, False, True)]


@pytest.mark.parametrize("kinds,N,m,dead,bounded,has_log", CASES)
def test_plain_twin_is_the_former_group_difference_bit_for_bit(kinds, N, m, dead, bounded,
                                                               has_log):
    args = q_inputs(kinds, N, m, bounded, seed=N + m, dead=dead)
    got = megakernel.q_mass_diff(*args, bounded, has_log)
    want = _former(*args, bounded, has_log)
    assert torch.isfinite(want).all()
    assert torch.equal(got, want)
    assert torch.equal(megakernel.q_mass_diff_plain(*args, bounded, has_log), want)


def _swap(args, i, value):
    return args[:i] + [value] + args[i + 1:]


@pytest.mark.parametrize("bad,error", [
    (lambda a: _swap(a, 0, a[0].double()), TypeError),                   # float64 candidates
    (lambda a: _swap(a, 3, a[3].double()), TypeError),                   # a float64 table
    (lambda a: _swap(a, 0, a[0].reshape(-1)), ValueError),               # candidates not [G, N]
    (lambda a: _swap(a, 5, a[5][:, :-1].contiguous()), ValueError),      # a short table
    (lambda a: _swap(a, 8, a[8][:1].contiguous()), ValueError),          # bounds not [G]
    (lambda a: _swap(a, 10, a[10].float()), ValueError),                 # islog not bool
    (lambda a: _swap(a, 10, a[10][:1].contiguous()), ValueError),        # islog not [G]
    (lambda a: _swap(a, 11, a[11].double()), TypeError),                 # a float64 mass
    (lambda a: _swap(a, 12, a[12][:1].contiguous()), ValueError),        # a mass not [G]
    (lambda a: _swap(a, 2, a[2].to("meta")), ValueError),                # a table elsewhere
    (lambda a: [t.to("meta") for t in a], ValueError)])                  # no kernel there
def test_wrapper_refuses_wrong_dtype_shape_or_device(bad, error):
    args = q_inputs(("logint", "int", "logint"), 16, 9, True)
    with pytest.raises(error):
        megakernel.q_mass_diff(*bad(args), True, True)


def test_group_pipeline_scores_candidates_and_prior_draws_through_the_wrapper(monkeypatch):
    """A grouped quantized TPE step calls the wrapper twice: on the
    ``[G, B * n]`` candidates and on the ``[G, B]`` epsilon-prior draws."""
    from hyperopt_tpu_torch import hp, prng, spaces

    space = {"a": hp.qloguniform("a", math.log(16), math.log(512), 1),
             "b": hp.uniformint("b", 1, 5), "c": hp.qloguniform("c", math.log(64),
                                                                 math.log(1024), 1)}
    cs = spaces.compile_space(space)
    cfg = {"prior_weight": 1.0, "n_EI_candidates": 16, "gamma": 1.0, "LF": 100,
           "ei_select": "softmax", "ei_tau": 0.5, "prior_eps": 0.5}
    cap, n, B = 32, 24, 5
    g = torch.Generator().manual_seed(3)
    history = {"losses": torch.where(torch.arange(cap) < n, torch.randn(cap, generator=g),
                                     torch.tensor(float("inf"))),
               "has_loss": torch.arange(cap) < n, "vals": {}, "active": {}}
    for l in cs.labels:
        lo_, hi_ = {"a": (16, 512), "b": (1, 5), "c": (64, 1024)}[l]
        v = torch.randint(lo_, hi_ + 1, (cap,), generator=g).to(torch.float32)
        history["vals"][l] = torch.where(torch.arange(cap) < n, v, torch.zeros(()))
        history["active"][l] = torch.arange(cap) < n
    calls = []
    real = megakernel.q_mass_diff

    def spy(x, *rest):
        calls.append(tuple(x.shape))
        return real(x, *rest)

    monkeypatch.setattr(megakernel, "q_mass_diff", spy)
    keys = prng.fold_in(prng.PRNGKey(5, "cpu"), torch.arange(B))
    out = tpe.build_propose_with_scores(cs, cfg, group=True)(history, keys)
    assert calls == [(3, B * cfg["n_EI_candidates"]), (3, B)]
    for l in cs.labels:
        val, ei = out[l]
        assert val.shape == ei.shape == (B,) and torch.isfinite(ei).all()


def quantized_loop_domain():
    """LCBench's quantized group as a traceable domain: two log-int labels
    and an int label, one bounded quantized group, and a torch objective."""
    from hyperopt_tpu_torch import hp
    from hyperopt_tpu_torch.base import Domain

    space = {"a": hp.qloguniform("a", math.log(16), math.log(512), 1),
             "b": hp.uniformint("b", 1, 5),
             "c": hp.qloguniform("c", math.log(64), math.log(1024), 1)}

    def objective(d):
        return ((torch.log(d["a"].to(torch.float32)) - 4.0) ** 2
                + (d["b"].to(torch.float32) - 3.0) ** 2
                + (torch.log(d["c"].to(torch.float32)) - 5.0) ** 2)

    return Domain(objective, space)


def test_device_loop_step_scores_the_quantized_group_through_the_wrapper(monkeypatch):
    """Each TPE step of the device loop over a quantized group calls the
    wrapper once (no epsilon-prior): on the card that call is the graph's
    ``q_mass_diff`` node."""
    from hyperopt_tpu_torch import device_fmin

    calls = []
    real = megakernel.q_mass_diff

    def spy(x, *rest):
        calls.append(tuple(x.shape))
        return real(x, *rest)

    monkeypatch.setattr(megakernel, "q_mass_diff", spy)
    cfg = {"prior_weight": 1.0, "n_EI_candidates": 24, "gamma": 0.25, "LF": 25}
    runner = device_fmin.DeviceLoopRunner(quantized_loop_domain(), cfg, 10, 30, device="cpu")
    state, rows = runner.run_chunk(runner.init_state(), 0, 30, seed=3)
    assert calls == [(3, 24)] * 20
    assert np.isfinite(rows).all()


@pytest.mark.parametrize("fleet", [False, True])
def test_batch_driver_generation_scores_its_quantized_group_through_the_wrapper(
        monkeypatch, tmp_path, fleet):
    """Each TPE generation of ``fmin_multihost`` on hpob_surrogate (one
    quantized group: depth and dropout), collective or as a fleet
    controller, calls the wrapper twice: on the ``[2, batch * n]``
    candidates and on the ``[2, batch]`` epsilon-prior draws."""
    from hyperopt_tpu_torch import zoo
    from hyperopt_tpu_torch.parallel import driver

    calls, per_gen = [], []
    real, build = megakernel.q_mass_diff, driver.tpe.build_propose

    def spy(x, *rest):
        calls.append(tuple(x.shape))
        return real(x, *rest)

    def counted_build(cs, cfg, **kw):
        propose = build(cs, cfg, **kw)

        def counted(history, keys):
            n = len(calls)
            out = propose(history, keys)
            per_gen.append(calls[n:])
            return out
        return counted

    monkeypatch.setattr(megakernel, "q_mass_diff", spy)
    monkeypatch.setattr(driver.tpe, "build_propose", counted_build)
    dom = zoo.ZOO["hpob_surrogate"]
    res = driver.fmin_multihost(dom.objective, dom.space, 64, batch=16, seed=0,
                                _force_single=True, device="cpu",
                                fleet_dir=str(tmp_path / "fleet") if fleet else None)
    assert res.n_evals == 64
    n_ei = driver._default_cfg(16)["n_EI_candidates"]
    assert per_gen == [[(2, 16 * n_ei), (2, 16)]] * 2  # 20 startup trials, then 2 generations
