"""The port's on-device loop against the JAX package's, run live on the
CPU: ``fmin_device`` and ``fmin(device_loop=True)`` give the reference's
trial streams (values and active masks at rtol 1e-5 / atol 1e-6, masks
exactly, losses at the same tolerance: the objectives are the same
float32 formulas, evaluated by XLA on one side and torch on the other),
``DeviceLoopRunner`` continues a reference loop state carried across by
``convert.device_loop_state_from_numpy``, and the traced assemble, the
batched evaluation and the traceability probe answer as the reference's
do.  The card's graph replays are held to these streams by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""

import collections
import functools
import logging
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import hyperopt_tpu as ref
from hyperopt_tpu import device_fmin as ref_device_fmin
from hyperopt_tpu import hp as rhp
from hyperopt_tpu import zoo as ref_zoo
import hyperopt_tpu_torch as port
from hyperopt_tpu_torch import convert, device_fmin, early_stop, hp, megakernel, prng, quant, zoo
from hyperopt_tpu_torch.base import Domain
from hyperopt_tpu_torch.utils import evaluation_device
from hyperopt_tpu_torch.exceptions import InvalidAnnotatedParameter
from hyperopt_tpu_torch.fmin import FMinIter

RTOL, ATOL = 1e-5, 1e-6
CFG = {"prior_weight": 1.0, "n_EI_candidates": 24, "gamma": 0.25, "LF": 25}


def _assert_same_docs(rt, pt):
    """Two trial stores hold the same trials: ids, per-label values (and
    so the active masks: an inactive label has no value), statuses and
    losses."""
    assert len(rt.trials) == len(pt.trials)
    for a, b in zip(rt.trials, pt.trials):
        assert a["tid"] == b["tid"]
        va, vb = a["misc"]["vals"], b["misc"]["vals"]
        assert va.keys() == vb.keys()
        for k in va:
            assert len(va[k]) == len(vb[k]), (a["tid"], k)
            np.testing.assert_allclose(va[k], vb[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"tid {a['tid']} {k}")
        assert a["result"]["status"] == b["result"]["status"], a["tid"]
        if "loss" in a["result"]:
            np.testing.assert_allclose(a["result"]["loss"], b["result"]["loss"],
                                       rtol=RTOL, atol=ATOL, err_msg=f"tid {a['tid']} loss")


def _assert_same_rows(r_rows, p_rows, L):
    """Chunk rows ``[k, 2L+1]``: values at the tolerance, active masks
    exactly, losses at the tolerance (NaN where the reference's is)."""
    r_rows, p_rows = np.asarray(r_rows, np.float32), np.asarray(p_rows, np.float32)
    assert r_rows.shape == p_rows.shape
    np.testing.assert_allclose(p_rows[:, :L], r_rows[:, :L], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(p_rows[:, L:2 * L], r_rows[:, L:2 * L])
    np.testing.assert_allclose(p_rows[:, 2 * L], r_rows[:, 2 * L], rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# fmin_device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,n", [("quadratic1", 50), ("branin", 60)])
def test_fmin_device_matches_reference(name, n):
    rdom, pdom = ref_zoo.ZOO[name], zoo.ZOO[name]
    kw = dict(max_evals=n, seed=3, n_startup_jobs=20)
    rt = ref_device_fmin.fmin_device(rdom.objective, rdom.space, return_trials=True, **kw)
    pt = port.fmin_device(pdom.traceable, pdom.space, return_trials=True, device="cpu", **kw)
    _assert_same_docs(rt, pt)
    assert pt.device.type == "cpu"
    r_best, r_loss = ref_device_fmin.fmin_device(rdom.objective, rdom.space, **kw)
    p_best, p_loss = port.fmin_device(pdom.traceable, pdom.space, device="cpu", **kw)
    assert p_best.keys() == r_best.keys()
    for k in r_best:
        np.testing.assert_allclose(p_best[k], r_best[k], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(p_loss, r_loss, rtol=RTOL, atol=ATOL)


def test_fmin_device_mixed_structure_conditional():
    # dict branches with different keys merge (the absent key reads 0); the
    # objective gates on neither, and the stream follows the reference's
    def spaces(h):
        return {"lr": h.loguniform("lr", -6, 0),
                "arch": h.choice("arch", [{"w": h.quniform("w", 16, 256, 16)},
                                          {"h": h.randint("h", 1, 9)}])}

    def r_obj(d):
        a = d["arch"]
        return (jnp.log(d["lr"]) + 3.0) ** 2 + 0.001 * (a["w"] + a["h"])

    def p_obj(d):
        a = d["arch"]
        return (torch.log(d["lr"]) + 3.0) ** 2 + 0.001 * (a["w"] + a["h"])

    rt = ref_device_fmin.fmin_device(r_obj, spaces(rhp), 40, seed=1, return_trials=True)
    pt = port.fmin_device(p_obj, spaces(hp), 40, seed=1, return_trials=True, device="cpu")
    _assert_same_docs(rt, pt)
    arch = [d["misc"]["vals"]["arch"][0] for d in pt.trials]
    assert set(arch) == {0, 1}  # both branches were proposed


def test_fmin_device_nan_objective_recorded_not_fatal():
    space = {p: {"x": h.uniform("x", -5, 5)} for p, h in (("r", rhp), ("p", hp))}
    rt = ref_device_fmin.fmin_device(lambda d: jnp.where(d["x"] < 0, jnp.nan, d["x"]),
                                     space["r"], 40, seed=0, return_trials=True)
    pt = port.fmin_device(lambda d: torch.where(d["x"] < 0, math.nan, d["x"]),
                          space["p"], 40, seed=0, return_trials=True, device="cpu")
    _assert_same_docs(rt, pt)
    statuses = {d["result"]["status"] for d in pt.trials}
    assert statuses == {"ok", "fail"}
    best, loss = port.fmin_device(lambda d: torch.where(d["x"] < 0, math.nan, d["x"]),
                                  space["p"], 40, seed=0, device="cpu")
    assert np.isfinite(loss) and best["x"] >= 0


def test_fmin_device_deterministic_and_reuses_its_program():
    dom = zoo.ZOO["quadratic1"]
    fn = dom.traceable
    a = port.fmin_device(fn, dom.space, 25, seed=7, device="cpu")
    hits = device_fmin._RUN_CACHE.stats()["hits"]
    b = port.fmin_device(fn, dom.space, 25, seed=7, device="cpu")
    assert a == b
    assert device_fmin._RUN_CACHE.stats()["hits"] == hits + 1
    assert port.fmin_device(fn, dom.space, 25, seed=8, device="cpu") != a
    key = prng.PRNGKey(7, "cpu")
    assert port.fmin_device(fn, dom.space, 25, seed=key, device="cpu") == a
    assert key.tolist() == [0, 7]  # the caller's key is read, not advanced


# ---------------------------------------------------------------------------
# fmin(device_loop=...) and DeviceLoopRunner
# ---------------------------------------------------------------------------


def _fmin(pkg, zoo_mod, name, n, seed, fn=None, **kw):
    dom = zoo_mod.ZOO[name]
    trials = pkg.Trials(device="cpu") if pkg is port else pkg.Trials()
    pkg.fmin(fn or dom.objective, dom.space, algo=kw.pop("algo", pkg.tpe.suggest),
             max_evals=n, trials=trials, rstate=np.random.default_rng(seed),
             show_progressbar=False, **kw)
    return trials


def test_fmin_device_loop_matches_reference_on_branin():
    rt = _fmin(ref, ref_zoo, "branin", 40, 0, device_loop=True)
    pt = _fmin(port, zoo, "branin", 40, 0, fn=zoo.ZOO["branin"].traceable, device_loop=True)
    _assert_same_docs(rt, pt)
    assert all(d["misc"]["cmd"] == ("domain_attachment", "FMinIter_Domain") for d in pt.trials)
    assert pt.argmin.keys() == {"x", "y"}


def test_device_loop_uniformint_objective_traces():
    # an integer-consuming objective (a table lookup) is eligible: the probe
    # and the loop hand integer labels over as int32
    table = np.asarray([9.0, 4.0, 1.0, 0.0, 1.0, 4.0, 9.0, 16.0], np.float32)
    r_table, p_table = jnp.asarray(table), torch.from_numpy(table)
    results = []
    for pkg, h, obj in (
            (ref, rhp, lambda d: r_table[d["depth"]]),
            (port, hp, lambda d: torch.take(p_table.to(d["depth"].device),
                                            d["depth"].long()))):
        t = pkg.Trials(device="cpu") if pkg is port else pkg.Trials()
        pkg.fmin(obj, {"depth": h.uniformint("depth", 0, 7)}, algo=pkg.tpe.suggest,
                 max_evals=30, trials=t, rstate=np.random.default_rng(0),
                 show_progressbar=False, device_loop=True)  # True: raises if ineligible
        results.append(t)
    _assert_same_docs(*results)
    assert min(l for l in results[1].losses() if l is not None) == 0.0


def test_resume_parity_from_a_reference_loop_state():
    # one reference loop state, carried across, then one chunk in both
    rdom = ref.base.Domain(ref_zoo.ZOO["branin"].objective, ref_zoo.ZOO["branin"].space)
    pdom = Domain(zoo.ZOO["branin"].traceable, zoo.ZOO["branin"].space)
    labels = pdom.cs.labels
    rr = ref_device_fmin.DeviceLoopRunner(rdom, CFG, 8, 40)
    rs, _ = rr.run_chunk(rr.init_state(), 0, 15, seed=11)
    vals, active, losses, has_loss = (
        {l: np.array(part[l]) for l in labels} if isinstance(part, dict) else np.array(part)
        for part in rs)
    ps = convert.device_loop_state_from_numpy(labels, vals, active, losses, has_loss,
                                              device="cpu")
    assert ps[0]["x"].dtype == torch.float32 and ps[1]["x"].dtype == torch.bool
    rs, r_rows = rr.run_chunk(rs, 15, 25, seed=12)
    pr = device_fmin.DeviceLoopRunner(pdom, CFG, 8, 40, device="cpu")
    ps, p_rows = pr.run_chunk(ps, 15, 25, seed=12)
    _assert_same_rows(r_rows, p_rows, len(labels))
    for l in labels:
        np.testing.assert_allclose(ps[0][l].numpy(), np.asarray(rs[0][l]), rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(ps[1][l].numpy(), np.asarray(rs[1][l]))
    np.testing.assert_array_equal(ps[3].numpy(), np.asarray(rs[3]))


@pytest.mark.parametrize("name", ["bf16", "int8"])
def test_compressed_loop_state_matches_reference(monkeypatch, name):
    # bf16 holds the state in bfloat16; int8 degrades to it (a plain cast
    # cannot encode codes), with the warn-once fallback
    monkeypatch.setenv("HYPEROPT_TPU_HIST_DTYPE", name)
    rdom = ref.base.Domain(ref_zoo.ZOO["branin"].objective, ref_zoo.ZOO["branin"].space)
    pdom = Domain(zoo.ZOO["branin"].traceable, zoo.ZOO["branin"].space)
    before = quant.fallback_count()
    rr = ref_device_fmin.DeviceLoopRunner(rdom, CFG, 6, 30)
    pr = device_fmin.DeviceLoopRunner(pdom, CFG, 6, 30, device="cpu")
    assert pr.hist_dtype == torch.bfloat16
    assert quant.fallback_count() == before + (name == "int8")
    rs, ps = rr.init_state(), pr.init_state()
    assert ps[0]["x"].dtype == ps[2].dtype == torch.bfloat16
    for start, seed in ((0, 5), (10, 6), (20, 7)):
        rs, r_rows = rr.run_chunk(rs, start, start + 10, seed)
        ps, p_rows = pr.run_chunk(ps, start, start + 10, seed)
        _assert_same_rows(r_rows, p_rows, 2)
    for l in ("x", "y"):
        np.testing.assert_array_equal(ps[0][l].float().numpy(),
                                      np.asarray(rs[0][l]).astype(np.float32))


def _make_iter(trials, fn, space):
    return FMinIter(port.tpe.suggest, Domain(fn, space), trials, max_evals=40,
                    rstate=np.random.default_rng(7), show_progressbar=False, device_loop=True)


def test_incremental_runs_continue_bitwise_and_foreign_history_is_refused():
    dom = zoo.ZOO["branin"]
    t_inc = port.Trials(device="cpu")
    it = _make_iter(t_inc, dom.traceable, dom.space)
    it.run(10)
    assert len(t_inc) == 10
    it.run(30)
    assert len(t_inc) == 40
    t_one = port.Trials(device="cpu")
    _make_iter(t_one, dom.traceable, dom.space).run(40)
    assert t_inc.losses() == t_one.losses()
    assert [d["misc"]["vals"] for d in t_inc.trials] == [d["misc"]["vals"] for d in t_one.trials]

    t_foreign = port.Trials(device="cpu")
    port.fmin(dom.traceable, dom.space, max_evals=5, trials=t_foreign,
              rstate=np.random.default_rng(0), show_progressbar=False)
    with pytest.raises(ValueError, match="ineligible"):
        _make_iter(t_foreign, dom.traceable, dom.space).run(5)


def test_loss_threshold_and_early_stop_stop_at_a_chunk_boundary():
    dom = zoo.ZOO["quadratic1"]
    t = _fmin(port, zoo, "quadratic1", 200, 0, fn=dom.traceable, loss_threshold=1.0,
              device_loop=True)
    assert len(t) < 200 and len(t) % device_fmin.DeviceLoopRunner.CHUNK == 0
    assert min(l for l in t.losses() if l is not None) <= 1.0
    t2 = _fmin(port, zoo, "quadratic1", 200, 0, fn=dom.traceable,
               early_stop_fn=early_stop.no_progress_loss(2), device_loop=True)
    assert len(t2) < 200 and len(t2) % device_fmin.DeviceLoopRunner.CHUNK == 0


def test_device_loop_checkpoints_at_each_chunk(tmp_path):
    import pickle

    path = str(tmp_path / "trials.pkl")
    t = _fmin(port, zoo, "quadratic1", 25, 0, fn=zoo.ZOO["quadratic1"].traceable,
              trials_save_file=path, device_loop=True)
    with open(path, "rb") as f:
        saved = pickle.load(f)
    assert len(saved.trials) == len(t.trials) == 25
    assert saved.losses() == t.losses()


def test_auto_takes_the_host_loop_when_ineligible(caplog):
    dom = zoo.ZOO["branin"]
    with caplog.at_level(logging.INFO, logger="hyperopt_tpu_torch.fmin"):
        t = _fmin(port, zoo, "branin", 12, 0, device_loop="auto")  # numpy objective
    assert len(t) == 12
    assert "does not trace" in caplog.text
    with pytest.raises(ValueError, match="ineligible: .*lookahead"):
        _fmin(port, zoo, "branin", 12, 0, fn=dom.traceable, device_loop=True, lookahead=1)
    # "auto" with a traceable objective takes the device loop: the same
    # trials as device_loop=True
    a = _fmin(port, zoo, "branin", 12, 0, fn=dom.traceable, device_loop="auto")
    b = _fmin(port, zoo, "branin", 12, 0, fn=dom.traceable, device_loop=True)
    assert a.losses() == b.losses()


def test_rand_suggest_matches_reference_and_unknown_kwargs_are_refused():
    dom = zoo.ZOO["quadratic1"]
    rt = _fmin(ref, ref_zoo, "quadratic1", 12, 2, algo=ref.rand.suggest, device_loop=True)
    pt = _fmin(port, zoo, "quadratic1", 12, 2, fn=dom.traceable, algo=port.rand.suggest,
               device_loop=True)
    _assert_same_docs(rt, pt)
    with pytest.raises(ValueError, match="unsupported algo kwargs"):
        _fmin(port, zoo, "quadratic1", 12, 2, fn=dom.traceable, device_loop=True,
              algo=functools.partial(port.tpe.suggest, verbose=True))


def test_shard_knob_raises_not_ported(monkeypatch):
    """Only a loop whose capacity would split over two or more devices
    is refused (item 12b); the one-device mesh of the CPU runs it."""
    from hyperopt_tpu_torch.parallel import sharding

    monkeypatch.setenv("HYPEROPT_TPU_SHARD", "auto")
    monkeypatch.setenv("HYPEROPT_TPU_HIST_SHARD_MIN", "16")
    pdom = Domain(zoo.ZOO["branin"].traceable, zoo.ZOO["branin"].space)
    device_fmin.DeviceLoopRunner(pdom, CFG, 5, 20, device="cpu")
    two = sharding.suggest_mesh(devices=["cpu", "cpu"])
    monkeypatch.setattr(sharding, "suggest_mesh", lambda n=None, devices=None, device=None: two)
    with pytest.raises(NotImplementedError, match="capacity-sharded device loop .*item 12b"):
        device_fmin.DeviceLoopRunner(pdom, CFG, 5, 20, device="cpu")
    device_fmin.DeviceLoopRunner(pdom, CFG, 5, 15, device="cpu")  # 15 rows do not split


def test_shard_knob_on_one_device_runs_the_loop_unchanged(monkeypatch):
    dom = zoo.ZOO["branin"]
    want = _fmin(port, zoo, "branin", 24, 0, fn=dom.traceable, device_loop=True)
    monkeypatch.setenv("HYPEROPT_TPU_SHARD", "auto")
    monkeypatch.setenv("HYPEROPT_TPU_HIST_SHARD_MIN", "1")
    got = _fmin(port, zoo, "branin", 24, 0, fn=dom.traceable, device_loop=True)
    assert [d["misc"]["vals"] for d in got.trials] == [d["misc"]["vals"] for d in want.trials]
    assert got.losses() == want.losses()


# ---------------------------------------------------------------------------
# the step is capturable: after its first run it makes no tensor from host
# data, reads nothing back and launches EI through the kernel wrapper
# ---------------------------------------------------------------------------

# operators that make a tensor from host data (a copy to the card, which a
# CUDA graph cannot record) or read a value back (a synchronization)
_HOST_OPS = {"lift_fresh", "lift_fresh_copy", "_local_scalar_dense", "nonzero",
             "masked_select", "unique", "_unique2", "item"}


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.count = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if name == "_to_copy" and "device" in (kwargs or {}):
            name = "_to_copy(device)"
        self.count[name] += 1
        return func(*args, **(kwargs or {}))


def _mixed_space(h):
    return {"lr": h.loguniform("lr", -6, 0), "c": h.pchoice("c", [(0.3, 0), (0.7, 1)]),
            "z": h.normal("z", 0, 1), "n": h.qlognormal("n", 0, 1, 1),
            "arch": h.choice("arch", [{"w": h.quniform("w", 16, 256, 16)},
                                      {"k": h.uniformint("k", 1, 9)}])}


@pytest.mark.parametrize("case", ["branin", "quadratic1", "hartmann6", "mixed"])
def test_step_makes_no_host_copy_after_warm_up(case):
    if case == "mixed":
        fn = (lambda d: torch.log(d["lr"]) + d["c"] + d["z"] + d["n"]
              + 0.001 * (d["arch"]["w"] + d["arch"]["k"]))
        space = _mixed_space(hp)
    else:
        fn, space = zoo.ZOO[case].traceable, zoo.ZOO[case].space
    runner = device_fmin.DeviceLoopRunner(Domain(fn, space), CFG, 3, 12, device="cpu")
    loop = runner._loop
    bufs = loop._buffers(runner.init_state())
    for branch in ("prior", "prior", "prior", "tpe"):  # the warm-up of each branch
        loop.step(bufs, branch)
    for branch in ("prior", "tpe"):
        ops = _Ops()
        with ops:
            loop.step(bufs, branch)
        assert not {k: v for k, v in ops.count.items()
                    if k in _HOST_OPS or k == "_to_copy(device)"}, branch
    assert int(bufs[2]) == 6 and bool(bufs[0][3][:6].any())


# ---------------------------------------------------------------------------
# the traced assemble, batched evaluation and the traceability probe
# ---------------------------------------------------------------------------


def _conditional(h):
    return h.choice("family", [
        {"kind": "a", "xs": [h.uniform("a0", 0, 1), h.uniform("a1", 0, 1)],
         "lr": h.loguniform("lra", -3, 0), "tag": "same"},
        {"kind": "b", "xs": [h.normal("b0", 0, 1), 2.5], "depth": h.randint("depth", 1, 5),
         "tag": "same"},
    ])


def _flats(cs, B, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for l, info in cs.params.items():
        if info.is_int:
            hi = len(info.dist.params) if info.dist.family == "categorical" else 2
            out[l] = rng.integers(0, hi, B).astype(np.int32)
        else:
            out[l] = rng.uniform(0.1, 2.0, B).astype(np.float32)
    return out


def _plain(tree):
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_plain(v) for v in tree)
    if isinstance(tree, str):
        return tree
    return np.asarray(tree).item() if not torch.is_tensor(tree) else tree.item()


@pytest.mark.parametrize("space_of", [_conditional, _mixed_space,
                                      lambda h: h.choice("c", [1, 2.5, 4])])
def test_traced_assemble_matches_reference(space_of):
    rcs = ref.spaces.compile_space(space_of(rhp))
    pcs = port.spaces.compile_space(space_of(hp))
    flats = _flats(pcs, 6, seed=4)
    for b in range(6):
        r = rcs.assemble({l: jnp.asarray(v[b]) for l, v in flats.items()}, traced=True)
        p = pcs.assemble({l: torch.tensor(v[b]) for l, v in flats.items()}, traced=True)
        rp, pp = _plain(r), _plain(p)
        assert rp.keys() == pp.keys() if isinstance(rp, dict) else True
        np.testing.assert_equal(pp, rp)


@pytest.mark.parametrize("space_of,message", [
    (lambda h: h.choice("c", [[h.uniform("a", 0, 1)], [1.0, 2.0]]), "different lengths"),
    (lambda h: h.choice("c", [{"x": h.uniform("a", 0, 1)}, 1.0]), "mix containers"),
    (lambda h: h.choice("c", ["one", "two"]), "cannot be merged"),
])
def test_traced_assemble_refuses_what_the_reference_refuses(space_of, message):
    rcs = ref.spaces.compile_space(space_of(rhp))
    pcs = port.spaces.compile_space(space_of(hp))
    flat = {l: 0 if pcs.params[l].is_int else 0.5 for l in pcs.labels}
    with pytest.raises(ref.exceptions.InvalidAnnotatedParameter):
        rcs.assemble({l: jnp.asarray(v) for l, v in flat.items()}, traced=True)
    with pytest.raises(InvalidAnnotatedParameter, match=message):
        pcs.assemble({l: torch.tensor(v) for l, v in flat.items()}, traced=True)


def test_make_batch_eval_matches_reference():
    def r_obj(d):
        return jnp.sum(jnp.stack(d["xs"])) * (1.0 + d.get("lr", 0.0)) + 0.1 * d.get("depth", 0)

    def p_obj(d):
        return torch.sum(torch.stack([torch.as_tensor(x, dtype=torch.float32)
                                      for x in d["xs"]])) * (1.0 + d["lr"]) + 0.1 * d["depth"]

    rdom = ref.base.Domain(r_obj, _conditional(rhp))
    pdom = Domain(p_obj, _conditional(hp))
    flats = _flats(pdom.cs, 16, seed=9)
    want = np.asarray(rdom.make_batch_eval()({l: jnp.asarray(v) for l, v in flats.items()}))
    got = pdom.make_batch_eval()({l: torch.from_numpy(v) for l, v in flats.items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    for name in ("branin", "hartmann6", "rosenbrock4"):
        rd = ref.base.Domain(ref_zoo.ZOO[name].objective, ref_zoo.ZOO[name].space)
        pd = Domain(zoo.ZOO[name].traceable, zoo.ZOO[name].space)
        flats = _flats(pd.cs, 32, seed=len(name))
        want = np.asarray(rd.make_batch_eval()({l: jnp.asarray(v) for l, v in flats.items()}))
        got = pd.make_batch_eval()({l: torch.from_numpy(v) for l, v in flats.items()})
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL, err_msg=name)


# (name, reference objective, port objective, traceable?)
_VERDICTS = [
    ("math", lambda d: (d["x"] - 1.0) ** 2 + jnp.cos(d["y"]),
     lambda d: (d["x"] - 1.0) ** 2 + torch.cos(d["y"]), True),
    ("math.cos", lambda d: (d["x"] - 1.0) ** 2 + math.cos(d["y"]),
     lambda d: (d["x"] - 1.0) ** 2 + math.cos(d["y"]), False),
    ("float()", lambda d: float(d["x"]) + d["y"], lambda d: float(d["x"]) + d["y"], False),
    ("numpy", lambda d: np.sin(np.asarray(d["x"])), lambda d: np.sin(np.asarray(d["x"])), False),
    ("branch", lambda d: d["x"] if d["x"] > 0 else d["y"],
     lambda d: d["x"] if d["x"] > 0 else d["y"], False),
    ("vector", lambda d: jnp.stack([d["x"], d["y"]]), lambda d: torch.stack([d["x"], d["y"]]),
     False),
    ("int loss", lambda d: d["k"] * 2, lambda d: d["k"] * 2, False),
    ("int label", lambda d: jnp.asarray([1.0, 2.0, 3.0])[d["k"]] * d["x"],
     lambda d: torch.take(torch.tensor([1.0, 2.0, 3.0], device=d["k"].device),
                          d["k"].long()) * d["x"], True),
]


@pytest.mark.parametrize("name,r_fn,p_fn,expected", _VERDICTS, ids=[v[0] for v in _VERDICTS])
def test_objective_is_traceable_verdicts(name, r_fn, p_fn, expected):
    space = {p: {"x": h.uniform("x", 0, 1), "y": h.normal("y", 0, 1), "k": h.randint("k", 3)}
             for p, h in (("r", rhp), ("p", hp))}
    assert ref_device_fmin.objective_is_traceable(ref.base.Domain(r_fn, space["r"])) is expected
    assert device_fmin.objective_is_traceable(Domain(p_fn, space["p"])) is expected


def test_zoo_traceable_objectives_agree_with_the_host_ones():
    rng = np.random.default_rng(0)
    for name, dom in zoo.ZOO.items():
        if dom.traceable is None:
            continue
        assert device_fmin.objective_is_traceable(Domain(dom.traceable, dom.space)), name
        cs = port.spaces.compile_space(dom.space)
        for _ in range(5):
            flat = {l: float(rng.uniform(0.05, 0.95)) for l in cs.labels}
            point = cs.assemble(flat)
            # the ML domains fit host numbers on the evaluation device, the
            # card unless the CPU is asked for
            with evaluation_device("cpu"):
                np.testing.assert_allclose(float(dom.traceable(point)), dom.objective(point),
                                           rtol=1e-5, atol=1e-5, err_msg=name)


def test_mirror_float_dtype_degrades_codes_to_bf16():
    before = quant.fallback_count()
    assert quant.mirror_float_dtype("float32") == torch.float32
    assert quant.mirror_float_dtype("bfloat16") == torch.bfloat16
    assert quant.mirror_float_dtype("fp8") == torch.bfloat16
    assert quant.fallback_count() == before + 1


def test_cpu_kernel_counts_stay_put():
    # on the CPU the wrappers take the plain path and count nothing
    launches = megakernel.ei_diff.launches
    port.fmin_device(zoo.ZOO["quadratic1"].traceable, zoo.ZOO["quadratic1"].space, 24,
                     device="cpu", n_startup_jobs=20)
    assert megakernel.ei_diff.launches == launches
    assert megakernel.ei_diff.captures == megakernel.ei_diff.graph_launches == 0
