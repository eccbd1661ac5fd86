"""The port's mesh sharding against the JAX package's, on meshes of the same
shape: the JAX package's 8 virtual CPU devices (``tests/conftest.py``)
against a port mesh of 8 CPU entries.

- the partition-rule table gives every leaf the reference's spec, and an
  unmatched leaf raises;
- ``make_mesh``/``suggest_mesh`` shapes and ``should_shard_history``
  under ``HYPEROPT_TPU_HIST_SHARD_MIN``;
- ``suggest_batch_sharded`` on a 4x2 mesh and ``propose_sharded_candidates``
  (single, batched, an indivisible ``n_EI_candidates``, ``prior_eps > 0``)
  against the reference's, and the sharded pool against the one-launch
  pool;
- ``fmin(algo=tpe.suggest_sharded(...))`` end to end against the
  reference's, with a queue and with the candidate axis;
- ``HYPEROPT_TPU_SHARD`` on ``tpe.suggest`` and on
  ``build_suggest_batched(mesh=...)``/``StudyScheduler``: bitwise equal to
  the unsharded port, within the standard of the reference;
- the generation fold into a capacity-sharded history.

Tolerance: the parity standard (keys, ids and discrete values bitwise,
floats rtol 1e-5, atol 1e-6).  Sharded against unsharded in the port is
bitwise: both run the same torch arithmetic on the CPU.  Knobs are set
with ``monkeypatch`` only."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hyperopt_tpu as ref
from hyperopt_tpu import spaces as ref_spaces, zoo as ref_zoo
from hyperopt_tpu.algos import tpe as ref_tpe
from hyperopt_tpu.parallel import sharding as ref_sh
from hyperopt_tpu.service import StudyScheduler as RefScheduler
import hyperopt_tpu_torch as port
from hyperopt_tpu_torch import prng, spaces, zoo
from hyperopt_tpu_torch.algos import tpe
from hyperopt_tpu_torch.parallel import sharding
from hyperopt_tpu_torch.service import StudyScheduler

RTOL, ATOL = 1e-5, 1e-6
CPU8 = ["cpu"] * 8
HPOB = "hpob_surrogate"
RCS = ref_spaces.compile_space(ref_zoo.ZOO[HPOB].space)
PCS = spaces.compile_space(zoo.ZOO[HPOB].space)
CFGS = {
    "argmax24": {"prior_weight": 1.0, "n_EI_candidates": 24, "gamma": 0.25, "LF": 25},
    "softmax100_eps": {"prior_weight": 1.0, "n_EI_candidates": 100, "gamma": 1.0,
                       "LF": 100, "ei_select": "softmax", "ei_tau": 0.5, "prior_eps": 0.1},
    # 101 candidates do not split evenly over 2 or 4 shards
    "softmax101_eps": {"prior_weight": 1.0, "n_EI_candidates": 101, "gamma": 1.0,
                       "LF": 100, "ei_select": "softmax", "ei_tau": 0.5, "prior_eps": 0.4},
}


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    for name in ("HYPEROPT_TPU_SHARD", "HYPEROPT_TPU_HIST_SHARD_MIN", "HYPEROPT_TPU_MEGAKERNEL",
                 "HYPEROPT_TPU_HIST_DTYPE"):
        monkeypatch.delenv(name, raising=False)


@functools.lru_cache(maxsize=None)
def _history(n=60, cap=128, seed=3):
    """A numpy padded history of ``n`` hpob_surrogate trials (reference
    prior draws scored by the objective)."""
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(seed), i))(
        jnp.arange(cap, dtype=jnp.uint32))
    fl = {l: np.asarray(v) for l, v in jax.vmap(RCS.sample_flat)(keys).items()}
    acts = RCS.active_flat(fl)
    live = np.arange(cap) < n
    obj = ref_zoo.ZOO[HPOB].objective
    losses = np.full(cap, np.inf, np.float32)
    for i in range(n):
        losses[i] = obj(RCS.assemble({l: (int(fl[l][i]) if RCS.params[l].is_int
                                          else float(fl[l][i])) for l in RCS.labels}))
    return {"losses": losses, "has_loss": live.copy(),
            "vals": {l: np.where(live, fl[l], 0).astype(np.float32) for l in RCS.labels},
            "active": {l: np.asarray(acts[l]) * np.ones(cap, bool) & live
                       for l in RCS.labels}}


def _ref_hist(h):
    return jax.tree.map(jnp.asarray, h)


def _port_hist(h):
    return {"losses": torch.tensor(h["losses"]), "has_loss": torch.tensor(h["has_loss"]),
            "vals": {l: torch.tensor(v) for l, v in h["vals"].items()},
            "active": {l: torch.tensor(v) for l, v in h["active"].items()}}


def _keys(ids, seed=5):
    ref_k = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(seed), i))(
        jnp.asarray(ids, jnp.uint32))
    port_k = prng.fold_in(prng.PRNGKey(seed, "cpu"), torch.as_tensor(np.asarray(ids, np.int64)))
    np.testing.assert_array_equal(np.asarray(ref_k), port_k.numpy())
    return ref_k, port_k


def _assert_packed_close(want, got):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape
    for j, l in enumerate(RCS.labels):
        if RCS.params[l].is_int:
            np.testing.assert_array_equal(got[..., j], want[..., j], err_msg=l)
        else:
            np.testing.assert_allclose(got[..., j], want[..., j], rtol=RTOL, atol=ATOL,
                                       err_msg=l)


# ---------------------------------------------------------------------------
# the rule table and the meshes
# ---------------------------------------------------------------------------


def _spec_tree(tree):
    """Specs of a tree of either package's shardings or specs, canonical:
    a one-axis group ("cand",) and the axis name mean the same split."""
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    if isinstance(tree, (sharding.NamedSharding, jax.sharding.NamedSharding)):
        return _spec_tree(tree.spec)
    if isinstance(tree, (sharding.PartitionSpec, jax.sharding.PartitionSpec)):
        return tuple((tuple(p) if len(p) > 1 else p[0]) if isinstance(p, (tuple, list))
                     else p for p in tree)
    return [_spec_tree(v) for v in tree]


@pytest.mark.parametrize("kw", [{}, {"shard_history": True},
                                {"axes": ("trials", "cand")},
                                {"shard_history": True, "axes": ("trials", "cand")},
                                {"study_axis": True}])
def test_rule_table_maps_every_leaf_as_the_reference(kw):
    labels = RCS.labels
    tree = {"hist": ref_sh._hist_skeleton(labels), "rows": 0, "seed_words": 0, "ids": 0,
            "packed": 0, "stats": 0, "splits": 0}
    if not kw.get("study_axis"):
        tree.update(vals_rows=0, active_rows=0, fold_losses=0, fold_has=0, fold_idx=0)
    want = ref_sh.match_partition_rules(ref_sh.suggest_partition_rules(**kw), tree)
    got = sharding.match_partition_rules(sharding.suggest_partition_rules(**kw), tree)
    assert _spec_tree(got) == _spec_tree(want)
    with pytest.raises(ValueError, match="no partition rule matches leaf 'bogus'"):
        sharding.match_partition_rules(sharding.suggest_partition_rules(**kw), {"bogus": 0})


def test_shardings_of_the_tick_and_the_cohort_match_the_reference():
    rmesh, pmesh = ref_sh.suggest_mesh(8), sharding.suggest_mesh(devices=CPU8)
    for diag in (False, True):
        for sh in (False, True):
            want = ref_sh.suggest_shardings(rmesh, RCS.labels, shard_history=sh, diag=diag)
            got = sharding.suggest_shardings(pmesh, PCS.labels, shard_history=sh, diag=diag)
            assert _spec_tree(got) == _spec_tree(want)
    rmesh2, pmesh2 = ref_sh.make_mesh(8, 2), sharding.make_mesh(n_cand_shards=2, devices=CPU8)
    want = ref_sh.suggest_batched_shardings(rmesh2, RCS.labels)
    got = sharding.suggest_batched_shardings(pmesh2, PCS.labels)
    assert _spec_tree(got) == _spec_tree(want)


def test_mesh_shapes_match_the_reference():
    for n, c in ((8, 1), (8, 2), (8, 4), (4, 2), (6, 3)):
        assert sharding.make_mesh(n, c, devices=CPU8).shape == dict(ref_sh.make_mesh(n, c).shape)
    with pytest.raises(ValueError, match="not divisible"):
        sharding.make_mesh(8, 3, devices=CPU8)
    m = sharding.suggest_mesh(devices=CPU8)
    assert m.shape == dict(ref_sh.suggest_mesh().shape) == {"cand": 8}
    assert sharding.suggest_mesh(devices=CPU8) is m  # cached per geometry
    assert sharding.suggest_mesh(3, devices=CPU8).size == 3
    assert sharding.suggest_mesh(device="cpu").size == 1  # the one CPU
    assert sharding.make_mesh(device="cpu").shape == {"trials": 1, "cand": 1}
    assert m.local() == list(range(8))


@pytest.mark.parametrize("raw,cap,n", [(None, 65536, 8), (None, 32768, 8), ("1024", 1024, 8),
                                       ("1024", 1024, 1), ("1024", 1000, 8), ("64", 128, 4)])
def test_should_shard_history_honours_the_threshold(raw, cap, n, monkeypatch):
    if raw is not None:
        monkeypatch.setenv("HYPEROPT_TPU_HIST_SHARD_MIN", raw)
    want = ref_sh.should_shard_history(cap, ref_sh.suggest_mesh(n))
    assert sharding.should_shard_history(cap, sharding.suggest_mesh(devices=["cpu"] * n)) == want
    assert sharding.hist_shard_threshold() == ref_sh.hist_shard_threshold()


# ---------------------------------------------------------------------------
# the sharded proposal steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg_name,shard_history", [("argmax24", False),
                                                    ("softmax100_eps", True)])
def test_suggest_batch_sharded_matches_reference(cfg_name, shard_history):
    cfg = CFGS[cfg_name]
    h = _history()
    rk, pk = _keys(np.arange(16) * 7 + 1)
    rmesh = ref_sh.make_mesh(8, 2)
    want = ref_sh.suggest_batch_sharded(RCS, cfg, rmesh, packed=True,
                                        shard_history=shard_history)(_ref_hist(h), rk)
    pmesh = sharding.make_mesh(n_cand_shards=2, devices=CPU8)
    assert pmesh.shape == dict(rmesh.shape) == {"trials": 4, "cand": 2}
    hist = sharding.place_history(_port_hist(h), pmesh, shard_history=shard_history)
    if shard_history:
        assert [p.shape[0] for p in hist["losses"].parts] == [16] * 8
    got = sharding.suggest_batch_sharded(PCS, cfg, pmesh, packed=True,
                                         shard_history=shard_history)(hist, pk)
    _assert_packed_close(want, got.numpy())
    # the unsharded step gives the same bits
    one = tpe.build_propose(PCS, cfg)(_port_hist(h), pk)
    np.testing.assert_array_equal(got.numpy(), port.rand.pack_labels(PCS, one).numpy())
    unpacked = sharding.suggest_batch_sharded(PCS, cfg, pmesh)(_port_hist(h), pk)
    np.testing.assert_array_equal(torch.stack([unpacked[l] for l in PCS.labels], -1).numpy(),
                                  got.numpy())
    with pytest.raises(ValueError, match="does not split over 8"):
        sharding.suggest_batch_sharded(PCS, cfg, pmesh)(_port_hist(h), pk[:12])


@pytest.mark.parametrize("cfg_name,batch,n_cand_shards", [
    ("argmax24", None, 2), ("softmax101_eps", None, 2), ("softmax100_eps", 16, 1),
    ("softmax101_eps", 16, 2), ("argmax24", 16, 4)])
def test_propose_sharded_candidates_matches_reference(cfg_name, batch, n_cand_shards):
    cfg = CFGS[cfg_name]
    h = _history(seed=5)
    rk, pk = _keys(np.arange(16) * 13 + 2)
    if batch is None:
        rk, pk = rk[0], pk[0]
    rmesh = ref_sh.make_mesh(8, n_cand_shards)
    want = ref_sh.propose_sharded_candidates(RCS, cfg, rmesh, packed=True, batch=batch)(
        _ref_hist(h), rk)
    pmesh = sharding.make_mesh(n_cand_shards=n_cand_shards, devices=CPU8)
    got = sharding.propose_sharded_candidates(PCS, cfg, pmesh, packed=True, batch=batch)(
        sharding.replicate_history(_port_hist(h), pmesh), pk)
    _assert_packed_close(want, got.numpy())
    # every shard in its own call == all shards of a trials group in one
    fused = sharding._propose_fused_pool(PCS, cfg, pmesh, packed=True, batch=batch)
    np.testing.assert_array_equal(fused(_port_hist(h), pk).numpy(), got.numpy())
    if batch is None:
        one = sharding.propose_sharded_candidates(PCS, cfg, pmesh)(_port_hist(h), pk)
        np.testing.assert_array_equal(np.asarray([float(one[l]) for l in PCS.labels],
                                                 np.float32), got.numpy()[0])


def test_candidate_pool_matches_reference():
    """``build_propose_candidates``: every label's raw (samples, ei) pool."""
    cfg = CFGS["argmax24"]
    h = _history(seed=7)
    rk, pk = _keys([4, 9])
    want = jax.jit(jax.vmap(ref_tpe.build_propose_candidates(RCS, cfg),
                            in_axes=(None, 0)))(_ref_hist(h), rk)
    got = tpe.build_propose_candidates(PCS, cfg)(_port_hist(h), pk)
    for l in RCS.labels:
        (ws, wei), (gs, gei) = want[l], got[l]
        assert tuple(gs.shape) == tuple(np.shape(ws)) == (2, 24)
        np.testing.assert_allclose(gs.numpy().astype(np.float32), np.asarray(ws, np.float32),
                                   rtol=RTOL, atol=ATOL, err_msg=l)
        np.testing.assert_allclose(gei.numpy(), np.asarray(wei), rtol=RTOL, atol=ATOL,
                                   err_msg=l)


def _fmin(pkg, zoo_mod, algo, n, seed, **kw):
    trials = pkg.Trials(device="cpu") if pkg is port else pkg.Trials()
    dom = zoo_mod.ZOO[HPOB]
    pkg.fmin(dom.objective, dom.space, algo=algo, max_evals=n, trials=trials,
             rstate=np.random.default_rng(seed), show_progressbar=False, **kw)
    return trials


def _assert_same_stream(rt, pt):
    assert [t["tid"] for t in rt.trials] == [t["tid"] for t in pt.trials]
    for a, b in zip(rt.trials, pt.trials):
        va, vb = a["misc"]["vals"], b["misc"]["vals"]
        assert va.keys() == vb.keys()
        for k in va:
            np.testing.assert_allclose(va[k], vb[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"tid {a['tid']} {k}")
        np.testing.assert_allclose(a["result"]["loss"], b["result"]["loss"], rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("n_cand_shards,queue", [(1, 4), (2, 4), (2, 1)])
def test_fmin_with_suggest_sharded_matches_reference(n_cand_shards, queue):
    kw = dict(n_startup_jobs=8, n_EI_candidates=33, gamma=0.5)
    rt = _fmin(ref, ref_zoo, ref.tpe.suggest_sharded(
        mesh=ref_sh.make_mesh(8, n_cand_shards), **kw), 24, 1, max_queue_len=queue)
    algo = port.tpe.suggest_sharded(
        mesh=sharding.make_mesh(n_cand_shards=n_cand_shards, devices=CPU8), **kw)
    pt = _fmin(port, zoo, algo, 24, 1, max_queue_len=queue)
    _assert_same_stream(rt, pt)


def test_suggest_sharded_refuses_unknown_kwargs_at_factory_time():
    with pytest.raises(TypeError, match="unknown kwargs \\['gama'\\]"):
        port.tpe.suggest_sharded(gama=0.3)
    # the mesh is built over the trials' devices at the first TPE ask
    algo = port.tpe.suggest_sharded(n_startup_jobs=2)
    t = _fmin(port, zoo, algo, 4, 0)
    assert len(t.trials) == 4


# ---------------------------------------------------------------------------
# HYPEROPT_TPU_SHARD on the tick and the cohort
# ---------------------------------------------------------------------------


def _four_local_cpus(monkeypatch):
    """Four local CPU "devices", the port's counterpart of the forced
    host device count, so the knob's mesh has more than one entry."""
    real = sharding.local_devices

    def four(device=None):
        devs = real(device)
        return devs * 4 if devs[0].type == "cpu" else devs

    monkeypatch.setattr(sharding, "local_devices", four)


@pytest.mark.parametrize("hist_min", [None, "32"])
def test_shard_knob_on_tpe_suggest_is_bitwise_the_unsharded_tick(hist_min, monkeypatch):
    algo = {p: functools.partial(p.tpe.suggest, n_startup_jobs=6, n_EI_candidates=40)
            for p in (ref, port)}
    want = _fmin(port, zoo, algo[port], 21, 2, max_queue_len=3)
    _four_local_cpus(monkeypatch)
    monkeypatch.setenv("HYPEROPT_TPU_SHARD", "auto")
    if hist_min is not None:
        monkeypatch.setenv("HYPEROPT_TPU_HIST_SHARD_MIN", hist_min)
        assert sharding.should_shard_history(32, sharding.suggest_mesh(-1, device="cpu"))
    got = _fmin(port, zoo, algo[port], 21, 2, max_queue_len=3)
    assert [t["misc"]["vals"] for t in got.trials] == [t["misc"]["vals"] for t in want.trials]
    assert got.losses() == want.losses()
    monkeypatch.setenv("HYPEROPT_TPU_SHARD", "4")
    rt = _fmin(ref, ref_zoo, algo[ref], 21, 2, max_queue_len=3)
    _assert_same_stream(rt, got)


def _cohort_stack(cs, S, cap, rng):
    vals = {l: np.zeros((S, cap), np.float32) for l in cs.labels}
    act = {l: np.zeros((S, cap), bool) for l in cs.labels}
    losses = np.full((S, cap), np.inf, np.float32)
    has = np.zeros((S, cap), bool)
    for s in range(S):
        n = 6 + s
        for l in cs.labels:
            lo, hi = {"x": (-5, 5), "y": (0, 15), "lr": (-4, 0)}[l]
            v = rng.uniform(lo, hi, n)
            vals[l][s, :n] = np.exp(v) if l == "lr" else v
            act[l][s, :n] = True
        losses[s, :n] = rng.uniform(size=n)
        has[s, :n] = True
    return {"vals": vals, "active": act, "losses": losses, "has_loss": has}


@pytest.mark.parametrize("route", ["on", "0"])
def test_sharded_cohort_is_bitwise_the_unsharded_cohort(route, monkeypatch):
    from hyperopt_tpu.base import Domain as RefDomain
    from hyperopt_tpu_torch import convert, megakernel
    from hyperopt_tpu_torch.base import Domain

    space = lambda h: {"x": h.uniform("x", -5, 5), "y": h.uniform("y", 0, 15),  # noqa: E731
                       "lr": h.loguniform("lr", -4, 0)}
    cs, rcs = Domain(None, space(port.hp)).cs, RefDomain(None, space(ref.hp)).cs
    cfg = {"prior_weight": 1.0, "n_EI_candidates": 24, "gamma": 0.25, "LF": 25,
           "ei_select": "argmax", "ei_tau": 1.0, "prior_eps": 0.0}
    S, cap, B = 4, 16, 2
    stack = _cohort_stack(cs, S, cap, np.random.default_rng(3))
    rows = np.zeros((S, 1, 2 * 3 + 3), np.float32)
    rows[:, :, -1] = cap
    seeds = np.stack([tpe._seed_words(11 * s + 5) for s in range(S)])
    ids = (np.arange(S * B).reshape(S, B) * 3 + 1).astype(np.uint32)
    monkeypatch.setenv("HYPEROPT_TPU_MEGAKERNEL", route)
    assert megakernel.armed(cs) == (route == "on")
    mesh = sharding.suggest_mesh(devices=["cpu", "cpu"])
    assert tpe.cohort_key(cs, cfg, S, cap, B, mesh=mesh)[-2:] == ("mesh", mesh.geometry())
    plain = tpe.build_suggest_batched(cs, cfg, S, cap, B, donate=False)
    run = tpe.build_suggest_batched(cs, cfg, S, cap, B, mesh=mesh)
    assert tpe.build_suggest_batched(cs, cfg, S, cap, B, mesh=mesh) is run
    _, want = plain(convert.cohort_stack_from_numpy(stack, "cpu"), rows, seeds, ids)
    hist, got = run(convert.cohort_stack_from_numpy(stack, "cpu"), rows, seeds, ids)
    assert isinstance(hist["losses"], sharding.Placed)
    assert [tuple(p.shape) for p in hist["losses"].parts] == [(2, cap), (2, cap)]
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    hist2, got2 = run(hist, rows, seeds, ids)  # the placed stack threads forward
    assert hist2 is hist
    np.testing.assert_array_equal(got2.numpy(), want.numpy())
    # the JAX package's cohort sharded over two of its devices
    monkeypatch.setenv("HYPEROPT_TPU_MEGAKERNEL", "0")
    ref_run = ref_tpe.build_suggest_batched(rcs, cfg, S, cap, B, donate=False,
                                            mesh=ref_sh.suggest_mesh(2))
    _, ref_out = ref_run(jax.tree.map(jnp.asarray, stack), rows, seeds, ids)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_out), rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="does not split over 3"):
        tpe.build_suggest_batched(cs, cfg, S, cap, B, mesh=sharding.suggest_mesh(
            devices=["cpu"] * 3))


def _drive(sched, space_of, objective, seeds, waves):
    sids = [sched.create_study(space_of, seed=s, n_startup_jobs=4) for s in seeds]
    for _ in range(waves):
        answers = sched.ask_many([(sid, 2) for sid in sids])
        for sid in sids:
            for a in answers[sid]:
                sched.tell(sid, a["tid"], float(objective(a["params"])))
    return [[(d["misc"]["vals"], d["result"].get("loss")) for d in sched._studies[sid].trials]
            for sid in sids]


def test_shard_knob_on_the_scheduler_is_bitwise_the_unsharded_scheduler(monkeypatch):
    dom = zoo.ZOO["branin"]
    want = _drive(StudyScheduler(device="cpu"), dom.space, dom.objective, range(4), 6)
    _four_local_cpus(monkeypatch)
    monkeypatch.setenv("HYPEROPT_TPU_SHARD", "auto")
    sched = StudyScheduler(device="cpu")
    got = _drive(sched, dom.space, dom.objective, range(4), 6)
    assert got == want
    meshes = [c._mesh for c in sched._cohorts.values()]
    assert meshes and all(m is not None and len(m[1]) == 4 for m in meshes)
    rdom = ref_zoo.ZOO["branin"]
    ref_streams = _drive(RefScheduler(), rdom.space, rdom.objective, range(4), 6)
    for ws, gs in zip(ref_streams, got):
        for (wv, wl), (gv, gl) in zip(ws, gs):
            for k in wv:
                np.testing.assert_allclose(gv[k], wv[k], rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(gl, wl, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shard_history", [False, True])
def test_generation_fold_into_a_placed_history_matches_reference(shard_history):
    h = _history(n=20)
    L = len(RCS.labels)
    W, cap = 8, 128
    rng = np.random.default_rng(2)
    vals_rows = rng.uniform(size=(W, L)).astype(np.float32)
    act_rows = rng.uniform(size=(W, L)) > 0.3
    losses = rng.normal(size=W).astype(np.float32)
    has = np.ones(W, bool)
    idx = np.asarray([20, 21, 22, 23, 24, 61, cap, cap])  # two padding rows, dropped
    rmesh = ref_sh.make_mesh(8, 2)
    rhist = ref_sh.place_history(_ref_hist(h), rmesh, shard_history=shard_history)
    want = ref_sh.build_history_fold(RCS.labels, mesh=rmesh, shard_history=shard_history)(
        rhist, vals_rows, act_rows, losses, has, idx.astype(np.int32))
    pmesh = sharding.make_mesh(n_cand_shards=2, devices=CPU8)
    phist = sharding.place_history(_port_hist(h), pmesh, shard_history=shard_history)
    got = sharding.build_history_fold(PCS.labels, mesh=pmesh, shard_history=shard_history)(
        phist, vals_rows, act_rows, losses, has, idx)
    assert got is phist
    whole = sharding.entry_history(got, 3, torch.device("cpu"))
    np.testing.assert_array_equal(whole["losses"].numpy(), np.asarray(want["losses"]))
    np.testing.assert_array_equal(whole["has_loss"].numpy(), np.asarray(want["has_loss"]))
    for l in RCS.labels:
        np.testing.assert_array_equal(whole["vals"][l].numpy(), np.asarray(want["vals"][l]))
        np.testing.assert_array_equal(whole["active"][l].numpy(),
                                      np.asarray(want["active"][l]))
    plain = sharding.build_history_fold(PCS.labels)(_port_hist(h), vals_rows, act_rows,
                                                    losses, has, idx)
    np.testing.assert_array_equal(plain["losses"].numpy(), np.asarray(want["losses"]))
    # bf16 storage: float leaves compress on placement, the fold casts
    small = sharding.place_history(_port_hist(h), pmesh, shard_history=shard_history,
                                   dtype=torch.bfloat16)
    assert small["losses"].dtype == torch.bfloat16 and small["has_loss"].dtype == torch.bool
