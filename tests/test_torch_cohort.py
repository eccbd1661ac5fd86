"""The study-batched cohort and the study scheduler against the JAX
package's, on the same inputs.

- ``build_suggest_batched`` against the reference's on one stacked history
  (carried across by ``convert.cohort_stack_from_numpy``) for float32,
  bf16, int8 and fp8 storage, on ``tests/test_batched_suggest.py``'s
  space (uniform, loguniform, randint: the grouped route) and on a
  numeric-only space (the fused route, and the grouped route with
  ``HYPEROPT_TPU_MEGAKERNEL=0``);
- the cohort-program LRU;
- ``StudyScheduler`` against the reference's ``StudyScheduler`` and against
  the port's own sequential ``fmin`` at the same seeds, with the drive of
  ``tests/test_batched_suggest.py``, and across a capacity migration.

Tolerance: the parity standard.  Discrete values, codes and trial ids
compare bitwise; floats at rtol 1e-5, atol 1e-6.  The scheduler against
the port's sequential ``fmin`` is bitwise: both run the same torch
arithmetic on the CPU, and the cohort's tighter capacity bucket is fully
masked.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hyperopt_tpu import hp as ref_hp, quant as ref_quant
from hyperopt_tpu.algos import tpe as ref_tpe
from hyperopt_tpu.base import Domain as RefDomain
from hyperopt_tpu.service import StudyScheduler as RefScheduler
import hyperopt_tpu_torch as port
from hyperopt_tpu_torch import convert, hp, megakernel, zoo
from hyperopt_tpu_torch.algos import tpe
from hyperopt_tpu_torch.base import Domain
from hyperopt_tpu_torch.service import (DuplicateTellError, StudyQuotaError,
                                        StudyScheduler, UnknownStudyError)
from hyperopt_tpu_torch.service.scheduler import _cohort_cap

RTOL, ATOL = 1e-5, 1e-6
CFG = {"prior_weight": 1.0, "n_EI_candidates": 24, "gamma": 0.25,
       "LF": 25, "ei_select": "argmax", "ei_tau": 1.0, "prior_eps": 0.0}


def _space(h, kind):
    if kind == "mixed":  # tests/test_batched_suggest.py's space
        return {"x": h.uniform("x", -5, 5), "lr": h.loguniform("lr", -4, 0),
                "k": h.randint("k", 4)}
    return {"x": h.uniform("x", -5, 5), "lr": h.loguniform("lr", -4, 0),
            "n": h.normal("n", 1, 2), "ln": h.lognormal("ln", 0, 1)}


def obj(d):
    return (d["x"] - 1.0) ** 2 + d["lr"] + 0.1 * d.get("k", 0) + 0.01 * d.get("n", 0) ** 2


def _stack(rcs, S, cap, name, rng):
    """A seeded numpy stack in storage ``name``: study ``s`` holds ``7 + 2s``
    live rows (tied losses, one row without a loss), values drawn from
    each label's prior range and snapped to the code grid when coded."""
    qp = ref_quant.space_qparams(rcs, name) if name in ("int8", "fp8") else None
    vals = {l: np.zeros((S, cap), np.float32) for l in rcs.labels}
    act = {l: np.zeros((S, cap), bool) for l in rcs.labels}
    losses = np.full((S, cap), np.inf, np.float32)
    has = np.zeros((S, cap), bool)
    for s in range(S):
        n = 7 + 2 * s
        for l in rcs.labels:
            fam = rcs.params[l].dist.family
            v = {"uniform": lambda: rng.uniform(-5, 5, n),
                 "loguniform": lambda: np.exp(rng.uniform(-4, 0, n)),
                 "randint": lambda: rng.integers(0, 4, n),
                 "normal": lambda: rng.normal(1, 2, n),
                 "lognormal": lambda: np.exp(rng.normal(0, 1, n))}[fam]().astype(np.float32)
            vals[l][s, :n] = ref_quant.snap_np(v, qp[l], name) if qp else v
            act[l][s, :n] = True
        losses[s, :n] = np.round(rng.uniform(size=n), 1)
        has[s, :n] = True
        has[s, 1] = False
        losses[s, 1] = np.inf
    if qp:
        vals = {l: np.asarray(ref_quant.quantize_np(vals[l], qp[l], name)).reshape(S, cap)
                for l in rcs.labels}
    if name != "float32":
        vals = {l: (v if qp else v.astype(ref_quant.vals_dtype(name))) for l, v in vals.items()}
        losses = np.asarray(jnp.asarray(losses, ref_quant.losses_dtype(name)))
    return {"vals": vals, "active": act, "losses": losses, "has_loss": has}


def _rows(rcs, S, cap, rng, qp_name):
    """Two pending tell rows per study (into slots 12, 13), a padding row
    after them."""
    L = len(rcs.labels)
    rows = np.zeros((S, 4, 2 * L + 3), np.float32)
    rows[:, :, -1] = cap
    for s in range(S):
        for k, slot in enumerate((12, 13)):
            for j, l in enumerate(rcs.labels):
                fam = rcs.params[l].dist.family
                v = {"uniform": rng.uniform(-5, 5), "loguniform": np.exp(rng.uniform(-4, 0)),
                     "randint": rng.integers(0, 4), "normal": rng.normal(1, 2),
                     "lognormal": np.exp(rng.normal())}[fam]
                if qp_name in ("int8", "fp8"):
                    qp = ref_quant.label_qparams(rcs.params[l].dist, qp_name)
                    v = ref_quant.snap_np(np.float32(v), qp, qp_name)
                rows[s, k, j] = v
                rows[s, k, L + j] = 1.0
            rows[s, k, 2 * L] = rng.uniform()
            rows[s, k, 2 * L + 1] = 1.0
            rows[s, k, -1] = slot
    return rows


@pytest.mark.parametrize("name", ["float32", "bfloat16", "int8", "fp8"])
@pytest.mark.parametrize("kind,route", [("mixed", "on"), ("numeric", "on"), ("numeric", "0")])
def test_batched_suggest_matches_reference(kind, route, name, monkeypatch):
    rcs = RefDomain(None, _space(ref_hp, kind)).cs
    cs = Domain(None, _space(hp, kind)).cs
    S, cap, B = 3, 16, 4
    rng = np.random.default_rng(11)
    stack = _stack(rcs, S, cap, name, rng)
    rows = _rows(rcs, S, cap, rng, name)
    seeds = np.stack([ref_tpe._seed_words((s + 1) * 2**33 + 17 * s) for s in range(S)])
    ids = (np.arange(S * B).reshape(S, B) * 7 + 3).astype(np.uint32)
    monkeypatch.delenv("HYPEROPT_TPU_MEGAKERNEL", raising=False)
    ref_run = ref_tpe.build_suggest_batched(rcs, CFG, S, cap, B, donate=False, hist_dtype=name)
    ref_hist, want = ref_run(jax.tree.map(jnp.asarray, stack), rows, seeds, ids)
    monkeypatch.setenv("HYPEROPT_TPU_MEGAKERNEL", route)
    assert megakernel.armed(cs) == (kind == "numeric" and route == "on")
    run = tpe.build_suggest_batched(cs, CFG, S, cap, B, hist_dtype=name)
    hist = convert.cohort_stack_from_numpy(stack, "cpu")
    launches = megakernel.fused_sample_ei.launches
    got_hist, got = run(hist, rows, seeds, ids)
    assert got_hist is hist  # donate=True folds in place
    assert megakernel.fused_sample_ei.launches == launches  # the CPU takes the plain twin
    folded = convert.cohort_stack_from_numpy(jax.tree.map(np.asarray, ref_hist), "cpu")
    for j, l in enumerate(cs.labels):
        w, g = np.asarray(want)[..., j], got[..., j].numpy()
        if rcs.params[l].dist.family == "randint":
            np.testing.assert_array_equal(g, w, err_msg=l)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=l)
        # the fold wrote the reference's codes (values) into slots 12 and 13
        np.testing.assert_array_equal(got_hist["vals"][l].float().numpy(),
                                      folded["vals"][l].float().numpy(), err_msg=l)
    np.testing.assert_array_equal(got_hist["losses"].float().numpy(),
                                  folded["losses"].float().numpy())


def test_cohort_programs_are_cached_by_shape(monkeypatch):
    monkeypatch.delenv("HYPEROPT_TPU_MEGAKERNEL", raising=False)
    cs = Domain(None, _space(hp, "numeric")).cs
    before = tpe.cohort_cache_stats()
    a = tpe.build_suggest_batched(cs, CFG, 4, 32, 2)
    assert tpe.build_suggest_batched(cs, CFG, 4, 32, 2) is a
    stats = tpe.cohort_cache_stats()
    assert stats["hits"] == before["hits"] + 1 and stats["misses"] == before["misses"] + 1
    key = tpe.cohort_key(cs, CFG, 4, 32, 2)
    assert key[-2:] == ("megakernel", "on")
    assert tpe.cohort_cache_contains(key)
    assert tpe.cohort_cache_stats()["hits"] == stats["hits"]  # a probe counts nothing
    others = [tpe.build_suggest_batched(cs, CFG, 8, 32, 2),
              tpe.build_suggest_batched(cs, CFG, 4, 64, 2),
              tpe.build_suggest_batched(cs, CFG, 4, 32, 4),
              tpe.build_suggest_batched(cs, CFG, 4, 32, 2, hist_dtype="int8")]
    assert all(o is not a for o in others)
    assert tpe.cohort_key(cs, CFG, 4, 32, 2, hist_dtype="int8")[-4:-2] == ("quant", "int8")
    monkeypatch.setenv("HYPEROPT_TPU_MEGAKERNEL", "0")
    assert tpe.cohort_key(cs, CFG, 4, 32, 2) != key
    assert tpe.build_suggest_batched(cs, CFG, 4, 32, 2) is not a
    # mesh= works: a sharded cohort is its own cached program
    from hyperopt_tpu_torch.parallel import sharding

    mesh = sharding.suggest_mesh(devices=["cpu", "cpu"])
    sharded = tpe.build_suggest_batched(cs, CFG, 4, 32, 2, mesh=mesh)
    assert sharded is not a and tpe.build_suggest_batched(cs, CFG, 4, 32, 2, mesh=mesh) is sharded
    assert tpe.cohort_key(cs, CFG, 4, 32, 2, mesh=mesh)[-2:] == ("mesh", mesh.geometry())


def _drive(sched, space, seeds, budget, qn=2, n_startup=4):
    """``tests/test_batched_suggest.py``'s drive: every study asks ``qn``
    per wave and tells every answer before the next wave."""
    sids = [sched.create_study(space, seed=s, n_startup_jobs=n_startup) for s in seeds]
    for _ in range(budget // qn):
        answers = sched.ask_many([(sid, qn) for sid in sids])
        for sid in sids:
            for a in answers[sid]:
                sched.tell(sid, a["tid"], float(obj(a["params"])))
    return [[d["misc"]["vals"] for d in sched._studies[sid].trials] for sid in sids]


def _fmin(space, seed, budget, qn=2, n_startup=4):
    t = port.Trials(device="cpu")
    port.fmin(obj, space, algo=functools.partial(port.tpe.suggest, n_startup_jobs=n_startup),
              max_evals=budget, max_queue_len=qn, trials=t,
              rstate=np.random.default_rng(seed), show_progressbar=False)
    return [d["misc"]["vals"] for d in t.trials]


def _assert_streams_close(want, got):
    assert len(want) == len(got)
    for ws, gs in zip(want, got):
        assert len(ws) == len(gs)
        for a, b in zip(ws, gs):
            assert a.keys() == b.keys()
            for k in a:
                assert len(a[k]) == len(b[k])
                np.testing.assert_allclose(b[k], a[k], rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("kind", ["mixed", "numeric"])
def test_scheduler_matches_reference_scheduler_and_sequential_fmin(kind):
    """3 studies, budget 12, two asks per wave, 4 startup jobs: the port's
    scheduler follows the reference's scheduler at the standard, and the
    port's sequential fmin bit for bit."""
    seeds = [100, 101, 102]
    want = _drive(RefScheduler(), _space(ref_hp, kind), seeds, 12)
    got = _drive(StudyScheduler(device="cpu"), _space(hp, kind), seeds, 12)
    _assert_streams_close(want, got)
    assert got == [_fmin(_space(hp, kind), s, 12) for s in seeds]


def test_scheduler_migrates_across_capacity_buckets():
    """A budget past 16 trials moves the studies from the 16-slot cohort to
    the 32-slot one without moving the stream."""
    assert _cohort_cap(10) == 16 and _cohort_cap(16) == 32
    seeds = [7, 8]
    sched = StudyScheduler(device="cpu")
    got = _drive(sched, _space(hp, "numeric"), seeds, 20)
    assert {c.cap for c in sched._cohorts.values()} == {32}
    assert got == [_fmin(_space(hp, "numeric"), s, 20) for s in seeds]


def test_scheduler_quotas_errors_and_unported_options():
    sched = StudyScheduler(device="cpu", max_studies=2, max_pending=3)
    a = sched.create_study(_space(hp, "mixed"), seed=1, n_startup_jobs=2, max_trials=4)
    sched.create_study(_space(hp, "mixed"), seed=2)
    with pytest.raises(StudyQuotaError, match="quota"):
        sched.create_study(_space(hp, "mixed"))
    with pytest.raises(StudyQuotaError, match="pending"):
        sched.ask(a, n=4)
    answers = sched.ask(a, n=2)
    assert [x["tid"] for x in answers] == [0, 1]
    sched.tell(a, 0, 1.0)
    with pytest.raises(DuplicateTellError):
        sched.tell(a, 0, 1.0)
    with pytest.raises(UnknownStudyError):
        sched.tell(a, 99, 1.0)
    sched.tell(a, 1, float("nan"))  # a non-finite loss settles as a failure
    assert sched.study_status(a)["n_told"] == 2
    assert sched._studies[a].trials.trials[1]["result"]["status"] == "fail"
    tpe_answers = sched.ask(a, n=2)  # past the startup jobs: a cohort tick
    assert len(tpe_answers) == 2 and tpe_answers[0]["wave"] == 1
    for x in tpe_answers:
        sched.tell(a, x["tid"], 0.5)
    assert sched.study_status(a)["state"] == "done"
    with pytest.raises(UnknownStudyError, match="done"):
        sched.ask(a)
    sched.close_study(a)
    with pytest.raises(UnknownStudyError):
        sched.ask("nope")
    for kw, item in (({"store_root": "/x"}, 13), ({"wal": "w"}, 13), ({"degrade": 8}, 13),
                     ({"quality": True}, 14), ({"tenants": True}, 14)):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            StudyScheduler(device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="item 14"):
        sched.create_study(_space(hp, "mixed"), tenant="t")


def test_study_mix_serves_every_study_inside_its_space(monkeypatch):
    """A small ``make_study_mix`` through the scheduler: heterogeneous
    cohorts (the numeric domains on the fused route, the HPO-B surrogate on
    the grouped one), int8 history, every answer inside its space."""
    monkeypatch.setenv("HYPEROPT_TPU_HIST_DTYPE", "int8")
    sched = StudyScheduler(device="cpu")
    mix = zoo.make_study_mix(10)
    sids = {sched.create_study(it.domain.space, seed=it.seed,
                               n_startup_jobs=it.n_startup_jobs): it for it in mix}
    for _ in range(7):
        answers = sched.ask_many([(sid, 1) for sid in sids])
        assert set(answers) == set(sids)
        for sid, (a,) in answers.items():
            cs = sched._studies[sid].domain.cs
            for l, v in a["params"].items():
                fam, p = cs.params[l].dist.family, cs.params[l].dist.params
                if fam == "uniform":
                    assert p[0] <= v < p[1], (l, v)
                if fam == "loguniform":
                    assert np.exp(p[0]) * (1 - 1e-6) <= v <= np.exp(p[1]), (l, v)
            sched.tell(sid, a["tid"], sids[sid].domain.objective(
                sched._studies[sid].domain.cs.assemble(a["params"])))
    names = {c.hist_dtype for c in sched._cohorts.values()}
    assert names == {"int8", "bfloat16"}  # the surrogate's q-label degrades to bf16
    fused = [c for c in sched._cohorts.values() if megakernel.armed(c.cs)]
    assert len(fused) == 4
