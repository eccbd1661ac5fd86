"""The widened cohort against the JAX package's, and against the port's own
unwidened grouped cohort.

The port's widened cohort is its grouped cohort with the fused route off:
torch compiles nothing, so the JAX package's positional slot layout, whose
purpose is one compiled program per widened profile, has nothing to share.

- ``widened_profile`` equals the reference's;
- the port's grouped step (``group="all"``) follows the reference's
  ``build_propose_wide`` slot for slot, on float32 and int8 history;
- ``StudyScheduler(widen=True)`` follows the reference's scheduler with
  ``widen=True``, and proposes bit for bit as the port's unwidened
  scheduler on the grouped route (``HYPEROPT_TPU_MEGAKERNEL=0``);
- a widened cohort keeps off the fused kernel where an unwidened one
  takes it;
- ``HYPEROPT_TPU_COMPILE_WIDEN``.

Tolerance against the reference: the parity standard (integers bitwise,
floats rtol 1e-5, atol 1e-6).  Inside the port: bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hyperopt_tpu import hp as ref_hp
from hyperopt_tpu.algos import tpe as ref_tpe
from hyperopt_tpu.service import StudyScheduler as RefScheduler
from hyperopt_tpu.spaces import compile_space as ref_compile
from hyperopt_tpu_torch import hp, megakernel, prng, quant
from hyperopt_tpu_torch._env import parse_compile_widen
from hyperopt_tpu_torch.algos import tpe
from hyperopt_tpu_torch.service import StudyScheduler
from hyperopt_tpu_torch.spaces import compile_space

RTOL, ATOL = 1e-5, 1e-6
CFG = {"prior_weight": 1.0, "n_EI_candidates": 24, "gamma": 0.25,
       "LF": 25, "ei_select": "argmax", "ei_tau": 1.0, "prior_eps": 0.0}


def _wide_space(h):
    """``tests/test_compile_plane.py``'s widening space plus a quantized
    label: five groups, one of them padded (three labels in four slots)."""
    return {"lr": h.loguniform("lr", -5, 0), "l2": h.loguniform("l2", -8, 0),
            "mom": h.uniform("mom", 0.0, 0.98), "n": h.normal("n", 0.0, 1.0),
            "layers": h.randint("layers", 1, 5), "opt": h.choice("opt", [0, 1, 2]),
            "q": h.quniform("q", 0, 10, 2)}


def _history(cs, cap=16, n=10, seed=0):
    """``tests/test_compile_plane.py``'s seeded history."""
    rng = np.random.default_rng(seed)
    hist = {"vals": {l: np.zeros(cap, np.float32) for l in cs.labels},
            "active": {l: np.zeros(cap, bool) for l in cs.labels},
            "losses": np.full(cap, np.inf, np.float32),
            "has_loss": np.zeros(cap, bool)}
    for i in range(n):
        for l in cs.labels:
            fam = cs.params[l].dist.family
            hist["vals"][l][i] = (rng.integers(0, 3) if fam in ("randint", "categorical")
                                  else abs(rng.standard_normal()) + 0.01)
            hist["active"][l][i] = True
        hist["losses"][i] = rng.standard_normal()
        hist["has_loss"][i] = True
    return hist


def _positional(hist, profile, slots, cap=16):
    """The history in the widened slot layout, and each label's slot."""
    W = sum(e[-1] for e in profile)
    vals = np.zeros((W, cap), np.float32)
    act = np.zeros((W, cap), bool)
    pos, off = {}, 0
    for entry, ls in zip(profile, slots):
        for i, l in enumerate(ls):
            pos[l] = off + i
            vals[off + i] = hist["vals"][l]
            act[off + i] = hist["active"][l]
        off += entry[-1]
    return vals, act, pos


def test_profile_equals_the_reference():
    cs, rcs = compile_space(_wide_space(hp)), ref_compile(_wide_space(ref_hp))
    profile, slots = tpe.widened_profile(cs)
    assert (profile, slots) == ref_tpe.widened_profile(rcs)
    assert profile == (("disc", 3, 1), ("disc", 4, 1), ("num", False, False, 1),
                       ("num", False, True, 4), ("num", True, True, 1))
    # another space of the same shape shares the profile; a conditional
    # space does not widen
    other = compile_space({"w": hp.uniform("w", -9, 9), "a": hp.loguniform("a", -2, 2),
                           "b": hp.loguniform("b", -1, 0), "g": hp.normal("g", 5.0, 2.0),
                           "k": hp.randint("k", 10, 14), "c": hp.choice("c", ["x", "y", "z"]),
                           "r": hp.quniform("r", 1, 3, 0.5)})
    assert tpe.widened_profile(other)[0] == profile
    cond = compile_space(hp.choice("arch", [{"width": hp.uniformint("width", 1, 8)},
                                            {"fixed": 3}]))
    assert tpe.widened_profile(cond) is None
    assert ref_tpe.widened_profile(ref_compile(
        ref_hp.choice("arch", [{"width": ref_hp.uniformint("width", 1, 8)}, {"fixed": 3}]))) is None


@pytest.mark.parametrize("name", ["float32", "int8"])
def test_grouped_step_follows_the_reference_wide_step(name):
    """4 ids on one history: every label of the port's grouped step (what
    a widened cohort runs) equals the reference's widened step in that
    label's slot, at the standard.  int8 drops the q-label, which the code
    cannot hold."""
    space = {k: v for k, v in _wide_space(hp).items() if name == "float32" or k != "q"}
    rspace = {k: v for k, v in _wide_space(ref_hp).items() if name == "float32" or k != "q"}
    cs, rcs = compile_space(space), ref_compile(rspace)
    profile, slots = tpe.widened_profile(cs)
    qp = quant.space_qparams(cs, name) if name == "int8" else None
    hist = _history(cs)
    if qp is not None:  # snap-at-ingest, as a quantized history stores values
        for l in cs.labels:
            hist["vals"][l] = quant.snap_np(hist["vals"][l], qp[l], name)
    vals, act, pos = _positional(hist, profile, slots)
    keys = prng.fold_in(prng.PRNGKey(7), torch.arange(4))

    def codes(v, label):
        return quant.quantize_np(v, qp[label], name) if qp else torch.from_numpy(v)

    grouped = tpe.build_propose(cs, CFG, group="all", qparams=qp)(
        {"vals": {l: codes(hist["vals"][l], l) for l in cs.labels},
         "active": {l: torch.from_numpy(hist["active"][l]) for l in cs.labels},
         "losses": torch.from_numpy(hist["losses"]),
         "has_loss": torch.from_numpy(hist["has_loss"])}, keys)
    rvals = jnp.asarray(vals)
    if qp is not None:
        wvals = np.zeros(vals.shape, np.int8)
        for l in cs.labels:
            wvals[pos[l]] = codes(vals[pos[l]], l).numpy()
        rvals = jnp.asarray(wvals)
    rprop = jax.jit(ref_tpe.build_propose_wide(profile, CFG))
    rwp = jax.tree_util.tree_map(jnp.asarray, ref_tpe.widened_params(rcs, profile, slots,
                                                                     qparams=qp))
    for i in range(4):
        want = np.asarray(rprop({"vals": rvals, "active": jnp.asarray(act),
                                 "losses": jnp.asarray(hist["losses"]),
                                 "has_loss": jnp.asarray(hist["has_loss"])},
                                rwp, jax.random.fold_in(jax.random.PRNGKey(7), i)))
        for l in cs.labels:
            np.testing.assert_allclose(grouped[l][i].to(torch.float32).item(), want[pos[l]],
                                       rtol=RTOL, atol=ATOL, err_msg=l)


def _mixed(h):
    return {"x": h.uniform("x", -5, 5), "lr": h.loguniform("lr", -4, 0),
            "k": h.randint("k", 4), "c": h.choice("c", [0, 1, 2])}


def _obj(d):
    return (d["x"] - 1.0) ** 2 + d["lr"] + 0.1 * d["k"] + 0.05 * d["c"]


def _drive(sched, space, seeds, budget, qn=2):
    sids = [sched.create_study(space, seed=s, n_startup_jobs=4) for s in seeds]
    for _ in range(budget // qn):
        answers = sched.ask_many([(sid, qn) for sid in sids])
        for sid in sids:
            for a in answers[sid]:
                sched.tell(sid, a["tid"], float(_obj(a["params"])))
    return [[d["misc"]["vals"] for d in sched._studies[sid].trials] for sid in sids]


@pytest.mark.parametrize("name", ["float32", "int8"])
def test_widened_scheduler_follows_the_reference_and_the_grouped_cohort(name, monkeypatch):
    """3 studies, budget 12, two asks per wave: the widened scheduler
    follows the reference's widened scheduler at the standard and the
    port's unwidened grouped scheduler bit for bit."""
    monkeypatch.setenv("HYPEROPT_TPU_HIST_DTYPE", name)
    monkeypatch.setenv("HYPEROPT_TPU_MEGAKERNEL", "0")
    seeds = [100, 101, 102]
    want = _drive(RefScheduler(widen=True), _mixed(ref_hp), seeds, 12)
    sched = StudyScheduler(device="cpu", widen=True)
    got = _drive(sched, _mixed(hp), seeds, 12)
    assert all(c.widen for c in sched._cohorts.values())
    if name == "int8":
        assert {c.hist_dtype for c in sched._cohorts.values()} == {"int8"}
        assert all(v.dtype == torch.int8 for c in sched._cohorts.values()
                   for v in c._dev["vals"].values())
    for ws, gs in zip(want, got):
        assert len(ws) == len(gs) == 12
        for a, b in zip(ws, gs):
            assert a.keys() == b.keys()
            for k in a:
                assert len(a[k]) == len(b[k])
                np.testing.assert_allclose(b[k], a[k], rtol=RTOL, atol=ATOL, err_msg=k)
    assert got == _drive(StudyScheduler(device="cpu", widen=False), _mixed(hp), seeds, 12)


def test_widened_cohort_keeps_off_the_fused_route(monkeypatch):
    """A numeric space takes the fused kernel (its plain twin on the CPU)
    unwidened; widened it scores in grouped ``ei_diff`` and proposes as the
    unwidened cohort does with the fused route switched off, bit for bit."""
    fused_calls = []
    plain = megakernel.fused_sample_ei

    def counted(*a):
        fused_calls.append(1)
        return plain(*a)

    monkeypatch.setattr(megakernel, "fused_sample_ei", counted)
    space = {"lr": hp.loguniform("lr", -5, 0), "mom": hp.uniform("mom", 0, 1)}

    def drive(widen, knob):
        monkeypatch.setenv("HYPEROPT_TPU_MEGAKERNEL", knob)
        fused_calls.clear()
        sched = StudyScheduler(device="cpu", widen=widen)
        sid = sched.create_study(space, seed=7, n_startup_jobs=2)
        out = []
        for i in range(6):
            (t,) = sched.ask(sid)
            out.append(t["params"])
            sched.tell(sid, t["tid"], float(np.sin(i * 1.7)))
        return out, len(fused_calls)

    _, n_fused = drive(False, "1")
    assert n_fused > 0
    widened, n_fused = drive(True, "1")
    assert n_fused == 0
    assert widened == drive(False, "0")[0]


def test_compile_widen_flag(monkeypatch):
    monkeypatch.delenv("HYPEROPT_TPU_COMPILE_WIDEN", raising=False)
    assert parse_compile_widen() is False
    assert StudyScheduler(device="cpu").widen is False
    for raw in ("1", "on", "true", "yes"):
        monkeypatch.setenv("HYPEROPT_TPU_COMPILE_WIDEN", raw)
        assert parse_compile_widen() is True
    assert StudyScheduler(device="cpu").widen is True
    assert StudyScheduler(device="cpu", widen=False).widen is False
    monkeypatch.setenv("HYPEROPT_TPU_COMPILE_WIDEN", "0")
    assert StudyScheduler(device="cpu").widen is False
    # a conditional space keeps the exact-signature cohort under widen
    sched = StudyScheduler(device="cpu", widen=True)
    sid = sched.create_study(hp.choice("c", [{"u": hp.uniform("u", 0, 1)},
                                             {"v": hp.uniform("v", 2, 3)}]),
                             seed=0, n_startup_jobs=1)
    for _ in range(3):
        (t,) = sched.ask(sid)
        sched.tell(sid, t["tid"], 1.0)
    assert [c.widen for c in sched._cohorts.values()] == [False]
