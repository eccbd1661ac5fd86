"""Annealing, the mixture of suggesters and ``algobase.SuggestAlgo`` against
the JAX package's, on the same inputs: with the same ``rstate`` the
per-seed trial documents are the reference's.

Tolerance: the parity standard.  Discrete values (the anchor ranks and
categorical draws behind them) and the active sets compare bitwise,
floats at rtol 1e-5, atol 1e-6 (``exp`` differs from XLA's by up to an
ulp).
"""

import functools

import numpy as np
import pytest

import hyperopt_tpu as ref
from hyperopt_tpu import zoo as ref_zoo
from hyperopt_tpu.base import Domain as RefDomain
import hyperopt_tpu_torch as port
from hyperopt_tpu_torch import hp, zoo
from hyperopt_tpu_torch.algos import algobase, anneal
from hyperopt_tpu_torch.base import Domain

RTOL, ATOL = 1e-5, 1e-6


def _assert_same_docs(rdocs, pdocs):
    assert len(rdocs) == len(pdocs)
    for a, b in zip(rdocs, pdocs):
        assert a["tid"] == b["tid"]
        assert a["misc"]["idxs"] == b["misc"]["idxs"]
        va, vb = a["misc"]["vals"], b["misc"]["vals"]
        assert va.keys() == vb.keys()
        for k in va:
            assert len(va[k]) == len(vb[k]), (a["tid"], k)
            if any(isinstance(v, int) for v in va[k] + vb[k]):
                assert va[k] == vb[k], (a["tid"], k)
            np.testing.assert_allclose(vb[k], va[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"tid {a['tid']} {k}")


def _fmin_pair(name, algos, n, seed, space=None, objective=None, arm=None):
    """The same ``fmin`` through both packages; ``arm`` names an int8/fp8
    storage to arm on both histories before the first ask."""
    out = []
    for pkg, zmod in ((ref, ref_zoo), (port, zoo)):
        dom = zmod.ZOO[name] if name else None
        sp = space(pkg.hp) if space else dom.space
        trials = pkg.Trials(device="cpu") if pkg is port else pkg.Trials()
        if arm:
            cs = (Domain if pkg is port else RefDomain)(None, sp).cs
            trials.history_object(cs.labels).ensure_qparams(cs)
        pkg.fmin(objective or dom.objective, sp, algo=algos[pkg], max_evals=n, trials=trials,
                 rstate=np.random.default_rng(seed), show_progressbar=False)
        out.append(trials)
    return out


ANNEAL = {ref: ref.anneal.suggest, port: port.anneal.suggest}


@pytest.mark.parametrize("name,n", [("many_dists", 40), ("branin", 40), ("q1_choice", 30)])
def test_anneal_trial_stream_matches_reference(name, n):
    rt, pt = _fmin_pair(name, ANNEAL, n, seed=1)
    _assert_same_docs(rt.trials, pt.trials)


def _coded(h):
    return {"x": h.uniform("x", -5, 5), "lr": h.loguniform("lr", -4, 0),
            "k": h.randint("k", 4), "c": h.choice("c", [0, 1, 2])}


def _coded_obj(d):
    return (d["x"] - 1.0) ** 2 + d["lr"] + 0.1 * d["k"] + 0.05 * d["c"]


@pytest.mark.parametrize("name", ["int8", "bf16"])
def test_anneal_on_compressed_history_matches_reference(name, monkeypatch):
    """int8 codes (armed before the first ask) decode at the read boundary;
    a bf16 mirror passes as it is, its log-space anchors rounded to bf16
    as the reference computes them."""
    monkeypatch.setenv("HYPEROPT_TPU_HIST_DTYPE", name)
    rt, pt = _fmin_pair(None, ANNEAL, 40, seed=3, space=_coded, objective=_coded_obj,
                        arm=name if name == "int8" else None)
    ph = pt.history_object(Domain(None, _coded(hp)).cs.labels)
    want = {"int8": "int8", "bf16": "bfloat16"}[name]
    assert str(ph.device_view()["vals"]["x"].dtype).endswith(want)
    _assert_same_docs(rt.trials, pt.trials)


def test_first_ask_with_no_observation_matches_reference():
    """T == 0: every numeric label takes the prior's location, every
    discrete one the prior itself; 8 ids at once, on every hp family."""
    docs = []
    for pkg, zmod in ((ref, ref_zoo), (port, zoo)):
        space = zmod.ZOO["many_dists"].space
        trials = pkg.Trials(device="cpu") if pkg is port else pkg.Trials()
        domain = (Domain if pkg is port else RefDomain)(None, space)
        docs.append(pkg.anneal.suggest(list(range(8)), domain, trials, 12345))
    _assert_same_docs(*docs)


def test_suggest_algo_keys_startup_and_cache():
    """A seed past 32 bits folds its high word in; ``n_startup_jobs``
    delegates to ``rand.suggest``; a new ``Domain`` of the same space
    reuses the cached step."""
    def ask(pkg, zmod, seed, **kw):
        dom = zmod.ZOO["branin"]
        trials = pkg.Trials(device="cpu") if pkg is port else pkg.Trials()
        pkg.fmin(dom.objective, dom.space, algo=pkg.rand.suggest, max_evals=6, trials=trials,
                 rstate=np.random.default_rng(0), show_progressbar=False)
        domain = (Domain if pkg is port else RefDomain)(None, dom.space)
        return pkg.anneal.suggest([6, 7, 8], domain, trials, seed, **kw)

    for seed, kw in ((2**40 + 5, {}), (7, {"n_startup_jobs": 10})):
        _assert_same_docs(ask(ref, ref_zoo, seed, **kw), ask(port, zoo, seed, **kw))
    hits = algobase.SuggestAlgo._cache.stats()["hits"]
    ask(port, zoo, 3)
    assert algobase.SuggestAlgo._cache.stats()["hits"] == hits + 1
    tuned = anneal.AnnealSuggest(avg_best_idx=1.5, shrink_coef=0.2)
    assert tuned.cfg == {"avg_best_idx": 1.5, "shrink_coef": 0.2}


MIX = {pkg: functools.partial(pkg.mix.suggest, p_suggest=[
    (0.8, pkg.tpe.suggest), (0.1, pkg.anneal.suggest), (0.1, pkg.rand.suggest)])
    for pkg in (ref, port)}


def test_mix_trial_stream_matches_reference():
    """The branch draws are host numpy, bitwise; each branch then follows
    its reference."""
    rt, pt = _fmin_pair("branin", MIX, 40, seed=2)
    _assert_same_docs(rt.trials, pt.trials)
    with pytest.raises(ValueError, match="sum"):
        port.mix.suggest([0], None, None, 0, p_suggest=[(0.5, port.rand.suggest)])
