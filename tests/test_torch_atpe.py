"""Adaptive TPE against the JAX package's: the featurizers and the
predictor give the reference's values, and aTPE's ``fmin`` follows the
reference's trial stream (its TPE asks at the predicted 32 candidates,
through the port's ``ei_diff``) with a bounded set of cached TPE steps.

Tolerance: features and predictions compare exactly (host numpy on the
same inputs); trial streams at the parity standard (integers bitwise,
floats rtol 1e-5, atol 1e-6).
"""

import numpy as np
import pytest

import hyperopt_tpu as ref
from hyperopt_tpu import zoo as ref_zoo
from hyperopt_tpu.algos import atpe as ref_atpe
from hyperopt_tpu.spaces import compile_space as ref_compile
import hyperopt_tpu_torch as port
from hyperopt_tpu_torch import hp, zoo
from hyperopt_tpu_torch.algos import atpe, tpe
from hyperopt_tpu_torch.base import Domain
from hyperopt_tpu_torch.spaces import compile_space

RTOL, ATOL = 1e-5, 1e-6


def _conditional(h):
    """``tests/test_atpe.py``'s conditional space."""
    return {"lr": h.loguniform("lr", -6, 0), "n": h.randint("n", 1, 9),
            "arch": h.choice("arch", [{"w": h.uniform("w", 0, 1)},
                                      {"d": h.qloguniform("d", 0, 3, 1)}])}


def test_featurize_space_equals_the_reference():
    cases = [(compile_space(zoo.ZOO[n].space), ref_compile(ref_zoo.ZOO[n].space))
             for n in zoo.ZOO]
    cases.append((compile_space(_conditional(hp)), ref_compile(_conditional(ref.hp))))
    for cs, rcs in cases:
        assert atpe.featurize_space(cs) == ref_atpe.featurize_space(rcs)


def test_featurize_trials_equals_the_reference():
    feats = []
    for pkg, zmod in ((ref, ref_zoo), (port, zoo)):
        dom = zmod.ZOO["quadratic1"]
        t = pkg.Trials(device="cpu") if pkg is port else pkg.Trials()
        pkg.fmin(dom.objective, dom.space, algo=pkg.rand.suggest, max_evals=20, trials=t,
                 rstate=np.random.default_rng(0), show_progressbar=False)
        t.trials[3]["result"] = {"status": "fail"}
        t.refresh()
        feats.append((pkg.atpe.featurize_trials(t), t.max_evals_hint))
    assert feats[0] == feats[1]
    assert feats[1][0]["budget"] == 20 and feats[1][0]["fail_frac"] == 0.05


def test_predict_equals_the_reference_on_a_feature_grid():
    """``tests/test_atpe.py``'s trajectory sweep of history features, across
    space shapes and budgets."""
    rng = np.random.default_rng(0)
    n_cases = 0
    for d in (1, 2, 6, 28):
        for frac_cond in (0.0, 0.5, 0.9):
            for frac_log in (0.0, 0.3, 1.0):
                sf = {"n_params": d, "n_conditional": int(d * frac_cond),
                      "frac_conditional": frac_cond, "frac_log": frac_log,
                      "frac_discrete": 0.0, "max_cond_depth": 0}
                for n in range(0, 400, 23):
                    for budget in (None, 25, 75, 1000):
                        tf = {"n_trials": n, "loss_spread": float(rng.uniform(0, 1)),
                              "recent_improvement": float(rng.uniform(0, 1)),
                              "fail_frac": 0.0, "budget": budget}
                        assert atpe.predict_tpe_params(sf, tf) == ref_atpe.predict_tpe_params(sf, tf)
                        n_cases += 1
    assert n_cases > 2000


@pytest.mark.parametrize("name", ["branin", "distractor"])
def test_atpe_fmin_follows_the_reference(name):
    """50 evaluations: the random startup (budget-capped at 10), then TPE
    asks at the predicted cfg; at most a few TPE steps are built."""
    before = tpe._propose_cache.stats()["size"]
    runs = []
    for pkg, zmod in ((ref, ref_zoo), (port, zoo)):
        dom = zmod.ZOO[name]
        t = pkg.Trials(device="cpu") if pkg is port else pkg.Trials()
        pkg.fmin(dom.objective, dom.space, algo=pkg.atpe.suggest, max_evals=50, trials=t,
                 rstate=np.random.default_rng(0), show_progressbar=False)
        runs.append(t)
    rt, pt = runs
    assert pt.max_evals_hint == 50
    assert len(rt.trials) == len(pt.trials) == 50
    for a, b in zip(rt.trials, pt.trials):
        va, vb = a["misc"]["vals"], b["misc"]["vals"]
        assert va.keys() == vb.keys()
        for k in va:
            np.testing.assert_allclose(vb[k], va[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"tid {a['tid']} {k}")
    rec = atpe.ATPEOptimizer().recommend(Domain(None, zoo.ZOO[name].space), pt)
    assert rec["n_EI_candidates"] == 32 and rec["n_startup_jobs"] == 10
    assert tpe._propose_cache.stats()["size"] - before <= 6


def test_optimizer_overrides_win():
    opt = atpe.ATPEOptimizer(n_EI_candidates=64, gamma=0.3)
    rec = opt.recommend(Domain(None, zoo.ZOO["branin"].space), port.Trials(device="cpu"))
    assert rec["n_EI_candidates"] == 64 and rec["gamma"] == 0.3
