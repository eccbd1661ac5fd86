"""The ML zoo domains against the JAX package's: the dataset and the MLP's
initial weights bit for bit, both objectives at seeded points (a diverged
fit included) and over a vmapped batch, a TPE trial stream on
``ml_logreg_cv`` and the device loop over ``ml_model_select_cv``, all at
the parity standard (rtol 1e-5, atol 1e-6) on the CPU."""

import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hyperopt_tpu as ref
from hyperopt_tpu import base as ref_base, zoo as ref_zoo
import hyperopt_tpu_torch as port
from hyperopt_tpu_torch import zoo
from hyperopt_tpu_torch.base import Domain
from hyperopt_tpu_torch.utils import evaluation_device

RTOL, ATOL = 1e-5, 1e-6

# the domains' bounds (the stable region is well inside them)
_LOG_BOUNDS = {"lr": (1e-4, 10.0), "l2": (1e-6, 1.0), "lr_lin": (1e-4, 10.0),
               "l2_lin": (1e-6, 1.0), "lr_mlp": (1e-4, 1.0), "l2_mlp": (1e-6, 1.0),
               "w_scale": (0.1, 3.0)}


def _draw(rng, label, hi_lr=3.0):
    if label == "momentum":
        return float(rng.uniform(0.0, 0.98))
    lo, hi = _LOG_BOUNDS[label]
    if label in ("lr", "lr_lin"):
        hi = hi_lr
    return float(np.exp(rng.uniform(math.log(lo), math.log(hi))))


def _points(name, n=8, seed=0):
    """``n`` seeded host points; the last one has a learning rate and an
    L2 strong enough that gradient descent blows the weights up."""
    rng = np.random.default_rng(seed)
    pts = []
    for i in range(n - 1):
        if name == "ml_logreg_cv":
            pts.append({l: _draw(rng, l) for l in ("lr", "l2", "momentum")})
        elif i % 2 == 0:
            pts.append({"m": 0, **{l: _draw(rng, l) for l in ("lr_lin", "l2_lin")}})
        else:
            pts.append({"m": 1, **{l: _draw(rng, l) for l in ("lr_mlp", "l2_mlp", "w_scale")}})
    if name == "ml_logreg_cv":
        pts.append({"lr": 9.5, "l2": 0.5, "momentum": 0.9})
    else:
        pts.append({"m": 0, "lr_lin": 9.5, "l2_lin": 0.5})
    return pts


def test_dataset_is_bitwise_the_reference():
    X, y = zoo.ml_dataset()
    rX, ry = ref_zoo._ml_data()
    assert X.dtype == np.float32 and X.shape == (4, 128, 16) and y.shape == (4, 128)
    np.testing.assert_array_equal(X, rX)
    np.testing.assert_array_equal(y, ry)


@pytest.mark.parametrize("w_scale", [0.1, 0.73, 2.9])
def test_mlp_initial_weights_are_bitwise_the_reference(w_scale):
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    want = (w_scale * jax.random.normal(k1, (16, 32)) / jnp.sqrt(16),
            w_scale * jax.random.normal(k2, (32,)) / jnp.sqrt(32))
    got = zoo._mlp_init(torch.tensor(w_scale, dtype=torch.float32), "cpu")
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("name", ["ml_logreg_cv", "ml_model_select_cv"])
def test_objective_matches_reference_at_seeded_points(name):
    """The port's host path (Python numbers) against the reference's host
    path, jitted once per family with the family index ``m`` left a Python
    int, so the reference takes its host branch and compiles once."""
    pts = _points(name)
    rfn = ref_zoo.ZOO[name].objective
    with evaluation_device("cpu"):
        got = [float(zoo.ZOO[name].objective(p)) for p in pts]
    jitted = {}
    want = []
    for p in pts:
        m = p.get("m")
        if m not in jitted:
            jitted[m] = jax.jit(lambda d, m=m: rfn(d if m is None else {**d, "m": m}))
        want.append(float(jitted[m]({k: v for k, v in p.items() if k != "m"})))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if name == "ml_logreg_cv":
        assert got[-1] == want[-1] == 50.0  # a diverged fit, in both packages
        assert all(g < 1.0 for g in got[:-1])
    else:  # the reference leaves a diverged family fit non-finite
        assert not np.isfinite(got[-1]) and not np.isfinite(want[-1])


def test_host_numbers_fit_on_the_evaluation_device():
    with evaluation_device("meta"):
        out = zoo.ml_logreg_cv_loss(0.1, 1e-3, 0.5)
    assert out.device.type == "meta" and out.dim() == 0
    t = torch.tensor(0.1)  # tensors keep their own device
    with evaluation_device("meta"):
        assert zoo.ml_logreg_cv_loss(t, 1e-3, 0.5).device.type == "cpu"


@pytest.mark.parametrize("name", ["ml_logreg_cv", "ml_model_select_cv"])
def test_batch_eval_matches_reference_vmap(name):
    rng = np.random.default_rng(3)
    pd = Domain(zoo.ZOO[name].traceable, zoo.ZOO[name].space)
    rd = ref_base.Domain(ref_zoo.ZOO[name].objective, ref_zoo.ZOO[name].space)
    flat = {}
    for l in pd.cs.labels:
        if pd.cs.params[l].is_int:
            flat[l] = rng.integers(0, 2, 16).astype(np.int32)
        else:
            flat[l] = np.asarray([_draw(rng, l) for _ in range(16)], np.float32)
    want = np.asarray(rd.make_batch_eval()({k: jnp.asarray(v) for k, v in flat.items()}))
    got = pd.make_batch_eval()({k: torch.from_numpy(v) for k, v in flat.items()})
    assert got.shape == (16,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def _assert_same_docs(rt, pt):
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


def test_tpe_trial_stream_on_logreg_matches_reference():
    """30 evaluations: 20 prior draws, then 10 TPE asks over CV losses.
    The reference's objective runs jitted (its traced path, which its
    device loop and batch evaluation take too), so it compiles once."""
    rdom, pdom = ref_zoo.ZOO["ml_logreg_cv"], zoo.ZOO["ml_logreg_cv"]
    rt, pt = ref.Trials(), port.Trials(device="cpu")
    ref.fmin(jax.jit(rdom.objective), rdom.space, algo=ref.tpe.suggest, max_evals=30,
             trials=rt, rstate=np.random.default_rng(5), show_progressbar=False)
    port.fmin(pdom.objective, pdom.space, algo=port.tpe.suggest, max_evals=30, trials=pt,
              rstate=np.random.default_rng(5), show_progressbar=False)
    _assert_same_docs(rt, pt)


def test_device_loop_on_model_select_matches_reference():
    """The reference's ``test_device_loop_conditional_space_and_partial_tuning``
    configuration, held against the port: 40 evaluations, the same trial
    stream, and the inactive family's parameters empty in the docs."""
    out = []
    for pkg, zmod, fn in ((ref, ref_zoo, "objective"), (port, zoo, "traceable")):
        dom = zmod.ZOO["ml_model_select_cv"]
        t = pkg.Trials(device="cpu") if pkg is port else pkg.Trials()
        algo = functools.partial(pkg.tpe.suggest, n_EI_candidates=32, gamma=0.5)
        pkg.fmin(getattr(dom, fn), dom.space, algo=algo, max_evals=40, trials=t,
                 rstate=np.random.default_rng(0), show_progressbar=False, device_loop=True)
        out.append(t)
    rt, pt = out
    assert len(pt) == 40
    _assert_same_docs(rt, pt)
    doc = pt.best_trial
    m = doc["misc"]["vals"]["model"][0]
    inactive = "lr_mlp" if m == 0 else "lr_lin"
    assert doc["misc"]["vals"][inactive] == []
