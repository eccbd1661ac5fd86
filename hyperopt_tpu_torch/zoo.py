"""Benchmark domains (counterpart of ``hyperopt_tpu/zoo.py``): every domain
of the JAX package's zoo, in its order, with host objectives, and
``make_study_mix``, the standing multi-study workload.  The two ML
domains (``ml_logreg_cv``, ``ml_model_select_cv``) fit models by gradient
descent in torch ops, on the device their inputs live on (for host
numbers, ``utils.eval_device``: the trials' device, else the card).

The host objectives evaluate in float32 where the JAX package's jnp
objectives do on the host loop, so both report the same loss for the
same point to float32 rounding.  A domain's ``traceable`` is its
objective in torch ops on 0-d float32 tensors, the form the device loop
(``device_fmin``) evaluates on the card, or None where the JAX package's
objective is not traceable either; it also takes host numbers.  Its
constant tables are cached device constants, so a captured step makes no
copy from the host.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable

import numpy as np
import torch

from . import hp, prng
from .utils import device_constant, eval_device

__all__ = ["DomainZoo", "ZOO", "branin", "branin_torch", "hartmann6", "hartmann6_torch",
           "rosenbrock", "rosenbrock_torch", "ml_dataset", "ml_logreg_cv_loss",
           "ml_logreg_cv_objective", "ml_model_select_cv_objective", "StudyMixItem",
           "make_study_mix"]


@dataclasses.dataclass(frozen=True)
class DomainZoo:
    name: str
    space: Any
    objective: Callable
    loss_target: float  # a loss an OK optimizer reaches within ~100 evals
    traceable: Callable | None = None  # the objective in torch ops, or None
    optimum: float | None = None  # the known global minimum, where analytic


def _f32(v):
    """A 0-d float32 tensor of a host number; a float32 tensor as it is."""
    return torch.as_tensor(v, dtype=torch.float32)


def branin(x, y):
    """Branin-Hoo (BASELINE config #2); global min ≈ 0.397887."""
    a = 1.0
    b = 5.1 / (4.0 * math.pi**2)
    c = 5.0 / math.pi
    r = 6.0
    s = 10.0
    t = 1.0 / (8.0 * math.pi)
    f32 = np.float32
    return (f32(a * (y - b * x**2 + c * x - r) ** 2)
            + f32(s * (1 - t)) * np.cos(f32(x)) + f32(s))


def branin_torch(x, y):
    """:func:`branin` in float32 torch ops, as the JAX package's jnp
    ``branin`` computes it in the device loop."""
    a = 1.0
    b = 5.1 / (4.0 * math.pi**2)
    c = 5.0 / math.pi
    r = 6.0
    s = 10.0
    t = 1.0 / (8.0 * math.pi)
    x, y = _f32(x), _f32(y)
    return a * (y - b * x**2 + c * x - r) ** 2 + s * (1 - t) * torch.cos(x) + s


_H6_ALPHA = np.array([1.0, 1.2, 3.0, 3.2], np.float32)
_H6_A = np.array([
    [10, 3, 17, 3.5, 1.7, 8],
    [0.05, 10, 17, 0.1, 8, 14],
    [3, 3.5, 1.7, 10, 17, 8],
    [17, 8, 0.05, 10, 0.1, 14],
], np.float32)
_H6_P = (1e-4 * np.array([
    [1312, 1696, 5569, 124, 8283, 5886],
    [2329, 4135, 8307, 3736, 1004, 9991],
    [2348, 1451, 3522, 2883, 3047, 6650],
    [4047, 8828, 8732, 5743, 1091, 381],
])).astype(np.float32)


def hartmann6(x):
    """6-D Hartmann (BASELINE config #3); global min ≈ -3.32237."""
    inner = np.sum(_H6_A * (np.asarray(x, np.float32) - _H6_P) ** 2, axis=1)
    return float(-np.sum(_H6_ALPHA * np.exp(-inner)))


# the jnp objective's P: the float32 product 1e-4 x table, not a rounded
# float64 one
_H6_P_F32 = np.float32(1e-4) * np.array([
    [1312, 1696, 5569, 124, 8283, 5886],
    [2329, 4135, 8307, 3736, 1004, 9991],
    [2348, 1451, 3522, 2883, 3047, 6650],
    [4047, 8828, 8732, 5743, 1091, 381],
], np.float32)


def hartmann6_torch(x):
    """:func:`hartmann6` of ``x[6]`` in float32 torch ops, as the JAX
    package's jnp ``hartmann6`` computes it; the tables are cached
    constants on ``x``'s device."""
    alpha, A, P = (device_constant(a.tolist(), torch.float32, x.device)
                   for a in (_H6_ALPHA, _H6_A, _H6_P_F32))
    inner = torch.sum(A * (x - P) ** 2, dim=1)
    return -torch.sum(alpha * torch.exp(-inner))


def rosenbrock_torch(xs):
    """:func:`rosenbrock` of ``xs[n]`` in float32 torch ops."""
    return torch.sum(100.0 * (xs[1:] - xs[:-1] ** 2) ** 2 + (1.0 - xs[:-1]) ** 2)


def _stack(d, names):
    return torch.stack([_f32(d[n]) for n in names])


def rosenbrock(xs):
    xs = np.asarray(xs, np.float32)
    return float(np.sum(100.0 * (xs[1:] - xs[:-1] ** 2) ** 2 + (1.0 - xs[:-1]) ** 2,
                        dtype=np.float32))


def _quadratic1():
    return DomainZoo(
        name="quadratic1",
        space={"x": hp.uniform("x", -5, 5)},
        objective=lambda d: (d["x"] - 3.0) ** 2,
        loss_target=0.1,
        optimum=0.0,
        traceable=lambda d: (d["x"] - 3.0) ** 2,
    )


def _q1_lognormal():
    return DomainZoo(
        name="q1_lognormal",
        space={"x": hp.qlognormal("x", 0.0, 2.0, 1.0)},
        objective=lambda d: float(np.maximum(np.float32(-(d["x"] ** 2)), np.float32(-100.0))),
        loss_target=-9.0,
        optimum=-100.0,
        traceable=lambda d: torch.clamp(-(_f32(d["x"]) ** 2), min=-100.0),
    )


def _q1_choice():
    return DomainZoo(
        name="q1_choice",
        space=hp.choice(
            "case",
            [{"x": hp.uniform("x1", -5, 5)}, {"x": hp.uniform("x2", -10, -3)}],
        ),
        objective=lambda d: (d["x"] + 2.0) ** 2,
        loss_target=0.5,
        optimum=0.0,
    )


def _n_arms(n=2):
    return DomainZoo(
        name="n_arms",
        space=hp.choice("arm", list(range(n))),
        objective=lambda arm: 0.0 if arm == 0 else 1.0,
        loss_target=0.0,
        optimum=0.0,
    )


def _distractor():
    """A deep narrow global minimum at x=3 beside a wide shallow basin at
    x=-3."""

    def obj(d):
        x = d["x"]
        return -math.exp(-((x - 3.0) ** 2)) - 1.2 * math.exp(-0.05 * (x + 3.0) ** 2)

    return DomainZoo(
        name="distractor",
        space={"x": hp.uniform("x", -15, 15)},
        objective=obj,
        loss_target=-1.1,
    )


def _gauss_wave():
    """A sinusoid under a Gaussian envelope (hyperopt/tests/test_domains.py
    sym: gauss_wave): a smooth global basin with high-frequency ripple."""

    def obj(d):
        x = d["x"]
        return -math.exp(-((x / 8.0) ** 2)) * math.cos(x)

    return DomainZoo(
        name="gauss_wave",
        space={"x": hp.uniform("x", -20, 20)},
        objective=obj,
        loss_target=-0.8,
        optimum=-1.0,
    )


def _gauss_wave2():
    def obj(d):
        x = d["x"]
        t = d["hf"]
        return math.sin(x) * (1.0 if t == "sin" else 0.0) + 0.1 * x**2

    return DomainZoo(
        name="gauss_wave2",
        space={
            "x": hp.uniform("x", -20, 20),
            "hf": hp.choice("hf", ["sin", "flat"]),
        },
        objective=obj,
        loss_target=0.0,
    )


def _branin_domain():
    return DomainZoo(
        name="branin",
        space={"x": hp.uniform("x", -5, 10), "y": hp.uniform("y", 0, 15)},
        objective=lambda d: branin(d["x"], d["y"]),
        loss_target=0.9,
        optimum=0.397887,
        traceable=lambda d: branin_torch(d["x"], d["y"]),
    )


def _hr_conditional():
    """BASELINE config #3: ``hp.choice`` between Hartmann6 (6 uniform dims)
    and a 20-D Rosenbrock scaled by an ``hp.loguniform`` — 28 labels."""
    space = hp.choice(
        "family",
        [
            {"kind": "hartmann", "xs": [hp.uniform(f"h{i}", 0, 1) for i in range(6)]},
            {
                "kind": "rosen",
                "xs": [hp.uniform(f"r{i}", -2, 2) for i in range(20)],
                "scale": hp.loguniform("r_scale", -3, 1),
            },
        ],
    )

    def obj(d):
        if d["kind"] == "hartmann":
            return hartmann6(d["xs"])
        xs = np.asarray(d["xs"]) * d["scale"]
        return float(np.sum(100.0 * (xs[1:] - xs[:-1] ** 2) ** 2 + (1.0 - xs[:-1]) ** 2))

    return DomainZoo(name="hr_conditional", space=space, objective=obj, loss_target=-1.0)


def _hartmann6_domain():
    return DomainZoo(
        name="hartmann6",
        space={f"x{i}": hp.uniform(f"x{i}", 0, 1) for i in range(6)},
        objective=lambda d: hartmann6([d[f"x{i}"] for i in range(6)]),
        loss_target=-2.0,
        optimum=-3.32237,
        traceable=lambda d: hartmann6_torch(_stack(d, [f"x{i}" for i in range(6)])),
    )


def _rosenbrock4():
    return DomainZoo(
        name="rosenbrock4",
        space={f"x{i}": hp.uniform(f"x{i}", -2, 2) for i in range(4)},
        objective=lambda d: rosenbrock([d[f"x{i}"] for i in range(4)]),
        loss_target=30.0,
        optimum=0.0,
        traceable=lambda d: rosenbrock_torch(_stack(d, [f"x{i}" for i in range(4)])),
    )


def _many_dists():
    """One of every ``hp.*`` family, a nested choice among them
    (hyperopt/tests/test_domains.py sym: many_dists)."""
    space = {
        "a": hp.choice("a", [0, 1, 2]),
        "b": hp.randint("b", 10),
        "c": hp.uniform("c", 4, 7),
        "d": hp.loguniform("d", -2, 0),
        "e": hp.quniform("e", 0, 10, 3),
        "f": hp.qloguniform("f", 0, 3, 2),
        "g": hp.normal("g", 4, 7),
        "h": hp.lognormal("h", -2, 2),
        "i": hp.qnormal("i", 0, 10, 2),
        "j": hp.qlognormal("j", 0, 2, 1),
        "k": hp.pchoice("k", [(0.1, 0), (0.9, 1)]),
        "z": hp.choice(
            "z", [{"m": hp.uniform("m", -1, 1)}, {"n": hp.uniformint("n", 1, 5)}]
        ),
    }

    def obj(d):
        z = d["z"]
        zv = z.get("m", 0.0) + z.get("n", 0)
        return (
            abs(d["c"] - 5.0)
            + 0.1 * abs(d["g"])
            + 0.01 * (d["a"] + d["b"] + d["e"] + d["k"])
            + 0.001 * (d["d"] + d["f"] + d["h"] + d["i"] + abs(d["j"]) + zv)
        )

    return DomainZoo(name="many_dists", space=space, objective=obj, loss_target=2.5)


@functools.lru_cache(maxsize=1)
def _hpob_weights(hidden=64):
    """The surrogate's fixed 2-hidden-layer tanh network, drawn from
    ``np.random.default_rng(77)`` in the JAX package's order."""
    rng = np.random.default_rng(77)
    fdim = 9  # 5 numeric features in [0, 1] + a 4-way one-hot
    W1 = rng.standard_normal((fdim, hidden)).astype(np.float32) * 1.8
    b1 = rng.uniform(-1, 1, hidden).astype(np.float32)
    W2 = rng.standard_normal((hidden, hidden)).astype(np.float32) / np.sqrt(hidden)
    b2 = rng.uniform(-1, 1, hidden).astype(np.float32)
    w3 = rng.standard_normal(hidden).astype(np.float32) / np.sqrt(hidden)
    return W1, b1, W2, b2, w3


def _hpob_surrogate():
    """HPO-B-style tabular surrogate (BASELINE config #5): a seeded random
    MLP over a mixed ML search space (log-scaled learning rate and weight
    decay, quantized dropout, momentum, integer depth, a 4-way optimizer
    choice).  Its q-label and choice keep it off the fused kernel."""

    def obj(d):
        W1, b1, W2, b2, w3 = _hpob_weights()
        f32 = np.float32
        feats = [(np.log(f32(d["lr"])) + f32(9.2)) / f32(9.2),
                 (np.log(f32(d["weight_decay"])) + f32(13.8)) / f32(13.8),
                 f32(d["dropout"]) / f32(0.9),
                 f32(d["momentum"]),
                 (f32(d["depth"]) - f32(1.0)) / f32(7.0)]
        onehot = (int(d["optimizer"]) == np.arange(4)).astype(np.float32)
        x = np.concatenate([np.asarray(feats, np.float32), onehot])
        h = np.tanh(x @ W1 + b1)
        h = np.tanh(h @ W2 + b2)
        return float(np.dot(h, w3))

    space = {
        "lr": hp.loguniform("lr", math.log(1e-4), 0.0),
        "weight_decay": hp.loguniform("weight_decay", math.log(1e-6), 0.0),
        "dropout": hp.quniform("dropout", 0.0, 0.9, 0.1),
        "momentum": hp.uniform("momentum", 0.0, 1.0),
        "depth": hp.uniformint("depth", 1, 8),
        "optimizer": hp.choice("optimizer", [0, 1, 2, 3]),
    }
    return DomainZoo(name="hpob_surrogate", space=space, objective=obj, loss_target=-0.55)


_ML_N, _ML_DIM, _ML_FOLDS, _ML_STEPS, _ML_HIDDEN = 512, 16, 4, 120, 32


@functools.lru_cache(maxsize=1)
def ml_dataset():
    """The synthetic binary-classification task the ML domains share:
    ``default_rng(42)``, 512 rows of 16 features with label noise, split
    into 4 folds; ``(X [4, 128, 16], y [4, 128])`` float32 numpy arrays,
    the JAX package's ``_ml_data()`` bit for bit."""
    n, dim, folds = _ML_N, _ML_DIM, _ML_FOLDS
    rng = np.random.default_rng(42)
    w_true = rng.standard_normal(dim).astype(np.float32)
    X = rng.standard_normal((n, dim)).astype(np.float32)
    margin = X @ w_true / np.sqrt(dim)
    y = (margin + 0.6 * rng.standard_normal(n) > 0).astype(np.float32)
    return X.reshape(folds, n // folds, dim), y.reshape(folds, n // folds)


@functools.lru_cache(maxsize=None)
def _ml_folds(device):
    """The folds stacked on a leading axis, on ``device``: training rows
    ``[4, 384, 16]`` and signs ``2y - 1`` ``[4, 384]`` (the other three
    folds, in order), validation rows ``[4, 128, 16]`` and signs
    ``[4, 128]``.  Made once per device and kept, so a captured step only
    reads them."""
    X, y = ml_dataset()
    rest = [[j for j in range(_ML_FOLDS) if j != i] for i in range(_ML_FOLDS)]
    tr_x = np.stack([np.concatenate([X[j] for j in r]) for r in rest])
    tr_s = np.stack([2.0 * np.concatenate([y[j] for j in r]) - 1.0 for r in rest])
    return tuple(torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)
                 for a in (tr_x, tr_s, X, 2.0 * y - 1.0))


@functools.lru_cache(maxsize=None)
def _mlp_normals(device):
    """The MLP's unscaled initial weights, ``jax.random.normal`` on the two
    halves of ``split(PRNGKey(7))``: ``[16, 32]`` and ``[32]``."""
    k1, k2 = prng.split(prng.PRNGKey(7, device=device))
    return prng.normal(k1, (_ML_DIM, _ML_HIDDEN)), prng.normal(k2, (_ML_HIDDEN,))


def _ml_args(*vals):
    """The hyperparameters as float32 tensors and the device the fit runs
    on: the tensors' own device, or for host numbers ``utils.eval_device``
    (the trials' device inside ``Domain.evaluate``, else the card)."""
    dev = next((v.device for v in vals if torch.is_tensor(v)), None)
    if dev is None:
        dev = eval_device()
    return [torch.as_tensor(v, dtype=torch.float32, device=dev) for v in vals], dev


def _nll(z, s):
    """Mean logistic loss of margins ``z`` against signs ``s``, per fold
    (the last axis is the rows)."""
    return torch.mean(torch.log1p(torch.exp(-s * z)), dim=-1)


def _sumsq(p):
    """Per fold: the sum of squares of a ``[4, ...]`` parameter."""
    return torch.sum((p ** 2).reshape(p.shape[0], -1), dim=1)


def _linear_forward(p, X):
    w, b = p
    return torch.matmul(X, w.unsqueeze(-1)).squeeze(-1) + b.unsqueeze(-1)


def _mlp_forward(p, X):
    W1, b1, W2, b2 = p
    h = torch.tanh(torch.matmul(X, W1) + b1.unsqueeze(1))
    return torch.matmul(h, W2.unsqueeze(-1)).squeeze(-1) + b2.unsqueeze(-1)


def _folds_grad(forward, l2, folds, n_reg):
    """The gradient of every fold's training loss, L2-regularized on its
    first ``n_reg`` parameters, with respect to its own parameters
    (``torch.func.grad`` of their sum: the folds share no parameter, so
    each fold's gradient is its loss's own)."""
    tr_x, tr_s = folds[0], folds[1]

    def loss_fn(params):
        reg = sum(_sumsq(p) for p in params[:n_reg])
        return torch.sum(_nll(forward(params, tr_x), tr_s) + l2 * reg)

    return torch.func.grad(loss_fn)


def _logreg_cv(lr, l2, mom, dev):
    """4-fold CV log-loss of L2 logistic regression, 120 momentum steps;
    the four folds train side by side on the leading axis."""
    folds = _ml_folds(dev)
    grad = _folds_grad(_linear_forward, l2, folds, n_reg=1)  # the bias is not penalized
    params = (torch.zeros(_ML_FOLDS, _ML_DIM, device=dev), torch.zeros(_ML_FOLDS, device=dev))
    vel = tuple(torch.zeros_like(p) for p in params)
    for _ in range(_ML_STEPS):
        g = grad(params)
        vel = tuple(mom * v - lr * gg for v, gg in zip(vel, g))
        params = tuple(p + v for p, v in zip(params, vel))
    return torch.mean(_nll(_linear_forward(params, folds[2]), folds[3]))


def _gd_cv(params, forward, lr, l2, dev):
    """4-fold CV log-loss of ``forward`` from ``params`` (``[4, ...]``), 120
    plain gradient-descent steps."""
    folds = _ml_folds(dev)
    grad = _folds_grad(forward, l2, folds, n_reg=len(params))
    for _ in range(_ML_STEPS):
        g = grad(params)
        params = tuple(p - lr * gg for p, gg in zip(params, g))
    return torch.mean(_nll(forward(params, folds[2]), folds[3]))


def ml_logreg_cv_loss(lr, l2, momentum):
    """4-fold cross-validated logistic regression on :func:`ml_dataset`:
    each fold 120 float32 steps of gradient descent with momentum (a Python
    loop over ``torch.func.grad``), the mean validation log-loss, 50.0 for
    a diverged fit.  Host numbers or 0-d float32 tensors."""
    (lr, l2, mom), dev = _ml_args(lr, l2, momentum)
    loss = _logreg_cv(lr, l2, mom, dev)
    # a diverged fit (weights blown up to inf/NaN) is a finite, terrible
    # loss: NaN would fail the trial instead of teaching TPE the region is
    # bad.  50 is ~100x the task's tuned CV logloss.
    return torch.where(torch.isfinite(loss), loss, device_constant(50.0, torch.float32, dev))


def _cv_logreg(lr, l2, dev):
    p0 = (torch.zeros(_ML_FOLDS, _ML_DIM, device=dev), torch.zeros(_ML_FOLDS, device=dev))
    return _gd_cv(p0, _linear_forward, lr, l2, dev)


def _mlp_init(w_scale, dev):
    """The MLP's initial ``(W1, b1, W2, b2)``: the JAX package's
    ``w_scale * normal / sqrt(fan_in)`` on ``PRNGKey(7)``, bit for bit."""
    n1, n2 = _mlp_normals(dev)
    return (w_scale * n1 / math.sqrt(_ML_DIM), torch.zeros(_ML_HIDDEN, device=dev),
            w_scale * n2 / math.sqrt(_ML_HIDDEN), torch.zeros((), device=dev))


def _cv_mlp(lr, l2, w_scale, dev):
    p0 = tuple(p.expand(_ML_FOLDS, *p.shape) for p in _mlp_init(w_scale, dev))
    return _gd_cv(p0, _mlp_forward, lr, l2, dev)


def ml_logreg_cv_objective(d):
    """The ``ml_logreg_cv`` objective on an assembled point."""
    return ml_logreg_cv_loss(d["lr"], d["l2"], d["momentum"])


def ml_model_select_cv_objective(d):
    """The ``ml_model_select_cv`` objective: an L2 logistic regression
    (``m == 0``) or a 16→32→1 tanh MLP (``m == 1``), each 4-fold
    cross-validated by 120 plain gradient-descent steps.  A host point
    (``m`` an int) fits only its family; a traced point (``m`` a tensor)
    fits both and selects, so nothing is read back to the host.  As in the
    JAX package, a diverged fit is not replaced here: its loss is not
    finite."""
    m = d.get("m")
    if isinstance(m, int):
        if m == 0:
            (lr, l2), dev = _ml_args(d["lr_lin"], d["l2_lin"])
            return _cv_logreg(lr, l2, dev)
        (lr, l2, ws), dev = _ml_args(d["lr_mlp"], d["l2_mlp"], d["w_scale"])
        return _cv_mlp(lr, l2, ws, dev)
    (lr0, l20, lr1, l21, ws), dev = _ml_args(d["lr_lin"], d["l2_lin"], d["lr_mlp"],
                                             d["l2_mlp"], d["w_scale"])
    loss_lin = _cv_logreg(lr0, l20, dev)
    loss_mlp = _cv_mlp(lr1, l21, ws, dev)
    return torch.where(m == 0, loss_lin, loss_mlp)


def _ml_logreg_cv():
    """A real machine-learning objective (BASELINE config #4 analog):
    learning rate (log), L2 (log) and momentum of a 4-fold cross-validated
    logistic regression; lr too high diverges, L2 too high underfits."""
    return DomainZoo(
        name="ml_logreg_cv",
        space={
            "lr": hp.loguniform("lr", math.log(1e-4), math.log(10.0)),
            "l2": hp.loguniform("l2", math.log(1e-6), math.log(1.0)),
            "momentum": hp.uniform("momentum", 0.0, 0.98),
        },
        objective=ml_logreg_cv_objective,
        loss_target=0.45,  # a well-tuned CV logloss on this task
        traceable=ml_logreg_cv_objective,
    )


def _ml_model_select_cv():
    """Model-family selection (BASELINE config #4, full shape): ``hp.choice``
    between an L2 logistic regression and a one-hidden-layer MLP, with
    per-family hyperparameters, on :func:`ml_dataset`."""
    space = hp.choice("model", [
        {"m": 0,
         "lr_lin": hp.loguniform("lr_lin", math.log(1e-4), math.log(10.0)),
         "l2_lin": hp.loguniform("l2_lin", math.log(1e-6), math.log(1.0))},
        {"m": 1,
         "lr_mlp": hp.loguniform("lr_mlp", math.log(1e-4), math.log(1.0)),
         "l2_mlp": hp.loguniform("l2_mlp", math.log(1e-6), math.log(1.0)),
         "w_scale": hp.loguniform("w_scale", math.log(0.1), math.log(3.0))},
    ])
    return DomainZoo(name="ml_model_select_cv", space=space,
                     objective=ml_model_select_cv_objective, loss_target=0.45,
                     traceable=ml_model_select_cv_objective)


# the JAX package's ZOO order
ZOO = {d.name: d for d in (_quadratic1(), _q1_lognormal(), _q1_choice(), _n_arms(),
                           _distractor(), _gauss_wave(), _gauss_wave2(), _branin_domain(),
                           _hartmann6_domain(), _rosenbrock4(), _many_dists(),
                           _hr_conditional(), _ml_logreg_cv(), _hpob_surrogate())}
ZOO["ml_model_select_cv"] = _ml_model_select_cv()


@dataclasses.dataclass(frozen=True)
class StudyMixItem:
    """One study of the standing multi-study workload: a zoo domain plus
    its serving parameters (seed, budget, startup count)."""

    name: str
    domain: DomainZoo
    seed: int
    budget: int
    n_startup_jobs: int


# heterogeneous spaces (1-D, 2-D, 6-D, 4-D uniform and the mixed HPO-B
# surrogate), so a mix always exercises several cohorts at once
_MIX_DOMAINS = ("quadratic1", "branin", "hartmann6", "rosenbrock4", "hpob_surrogate")
_MIX_BUDGETS = (20, 30, 40, 60, 80)


def make_study_mix(n, seed0=0):
    """``n`` heterogeneous studies cycling through the mix domains with
    varied budgets and per-study seeds; deterministic in ``(n, seed0)``
    and the same workload as the JAX package's ``make_study_mix``."""
    mix = []
    for i in range(int(n)):
        dom = ZOO[_MIX_DOMAINS[i % len(_MIX_DOMAINS)]]
        mix.append(StudyMixItem(
            name=f"{dom.name}#{i}",
            domain=dom,
            seed=int(seed0) + i,
            budget=_MIX_BUDGETS[(i // len(_MIX_DOMAINS)) % len(_MIX_BUDGETS)],
            n_startup_jobs=5,
        ))
    return mix
