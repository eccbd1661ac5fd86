"""The ``lcbench`` configuration's objective: a stand-in surrogate over
LCBench's seven hyperparameters, a fixed 2-hidden-layer tanh network of
width 64 whose weights are drawn from ``numpy.random.default_rng(2006)``.
Each hyperparameter is scaled to [-1, 1] over its range (log scale for
the log ones) before the network reads it.

``fn`` is what the program is handed: one trial's assembled sample on
the host, in float64 numpy.  ``objective`` is its plain reference over
arrays of trials in float64 torch (``dtype`` lower for the control)."""

import functools
import math

import numpy as np
import torch

#: label -> (low, high, log scale) of the network's input scaling
SCALE = {
    "batch_size": (16.0, 512.0, True),
    "learning_rate": (1e-4, 1e-1, True),
    "momentum": (0.1, 0.99, False),
    "weight_decay": (1e-5, 1e-1, False),
    "num_layers": (1.0, 5.0, False),
    "max_units": (64.0, 1024.0, True),
    "max_dropout": (0.0, 1.0, False),
}


@functools.lru_cache(maxsize=1)
def weights(hidden=64):
    rng = np.random.default_rng(2006)
    W1 = rng.standard_normal((len(SCALE), hidden)) * 1.5
    b1 = rng.uniform(-1, 1, hidden)
    W2 = rng.standard_normal((hidden, hidden)) / math.sqrt(hidden)
    b2 = rng.uniform(-1, 1, hidden)
    w3 = rng.standard_normal(hidden) / math.sqrt(hidden)
    return W1, b1, W2, b2, w3


def _scaled(v, lo, hi, log, xp):
    if log:
        v, lo, hi = xp.log(v), math.log(lo), math.log(hi)
    return 2.0 * (v - lo) / (hi - lo) - 1.0


def fn(p):
    W1, b1, W2, b2, w3 = weights()
    x = np.array([_scaled(float(p[k]), *s, np) for k, s in SCALE.items()])
    h = np.tanh(np.tanh(x @ W1 + b1) @ W2 + b2)
    return float(h @ w3)


def objective(vals, dtype=torch.float64):
    W1, b1, W2, b2, w3 = (torch.as_tensor(a).to(dtype) for a in weights())
    x = torch.stack([_scaled(torch.as_tensor(np.asarray(vals[k], np.float64)).to(dtype), *s, torch)
                     for k, s in SCALE.items()], -1)
    h = torch.tanh(torch.tanh(x @ W1 + b1) @ W2 + b2)
    return (h @ w3).to(torch.float64).numpy()
