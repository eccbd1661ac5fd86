"""Benchmark domains (counterpart of ``hyperopt_tpu/zoo.py``): the ones the
port's main path and tests drive, with host (numpy) objectives.

``branin`` evaluates in float32 as the JAX package's jnp objective does,
so both report the same loss for the same point.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np

from . import hp

__all__ = ["DomainZoo", "ZOO", "branin"]


@dataclasses.dataclass(frozen=True)
class DomainZoo:
    name: str
    space: Any
    objective: Callable
    loss_target: float  # a loss an OK optimizer reaches within ~100 evals


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


def _hartmann6_host(x):
    """Hartmann6 in numpy; global min ≈ -3.32237."""
    alpha = np.array([1.0, 1.2, 3.0, 3.2])
    A = np.array([
        [10, 3, 17, 3.5, 1.7, 8],
        [0.05, 10, 17, 0.1, 8, 14],
        [3, 3.5, 1.7, 10, 17, 8],
        [17, 8, 0.05, 10, 0.1, 14],
    ])
    P = 1e-4 * np.array([
        [1312, 1696, 5569, 124, 8283, 5886],
        [2329, 4135, 8307, 3736, 1004, 9991],
        [2348, 1451, 3522, 2883, 3047, 6650],
        [4047, 8828, 8732, 5743, 1091, 381],
    ])
    inner = np.sum(A * (np.asarray(x) - P) ** 2, axis=1)
    return float(-np.sum(alpha * np.exp(-inner)))


def _quadratic1():
    return DomainZoo(
        name="quadratic1",
        space={"x": hp.uniform("x", -5, 5)},
        objective=lambda d: (d["x"] - 3.0) ** 2,
        loss_target=0.1,
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
    )


def _branin_domain():
    return DomainZoo(
        name="branin",
        space={"x": hp.uniform("x", -5, 10), "y": hp.uniform("y", 0, 15)},
        objective=lambda d: branin(d["x"], d["y"]),
        loss_target=0.9,
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
            return _hartmann6_host(d["xs"])
        xs = np.asarray(d["xs"]) * d["scale"]
        return float(np.sum(100.0 * (xs[1:] - xs[:-1] ** 2) ** 2 + (1.0 - xs[:-1]) ** 2))

    return DomainZoo(name="hr_conditional", space=space, objective=obj, loss_target=-1.0)


ZOO = {d.name: d for d in (_quadratic1(), _q1_choice(), _branin_domain(),
                           _hr_conditional())}
