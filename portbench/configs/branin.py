"""The ``branin`` configuration's objective: Branin-Hoo, global minimum
0.397887.

``fn`` is what the program is handed: float32 torch ops on the assembled
sample, traceable, so the device loop evaluates it on the card inside
each step.  ``objective`` is its plain reference in float64 over arrays
of trials (``dtype`` lower for the control)."""

import math

import torch

B, C, T = 5.1 / (4.0 * math.pi ** 2), 5.0 / math.pi, 1.0 / (8.0 * math.pi)


def fn(p):
    x, y = p["x"], p["y"]
    return (y - B * x ** 2 + C * x - 6.0) ** 2 + 10.0 * (1.0 - T) * torch.cos(x) + 10.0


def objective(vals, dtype=torch.float64):
    x, y = (torch.as_tensor(vals[k], dtype=torch.float64).to(dtype) for k in ("x", "y"))
    out = (y - B * x ** 2 + C * x - 6.0) ** 2 + 10.0 * (1.0 - T) * torch.cos(x) + 10.0
    return out.to(torch.float64).numpy()
