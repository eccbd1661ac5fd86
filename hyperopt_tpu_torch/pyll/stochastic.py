"""``hyperopt.pyll.stochastic.sample(space, rng=None)`` on the port's sampler
(counterpart of ``hyperopt_tpu/pyll/stochastic.py``)."""

from __future__ import annotations

from .. import spaces

__all__ = ["sample"]


def sample(space, rng=None, device=None):
    """One structured draw from ``space``; runs on CUDA unless
    ``device="cpu"``."""
    return spaces.sample(space, rng, device)
