"""Simulated-annealing-flavored suggester (counterpart of
``hyperopt_tpu/algos/anneal.py``; defaults ``avg_best_idx=2.0``,
``shrink_coef=0.1``).

Each proposal anchors on a previously observed good trial: per label,
the trials where it was active and a loss was recorded are ranked by
loss, and the anchor's rank is drawn geometrically with mean
``avg_best_idx``.  The prior is then shrunk around the anchor by
``s(T) = 1 / (1 + T * shrink_coef)``, ``T`` the number of those
observations: uniform-family widths and normal-family sigmas scale by
``s``, and discrete posteriors mix ``(1-s)·onehot(anchor) + s·prior``.
With no observation ``s = 1`` and the proposal is a prior draw.

The ranking depends on the history only, so it runs once per label and
every id of an ask shares it; the draws are ``[B]`` per label.  The
float32 arithmetic follows the JAX package's program as XLA compiles it
on the CPU, read from its dump: ``log`` is XLA's (``tpe.xla_log``), the
division by the constant ``log(1 - p)`` and by a quantization step are
products with float32 reciprocals, and ``1 + T·c``, ``a - s·w/2``,
``u·width + lo`` and ``a + σs·z`` are fused multiply-adds
(``tpe._fma``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import prng
from ..spaces import label_hash
from ..utils import device_constant
from .algobase import SuggestAlgo
from .tpe import EPS, _fma, _parzen_from, _prior_probs, xla_log

__all__ = ["AnnealSuggest", "suggest"]

_default_avg_best_idx = 2.0
_default_shrink_coef = 0.1

_F32_MAX = float(np.finfo(np.float32).max)
_F32_TINY = float(np.finfo(np.float32).tiny)


def _f32(v):
    """The float32 value of the Python number ``v`` (a weakly typed
    constant in the JAX package's program)."""
    return float(np.float32(v))


def _recip(v):
    """The float32 reciprocal of float32 ``v``, as XLA folds a division by
    the constant ``v`` into a product."""
    return float(np.float32(1.0) / np.float32(v))


def _geometric_rank(keys, avg_best_idx, T):
    """Ranks ``[B]`` ~ Geometric with mean ``avg_best_idx``, clipped to
    ``[0, max(T-1, 0)]`` (``T`` a 0-d integer tensor)."""
    p = 1.0 / avg_best_idx
    u = prng.uniform(keys, (), EPS, 1.0)
    r = torch.floor(xla_log(u) * _recip(math.log(1.0 - p + 1e-12))).to(torch.int64)
    return torch.minimum(torch.clamp(r, min=0), torch.clamp(T - 1, min=0))


def _anchors(keys, obs, obs_mask, losses, avg_best_idx):
    """(anchor values ``[B]``, T): each id's geometrically ranked best
    observation; an arbitrary slot when T == 0.  The stable sort keeps
    insertion order among equal losses, as ``jnp.argsort`` does."""
    masked = torch.where(obs_mask, losses, device_constant(_F32_MAX, torch.float32,
                                                           losses.device))
    order = torch.argsort(masked, stable=True)
    T = obs_mask.sum()
    return obs[order[_geometric_rank(keys, avg_best_idx, T)]], T


def _shrink(T, shrink_coef):
    """``1 / (1 + T·shrink_coef)`` with the sum a fused multiply-add."""
    return 1.0 / _fma(T.to(torch.float32), _f32(shrink_coef), 1.0)


def _propose_discrete(keys, dist, vals, obs_mask, losses, cfg):
    ks = prng.split(keys)
    prior_p = _prior_probs(dist)
    K = prior_p.shape[0]
    offset = int(dist.params[0]) if dist.family == "randint" else 0
    a, T = _anchors(ks[:, 0], vals.to(torch.int32) - offset, obs_mask, losses,
                    cfg["avg_best_idx"])
    s = _shrink(T, cfg["shrink_coef"])
    onehot = a[:, None] == torch.arange(K, device=vals.device)
    prior = device_constant(prior_p.tolist(), torch.float32, vals.device)
    p = torch.where(onehot, 1.0 - s, torch.zeros_like(s)) + s * prior
    logp = torch.where(p > 0, xla_log(torch.clamp(p, min=_F32_TINY)),
                       torch.full_like(p, -math.inf))
    # jax.random.categorical: the argmax of logits plus low-mode Gumbel noise
    u = prng.uniform(ks[:, 1], (K,), _F32_TINY, 1.0)
    return torch.argmax(-xla_log(-xla_log(u)) + logp, dim=-1) + offset


def _propose_numeric(keys, dist, vals, obs_mask, losses, cfg):
    ks = prng.split(keys)
    prior_mu, prior_sigma, low, high, q, log_space = _parzen_from(dist)
    obs = vals
    if log_space:
        # a bf16 leaf's log rounds back to bf16, as the reference computes it
        obs = xla_log(torch.clamp(vals.to(torch.float32), min=EPS)).to(vals.dtype)
    a, T = _anchors(ks[:, 0], obs, obs_mask, losses, cfg["avg_best_idx"])
    s = _shrink(T, cfg["shrink_coef"])
    a = torch.where(T > 0, a, torch.full_like(a, prior_mu)).to(torch.float32)
    if math.isfinite(low) and math.isfinite(high):
        # a window of width (high-low)·s centered on the anchor, slid (not
        # clipped) to stay inside [low, high]
        span = _f32(high - low)
        width = s * span
        lo = _fma(s, -_f32(span * 0.5), a)
        lo = torch.minimum(torch.clamp(lo, min=_f32(low)), _f32(high) - width)
        x = _fma(prng.uniform(ks[:, 1], ()), width, lo)
    else:
        x = _fma(_f32(prior_sigma) * s, prng.normal(ks[:, 1], ()), a)
    if log_space:
        x = torch.exp(x)
    if q is not None:
        x = torch.round(x * _recip(q)) * _f32(q)
    return x


class AnnealSuggest(SuggestAlgo):
    """hyperopt/anneal.py sym: AnnealSuggest."""

    obs_name = "anneal"

    def __init__(self, avg_best_idx=_default_avg_best_idx,
                 shrink_coef=_default_shrink_coef):
        super().__init__(avg_best_idx=float(avg_best_idx), shrink_coef=float(shrink_coef))

    def build(self, cs, cfg):
        hashes = {l: label_hash(l) for l in cs.labels}

        def propose(history, keys):
            losses = history["losses"].to(torch.float32)
            has_loss = history["has_loss"]
            out = {}
            for label in cs.labels:
                dist = cs.params[label].dist
                k = prng.fold_in(keys, hashes[label])
                fn = (_propose_discrete if dist.family in ("categorical", "randint")
                      else _propose_numeric)
                out[label] = fn(k, dist, history["vals"][label],
                                history["active"][label] & has_loss, losses, cfg)
            return out

        return propose


suggest = AnnealSuggest()
