"""Analytic acquisition criteria (counterpart of
``hyperopt_tpu/criteria.py``; hyperopt/criteria.py sym: EI_empirical,
EI_gaussian, logEI_gaussian, UCB).  Standalone math that TPE does not
use, in float32 torch ops over tensors of any shape; ``erf`` is XLA's
float32 form (``tpe.erf``), as the JAX package's ``lax.erf`` computes it
on the CPU."""

from __future__ import annotations

import math

import numpy as np
import torch

from .algos.tpe import erf

__all__ = ["EI_empirical", "EI_gaussian", "logEI_gaussian", "UCB"]

_SQRT2 = float(np.float32(math.sqrt(2.0)))
_SQRT_2PI = float(np.float32(math.sqrt(2.0 * math.pi)))
_LOG_2PI = float(np.float32(math.log(2.0 * math.pi)))
_F32_TINY = float(np.finfo(np.float32).tiny)


def _t(x):
    return torch.as_tensor(x, dtype=torch.float32)


def EI_empirical(samples, thresh):
    """Expected improvement over ``thresh`` from empirical samples
    (criteria.py sym: EI_empirical)."""
    return torch.mean(torch.clamp(_t(samples) - thresh, min=0.0))


def _score_terms(mean, var, thresh):
    sigma = torch.sqrt(_t(var))
    score = (_t(mean) - thresh) / sigma
    n_cdf = 0.5 * (1.0 + erf(score / _SQRT2))
    n_pdf = torch.exp(-0.5 * score**2) / _SQRT_2PI
    return sigma, score, n_cdf, n_pdf


def EI_gaussian(mean, var, thresh):
    """Expected improvement over ``thresh`` for N(mean, var)
    (criteria.py sym: EI_gaussian)."""
    sigma, score, n_cdf, n_pdf = _score_terms(mean, var, thresh)
    return sigma * (score * n_cdf + n_pdf)


def logEI_gaussian(mean, var, thresh):
    """log(EI_gaussian), stable far into the tails: below a score of -10
    the Mills-ratio expansion ``EI ~ sigma * pdf(score) / score^2``
    (criteria.py sym: logEI_gaussian)."""
    sigma, score, n_cdf, n_pdf = _score_terms(mean, var, thresh)
    log_naive = torch.log(torch.clamp(sigma * (score * n_cdf + n_pdf), min=_F32_TINY))
    log_tail = (torch.log(sigma) - 0.5 * score**2 - 0.5 * _LOG_2PI
                - 2.0 * torch.log(torch.clamp(-score, min=1.0)))
    return torch.where(score < -10.0, log_tail, log_naive)


def UCB(mean, var, zscore):
    """Upper confidence bound (criteria.py sym: UCB)."""
    return _t(mean) + torch.sqrt(_t(var)) * zscore
