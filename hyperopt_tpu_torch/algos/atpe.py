"""Adaptive TPE (counterpart of ``hyperopt_tpu/algos/atpe.py``): per ask,
featurize the space and the history, predict TPE's hyper-hyperparameters,
and delegate to ``tpe.suggest`` with the prediction.

The upstream aTPE drives pre-trained lightgbm models; the JAX package
replaces them with an analytic predictor whose rules encode the same
relationships (gamma up when the landscape looks flat, more EI
candidates with more dimensions, a forgetting window tied to history
length), and this module carries that predictor unchanged: host numpy on
the space's parameter table and the trials' losses.  Every output is
bucketed, so a run builds only a few TPE proposal steps
(``tpe._get_propose`` caches them per (space, cfg)).
"""

from __future__ import annotations

import math

import numpy as np

from . import tpe

__all__ = [
    "featurize_space",
    "featurize_trials",
    "predict_tpe_params",
    "suggest",
    "ATPEOptimizer",
]

_LOG_FAMILIES = {"loguniform", "qloguniform", "lognormal", "qlognormal"}
_DISCRETE_FAMILIES = {"categorical", "randint", "uniformint"}


def featurize_space(cs):
    """Search-space features (atpe.py sym: Hyperparameter feature extraction).

    All derivable from the static param table — the analog of what the
    reference computes from ``expr_to_config``.
    """
    infos = list(cs.params.values())
    n = len(infos)
    n_cond = sum(1 for i in infos if i.conditions)
    return {
        "n_params": n,
        "n_conditional": n_cond,
        "frac_conditional": n_cond / max(n, 1),
        "frac_log": sum(1 for i in infos if i.dist.family in _LOG_FAMILIES) / max(n, 1),
        "frac_discrete": sum(
            1 for i in infos if i.dist.family in _DISCRETE_FAMILIES
        ) / max(n, 1),
        "max_cond_depth": max((len(i.conditions) for i in infos), default=0),
    }


def featurize_trials(trials):
    """History features: size, spread and recent-progress signals — plus the
    total eval budget when ``fmin`` surfaced one (it sets
    ``trials.max_evals_hint``; the suggest protocol has no budget
    argument)."""
    losses = np.asarray(
        [l for l in trials.losses() if l is not None], dtype=np.float64
    )
    n = len(losses)
    feats = {"n_trials": n, "loss_spread": 0.0, "recent_improvement": 1.0,
             "fail_frac": 0.0,
             "budget": getattr(trials, "max_evals_hint", None)}
    statuses = trials.statuses()
    if statuses:
        feats["fail_frac"] = sum(1 for s in statuses if s == "fail") / len(statuses)
    if n >= 4:
        lo, hi = np.min(losses), np.max(losses)
        med = np.median(losses)
        # spread of the bulk relative to the best–median gap: ~0 on a flat
        # landscape (every trial similar), large when the best stand out
        feats["loss_spread"] = float((med - lo) / (hi - lo + 1e-12))
        half = n // 2
        best_old = np.min(losses[:half])
        best_new = np.min(losses[half:])
        denom = abs(best_old) + (hi - lo) + 1e-12
        feats["recent_improvement"] = float(
            np.clip((best_old - best_new) / denom, 0.0, 1.0)
        )
    return feats


def _quantize(x, step):
    return float(np.round(x / step) * step)


def _pow2_bucket(x, lo, hi):
    """Round to the nearest power of two within [lo, hi]."""
    x = float(np.clip(x, lo, hi))
    return int(2 ** int(round(math.log2(x))))


def predict_tpe_params(space_feats, trial_feats):
    """Map features → TPE tuning (the lightgbm-ensemble analog; see module
    docstring for why this is analytic).  Returns kwargs for ``tpe.suggest``.

    Every output is quantized to a coarse bucket: TPE's proposal step is
    cached per (space, cfg), so a continuously varying cfg would build a
    new step on every call.  Buckets keep the number of distinct steps
    per run small (~a dozen) while preserving the adaptive behavior at
    the granularity that matters.
    """
    d = space_feats["n_params"]
    n = trial_feats["n_trials"]

    # gamma: the reference default is 0.25.  Flat landscape / little recent
    # progress → widen the 'below' set (more exploration); strong recent
    # progress with clear structure → sharpen it.  The adjustment clips at
    # 0.35: a 75-eval ablation on branin measured gamma=0.45 costing ~20%
    # of final loss (plateau detection fires even when the run is sitting
    # IN the optimum basin), while 0.30-0.35 stayed ahead of the default.
    gamma = 0.25
    gamma *= 1.0 + 0.8 * (1.0 - trial_feats["recent_improvement"]) * (
        1.0 - trial_feats["loss_spread"]
    )
    gamma *= 1.0 - 0.4 * trial_feats["recent_improvement"]
    gamma = _quantize(np.clip(gamma, 0.15, 0.35), 0.05)

    # candidate count: scale with DIMENSIONALITY only — cheap on an
    # accelerator (a batched axis), so err high; upstream caps at ~24
    # only because numpy pays per candidate.  (An earlier history-length
    # ramp was measured hurting low-dim domains: on branin a mid-run jump
    # from 32 to 64 candidates over-exploited the argmax by ~25% of final
    # loss.)  Power-of-two bucket.
    n_ei = _pow2_bucket(24 * math.sqrt(max(d, 1)), 32, 512)

    # linear forgetting: keep the window proportional to history once the
    # run is long, never below the reference default.  25-wide buckets.
    lf = int(np.clip(_quantize(n // 2, 25), 25, 200))

    # startup: more dimensions need more seeding, conditional spaces more
    # still (each branch needs observations).  (Not part of the step's cfg —
    # only compared against len(trials) — but bucket anyway for stability.)
    n_startup = int(
        np.clip(_quantize(10 + 2 * d * (1 + space_feats["frac_conditional"]), 5), 15, 60)
    )
    # budget awareness: random startup must never eat
    # more than ~a fifth of a known eval budget — on a 75-eval run the old
    # rule could spend 60 evals exploring and leave 15 for TPE.
    budget = trial_feats.get("budget")
    if budget:
        n_startup = min(n_startup, max(10, int(budget) // 5))

    # prior weight: down-weight the prior a little on log-scaled spaces where
    # the uniform-in-log prior is broad relative to useful regions.
    prior_weight = float(np.clip(_quantize(1.0 - 0.3 * space_feats["frac_log"], 0.1), 0.6, 1.0))

    return {
        "gamma": gamma,
        "n_EI_candidates": n_ei,
        "linear_forgetting": lf,
        "n_startup_jobs": n_startup,
        "prior_weight": prior_weight,
    }


class ATPEOptimizer:
    """Object form mirroring the reference's class (atpe.py sym:
    ATPEOptimizer); holds overrides and exposes ``suggest``."""

    def __init__(self, **overrides):
        self.overrides = overrides

    def recommend(self, domain, trials):
        params = predict_tpe_params(
            featurize_space(domain.cs), featurize_trials(trials)
        )
        params.update(self.overrides)
        return params

    def suggest(self, new_ids, domain, trials, seed):
        return tpe.suggest(new_ids, domain, trials, seed,
                           **self.recommend(domain, trials))


def suggest(new_ids, domain, trials, seed, **overrides):
    """Adaptive-TPE plugin entry point (hyperopt/atpe.py sym: suggest);
    signature-compatible with the ``algo=`` boundary, tunable via
    ``functools.partial`` like every other suggester."""
    return ATPEOptimizer(**overrides).suggest(new_ids, domain, trials, seed)
