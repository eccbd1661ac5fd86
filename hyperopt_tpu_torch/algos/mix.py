"""Mixture of suggesters (counterpart of ``hyperopt_tpu/algos/mix.py``):
per new id, draw one sub-suggester from a categorical over
``p_suggest = [(p, suggest_fn), ...]`` and delegate to it.  Host numpy,
draw for draw the JAX package's (``default_rng(seed)``, one ``choice``
and one ``integers(2**31 - 1)`` per id)."""

from __future__ import annotations

import numpy as np

__all__ = ["suggest"]


def suggest(new_ids, domain, trials, seed, p_suggest):
    """``p_suggest``: ``(probability, suggest_fn)`` pairs summing to 1
    (hyperopt/mix.py sym: suggest)."""
    ps = np.asarray([p for p, _ in p_suggest], dtype=float)
    if not np.isclose(ps.sum(), 1.0, atol=1e-6):
        raise ValueError(f"p_suggest probabilities sum to {ps.sum()}, expected 1")
    # the full-width seed: masking it would give seeds that differ only in
    # their high bits one stream
    rng = np.random.default_rng(int(seed))
    docs = []
    for new_id in new_ids:
        idx = int(rng.choice(len(ps), p=ps))
        _, sub = p_suggest[idx]
        docs.extend(sub([new_id], domain, trials, int(rng.integers(2**31 - 1))))
    return docs
