"""Carry optimizer state from the JAX package into the port.

The state of a study is its trial history, so this is what takes the
place of converting weights: the padded history arrays
(``np.asarray(ph._vals[l])`` and friends of a ``hyperopt_tpu``
``PaddedHistory``) or the trial documents of a ``hyperopt_tpu`` ``Trials``
become the port's ``PaddedHistory`` or ``Trials`` on a device.  Only
numpy arrays and plain documents cross; nothing here imports the JAX
package.
"""

from __future__ import annotations

import copy

import numpy as np

from .base import PaddedHistory, trials_from_docs

__all__ = ["padded_history_from_numpy", "trials_from_reference_docs"]


def padded_history_from_numpy(labels, vals, active, losses, has_loss, device=None,
                              n=None):
    """A port ``PaddedHistory`` on ``device`` holding the given arrays.

    ``vals``/``active`` map each label to a ``[cap]`` array and
    ``losses``/``has_loss`` are ``[cap]``, as the JAX package's padded
    history stores them (padding: inactive, no loss).  ``n`` is the number
    of live rows; by default, one past the last slot that holds a loss or
    an active value."""
    labels = tuple(labels)
    losses = np.asarray(losses, np.float32)
    has_loss = np.asarray(has_loss, bool)
    size = losses.shape[0]
    if n is None:
        used = has_loss.copy()
        for l in labels:
            used |= np.asarray(active[l], bool)
        n = int(np.flatnonzero(used)[-1]) + 1 if used.any() else 0
    ph = PaddedHistory(labels, device)
    ph._grow(max(size, n))
    for l in labels:
        ph._vals[l][:size] = np.asarray(vals[l], np.float32)
        ph._active[l][:size] = np.asarray(active[l], bool)
    ph._losses[:size] = np.where(has_loss, losses, np.inf)
    ph._has_loss[:size] = has_loss
    ph.n = int(n)
    return ph


def trials_from_reference_docs(docs, device=None):
    """A port ``Trials`` on ``device`` from ``hyperopt_tpu`` trial documents
    (deep-copied, so the two stores never share a document)."""
    return trials_from_docs([copy.deepcopy(d) for d in docs], device=device)
