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
import torch

from ._env import resolve_device
from .base import PaddedHistory, trials_from_docs

__all__ = ["padded_history_from_numpy", "cohort_stack_from_numpy",
           "device_loop_state_from_numpy", "trials_from_reference_docs"]

# numpy dtypes that torch.from_numpy does not take (ml_dtypes' bfloat16 and
# float8_e4m3fn, as a JAX array of that type converts), crossed as their bits
_BITS = {"bfloat16": (np.uint16, torch.bfloat16),
         "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


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


def _tensor(a, device):
    a = np.ascontiguousarray(a)
    if a.dtype.name in _BITS:
        bits, dtype = _BITS[a.dtype.name]
        return torch.from_numpy(a.view(bits).copy()).view(dtype).to(device)
    return torch.from_numpy(a.copy()).to(device)


def cohort_stack_from_numpy(hist_stack, device=None):
    """The port's stacked cohort history on ``device`` from the JAX
    package's ``hist_stack`` as numpy arrays (``np.asarray`` of each
    leaf): ``vals``/``active`` per label and ``losses``/``has_loss``, all
    ``[S, cap]``, in their storage types (float32, bfloat16, int8 or
    float8_e4m3fn codes) bit for bit.  ``tpe.build_suggest_batched``'s
    ``run`` takes the result where the reference's takes ``hist_stack``."""
    dev = resolve_device(device)
    return {"vals": {l: _tensor(v, dev) for l, v in hist_stack["vals"].items()},
            "active": {l: _tensor(v, dev) for l, v in hist_stack["active"].items()},
            "losses": _tensor(hist_stack["losses"], dev),
            "has_loss": _tensor(hist_stack["has_loss"], dev)}


def device_loop_state_from_numpy(labels, vals, active, losses, has_loss, device=None):
    """The port's device-loop state ``(vals, active, losses, has_loss)`` on
    ``device`` from a JAX package loop state (``DeviceLoopRunner``'s
    ``init_state`` / ``run_chunk`` tuple) as numpy arrays: ``vals`` and
    ``active`` map each label to a ``[cap]`` array, ``losses`` and
    ``has_loss`` are ``[cap]``, all in their storage types (float32 or
    bfloat16) bit for bit.  ``device_fmin.DeviceLoopRunner.run_chunk``
    continues from the result where the reference's continues from its
    state."""
    dev = resolve_device(device)
    return ({l: _tensor(vals[l], dev) for l in labels},
            {l: _tensor(active[l], dev) for l in labels},
            _tensor(losses, dev), _tensor(has_loss, dev))


def trials_from_reference_docs(docs, device=None):
    """A port ``Trials`` on ``device`` from ``hyperopt_tpu`` trial documents
    (deep-copied, so the two stores never share a document)."""
    return trials_from_docs([copy.deepcopy(d) for d in docs], device=device)
