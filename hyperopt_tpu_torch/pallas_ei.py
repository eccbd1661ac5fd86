"""Deprecated names of the EI-pair kernel (counterpart of the JAX
package's ``pallas_ei`` shim, whose kernel moved to ``megakernel``).

The re-exports are the same objects as :mod:`hyperopt_tpu_torch.megakernel`'s:
``ei_diff`` (the CUDA kernel's wrapper, ``csrc/ei_diff.cu``) and its plain
torch version under the JAX package's name ``ei_diff_reference``.
:func:`pallas_available` answers, as the JAX package's does for Mosaic,
whether the kernel can launch here.  New code imports ``megakernel``.
"""

from __future__ import annotations

import torch

from .megakernel import ei_diff
from .megakernel import ei_diff_plain as ei_diff_reference

__all__ = ["ei_diff", "ei_diff_reference", "pallas_available"]


def pallas_available():
    """True where ``ei_diff`` launches its CUDA kernel: a card is visible
    and the kernel's library is built or ``nvcc`` can build it."""
    if not torch.cuda.is_available():
        return False
    from . import _build

    try:
        return _build._target("ei_diff")[1].exists() or bool(_build._nvcc())
    except RuntimeError:
        return False
