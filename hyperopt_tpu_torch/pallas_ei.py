"""Deprecated names of the EI-pair kernel (counterpart of the JAX
package's ``pallas_ei`` shim, whose kernel moved to ``megakernel``).

The re-exports are the same objects as :mod:`hyperopt_tpu_torch.megakernel`'s:
``ei_diff`` (the CUDA kernel's wrapper, ``csrc/ei_diff.cu``) and its plain
torch version under the JAX package's name ``ei_diff_reference``.
:func:`pallas_available` answers, as the JAX package's does for Mosaic,
whether the kernel can launch here.  New code imports ``megakernel``.
"""

from __future__ import annotations

from .megakernel import ei_diff, ei_diff_reference, pallas_available

__all__ = ["ei_diff", "ei_diff_reference", "pallas_available"]
