"""EI scoring kernel of the TPE tick (counterpart of the EI-pair kernel in
``hyperopt_tpu/megakernel.py``: ``ei_diff`` / ``_build_ei``).

``ei_diff(x, wb, mb, sb, wa, ma, sa)`` scores candidates ``x[P, n]`` under
two Gaussian mixtures given as component tables ``[P, m]``: the below
mixture's log-density minus the above mixture's, with no truncation terms.
On a CUDA tensor it launches the hand-written kernel in
``csrc/ei_diff.cu``; on a CPU tensor it computes :func:`ei_diff_plain`,
the same function in plain torch.  The fused sample-and-score kernel of
the study-batched cohort (``_build_fused``) is not ported yet.
"""

from __future__ import annotations

import torch

__all__ = ["ei_diff", "ei_diff_plain"]

# log(sqrt(2*pi))
_LOG_SQRT_2PI = 0.9189385332046727
# stand-in for -inf that survives max/exp arithmetic without NaNs
_VERY_NEG = -1e30


def ei_diff_plain(x, wb, mb, sb, wa, ma, sa):
    """Plain torch version of the kernel: a ``[P, m, n]`` log-sum-exp per
    mixture, dead (w <= 0) components at -1e30, weights floored at 1e-12
    inside the log."""

    def model(w, mu, s):
        logw = torch.where(w > 0, torch.log(torch.clamp(w, min=1e-12)),
                           torch.full_like(w, _VERY_NEG))
        comp = (logw[:, :, None]
                - 0.5 * ((x[:, None, :] - mu[:, :, None]) / s[:, :, None]) ** 2
                - torch.log(s)[:, :, None] - _LOG_SQRT_2PI)
        return torch.logsumexp(comp, dim=1)

    return model(wb, mb, sb) - model(wa, ma, sa)


def _check(x, tables):
    if x.dim() != 2:
        raise ValueError(f"ei_diff: x must be [P, n], got {tuple(x.shape)}")
    P = x.shape[0]
    m = tables[0].shape[-1]
    for t in (x, *tables):
        if t.dtype != torch.float32:
            raise TypeError(f"ei_diff: float32 tensors only, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"ei_diff: tensors on {t.device} and {x.device}")
    for t in tables:
        if tuple(t.shape) != (P, m):
            raise ValueError(f"ei_diff: tables must all be [P={P}, m={m}], "
                             f"got {tuple(t.shape)}")
    if m < 1:
        raise ValueError("ei_diff: a mixture needs at least one component")
    return P, x.shape[1], m


def ei_diff(x, wb, mb, sb, wa, ma, sa):
    """EI score ``lpdf_below(x) - lpdf_above(x)`` for ``x[P, n]`` and
    component tables ``[P, m]`` (float32).  CUDA tensors launch the kernel
    (and count the launch in ``ei_diff.launches``); CPU tensors take
    :func:`ei_diff_plain`; any other device raises."""
    tables = (wb, mb, sb, wa, ma, sa)
    P, n, m = _check(x, tables)
    if x.device.type == "cpu":
        return ei_diff_plain(x, *tables)
    if x.device.type != "cuda":
        raise ValueError(f"ei_diff: no kernel for device {x.device}")
    if not all(t.is_contiguous() for t in (x, *tables)):
        raise ValueError("ei_diff: the kernel takes contiguous tensors")
    if P > 65535:
        raise ValueError(f"ei_diff: P={P} exceeds the kernel's grid (65535)")
    from ._build import library

    out = torch.empty_like(x)
    if P == 0 or n == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library("ei_diff").ei_diff_f32(
            x.data_ptr(), *(t.data_ptr() for t in tables), out.data_ptr(),
            P, n, m, stream)
    if err != 0:
        raise RuntimeError(f"ei_diff kernel launch failed: CUDA error {err}")
    ei_diff.launches += 1
    return out


ei_diff.launches = 0
