"""The TPE tick's kernels (counterpart of ``hyperopt_tpu/megakernel.py``).

``ei_diff(x, wb, mb, sb, wa, ma, sa)`` scores candidates ``x[P, n]`` under
two Gaussian mixtures given as component tables ``[P, m]``: the below
mixture's log-density minus the above mixture's, with no truncation terms
(``csrc/ei_diff.cu``; the TPU kernel ``_build_ei``).

``fused_sample_ei(uc, u0, cdf, mb, sb, ab, bb, wb, wa, ma, sa, low, high,
bounded)`` draws each candidate from the below mixture by inverse CDF
from the uniforms ``uc``/``u0`` ``[P, N]`` and scores it the same way, in
one pass (``csrc/fused_sample_ei.cu``; the TPU kernel ``_build_fused``).
The study-batched cohort runs it for every space :func:`supports`, one
launch per group of a tick, when :func:`armed`; ``build_cohort`` is that
build of ``tpe.build_suggest_batched``.

On a CUDA tensor each wrapper launches its hand-written kernel (and counts
the launch in ``<wrapper>.launches``, or in ``<wrapper>.captures`` when
the launch is recorded into a CUDA graph; the device loop counts the
graph's replays in ``<wrapper>.graph_launches``); on a CPU tensor it computes the
plain torch version beside it (``ei_diff_plain``,
``fused_sample_ei_plain``); any other device raises.  A build or launch
failure raises: nothing falls back.  Both kernels score with the loop of
``csrc/mixture_lse.cuh`` (per-component constants hoisted, one exp2 per
term on a base-2 carry); the plain versions stay the function the JAX
package computes.
"""

from __future__ import annotations

import torch

__all__ = ["mode", "supports", "armed", "build_cohort", "ei_diff", "ei_diff_plain",
           "fused_sample_ei", "fused_sample_ei_plain"]

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


def _check(name, x, tables, rows=()):
    """Shapes ``(P, n, m)`` of a kernel call: ``x[P, n]``, every table
    ``[P, m]``, every ``rows`` tensor ``[P]``; all float32 on one device."""
    if x.dim() != 2:
        raise ValueError(f"{name}: candidates must be [P, n], got {tuple(x.shape)}")
    P = x.shape[0]
    m = tables[0].shape[-1]
    for t in (x, *tables, *rows):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: float32 tensors only, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {t.device} and {x.device}")
    for t in tables:
        if tuple(t.shape) != (P, m):
            raise ValueError(f"{name}: tables must all be [P={P}, m={m}], "
                             f"got {tuple(t.shape)}")
    for t in rows:
        if tuple(t.shape) != (P,):
            raise ValueError(f"{name}: bounds must be [P={P}], got {tuple(t.shape)}")
    if m < 1:
        raise ValueError(f"{name}: a mixture needs at least one component")
    return P, x.shape[1], m


def _launchable(name, P, tensors):
    """Checks of a CUDA launch: contiguous tensors, ``P`` inside the grid."""
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: the kernel takes contiguous tensors")
    if P > 65535:
        raise ValueError(f"{name}: P={P} exceeds the kernel's grid (65535)")


def ei_diff(x, wb, mb, sb, wa, ma, sa):
    """EI score ``lpdf_below(x) - lpdf_above(x)`` for ``x[P, n]`` and
    component tables ``[P, m]`` (float32).  CUDA tensors launch the kernel
    (and count the launch in ``ei_diff.launches``); CPU tensors take
    :func:`ei_diff_plain`; any other device raises."""
    tables = (wb, mb, sb, wa, ma, sa)
    P, n, m = _check("ei_diff", x, tables)
    if x.device.type == "cpu":
        return ei_diff_plain(x, *tables)
    if x.device.type != "cuda":
        raise ValueError(f"ei_diff: no kernel for device {x.device}")
    _launchable("ei_diff", P, (x, *tables))
    from ._build import library

    out = torch.empty_like(x)
    if P == 0 or n == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library("ei_diff").ei_diff_f32(
            x.data_ptr(), *(t.data_ptr() for t in tables), out.data_ptr(),
            P, n, m, stream)
        capturing = torch.cuda.is_current_stream_capturing()
    if err != 0:
        raise RuntimeError(f"ei_diff kernel launch failed: CUDA error {err}")
    _count(ei_diff, capturing)
    return out


def _count(wrapper, capturing):
    """Count one call of a kernel's C entry: a launch, or, while the stream
    is being captured into a CUDA graph, a kernel node of that graph
    (``captures``: it launches when the graph is replayed, and the device
    loop adds its replays to ``graph_launches``)."""
    if capturing:
        wrapper.captures += 1
    else:
        wrapper.launches += 1


ei_diff.launches = ei_diff.captures = ei_diff.graph_launches = 0


def _launch_plan(kernel, P, n, m):
    """The launch the C entry of ``kernel`` (``"ei_diff"`` or
    ``"fused_sample_ei"``) makes at shape ``(P, n, m)`` on the current
    card, for reports: ``{"per_thread" | "cols", "splits" | "rows",
    "blocks", "threads"}``.  Builds the kernel; needs the CUDA toolkit.
    Raises if the card cannot be queried."""
    import ctypes

    from ._build import library

    out = (ctypes.c_int * 4)()
    err = getattr(library(kernel), f"{kernel}_plan")(P, n, m,
                                                     ctypes.cast(out, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"{kernel}: launch plan failed: CUDA error {err}")
    keys = (("per_thread", "splits") if kernel == "ei_diff" else ("cols", "rows"))
    return dict(zip(keys + ("blocks", "threads"), out))


# ---------------------------------------------------------------------------
# the fused sample-and-score kernel of the study-batched cohort
# ---------------------------------------------------------------------------


def mode():
    """``"on"`` or ``"off"``: ``HYPEROPT_TPU_MEGAKERNEL`` as the port reads
    it (unset is ``"on"``)."""
    from ._env import parse_megakernel

    return parse_megakernel()


def supports(cs):
    """True when every label is a numeric, un-quantized family: the spaces
    the fused kernel expresses.  Discrete and ``q*`` labels keep the
    grouped ``ei_diff`` program."""
    from .algos.tpe import _parzen_from

    for l in cs.labels:
        dist = cs.params[l].dist
        if dist.family in ("categorical", "randint"):
            return False
        try:
            q = _parzen_from(dist)[4]
        except ValueError:
            return False
        if q is not None:
            return False
    return True


def armed(cs):
    """Whether a cohort of this space builds with the fused kernel: the
    knob is on and :func:`supports` accepts the space.  The tensors'
    device then picks the kernel (CUDA) or its plain twin (CPU)."""
    return mode() == "on" and supports(cs)


def fused_sample_ei_plain(uc, u0, cdf, mb, sb, ab, bb, wb, wa, ma, sa, low, high,
                          bounded):
    """Plain torch version of the fused kernel: the grouped sampler's
    ``tpe._draw_from_tables`` (pick, FMA interval draw, Cephes ``ndtri``,
    bound clamp) and then :func:`ei_diff_plain`.  Returns ``(x, ei)``,
    both ``[P, N]``."""
    from .algos import tpe

    x = tpe._draw_from_tables(uc, u0, cdf, mb, sb, ab, bb, low, high, bool(bounded))
    return x, ei_diff_plain(x, wb, mb, sb, wa, ma, sa)


def fused_sample_ei(uc, u0, cdf, mb, sb, ab, bb, wb, wa, ma, sa, low, high, bounded):
    """Draw and score candidates in one pass.  ``uc``/``u0`` ``[P, N]`` are
    the component-pick and interval uniforms of each candidate; the nine
    tables ``[P, m]`` are the below mixture's normalized truncated-weight
    CDF, locations, scales and per-component CDF at the bounds
    (``cdf, mb, sb, ab, bb``) and the raw weights of both mixtures with the
    above one's locations and scales (``wb, wa, ma, sa``); ``low``/``high``
    ``[P]`` are t-space bounds, read when ``bounded``.  Returns ``(x, ei)``:
    the candidates in t-space and their raw below-minus-above
    log-density, both ``[P, N]``.  CUDA tensors launch
    ``csrc/fused_sample_ei.cu`` (counted in ``fused_sample_ei.launches``);
    CPU tensors take :func:`fused_sample_ei_plain`."""
    tables = (cdf, mb, sb, ab, bb, wb, wa, ma, sa)
    P, N, m = _check("fused_sample_ei", uc, tables, (low, high))
    if tuple(u0.shape) != (P, N) or u0.dtype != torch.float32 or u0.device != uc.device:
        raise ValueError(f"fused_sample_ei: u0 must be float32 [P={P}, N={N}] like uc")
    if uc.device.type == "cpu":
        return fused_sample_ei_plain(uc, u0, *tables, low, high, bounded)
    if uc.device.type != "cuda":
        raise ValueError(f"fused_sample_ei: no kernel for device {uc.device}")
    _launchable("fused_sample_ei", P, (uc, u0, *tables, low, high))
    from ._build import library

    x = torch.empty_like(uc)
    ei = torch.empty_like(uc)
    if P == 0 or N == 0:
        return x, ei
    with torch.cuda.device(uc.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library("fused_sample_ei").fused_sample_ei_f32(
            uc.data_ptr(), u0.data_ptr(), *(t.data_ptr() for t in tables),
            low.data_ptr(), high.data_ptr(), x.data_ptr(), ei.data_ptr(),
            P, N, m, int(bool(bounded)), stream)
        capturing = torch.cuda.is_current_stream_capturing()
    if err != 0:
        raise RuntimeError(f"fused_sample_ei kernel launch failed: CUDA error {err}")
    _count(fused_sample_ei, capturing)
    return x, ei


fused_sample_ei.launches = fused_sample_ei.captures = fused_sample_ei.graph_launches = 0


def build_cohort(cs, cfg, n_studies, cap, n_ids, donate=True, qparams=None):
    """The fused build of ``tpe.build_suggest_batched``: the same
    ``run(hist_stack, rows_stack, seed_words[S, 2], ids[S, B]) ->
    (hist_stack', packed[S, B, L])`` program, with every un-quantized
    numeric group drawn and scored by :func:`fused_sample_ei`.  The Parzen
    mixtures are fitted once per (study, label) and their tables serve the
    kernel, the normalizers and the prior-mix score alike."""
    from .algos import tpe

    return tpe._build_cohort(cs, cfg, n_studies, cap, n_ids, donate, qparams,
                             fused=True)
