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

``q_mass_diff(x, wb, mb, sb, wa, ma, sa, q, lo, hi, islog, p_b, p_a,
bounded, has_log)`` scores a group of quantized labels: each candidate's
bin mass under the below mixture against the above one's, in logs, with
the truncation terms of the in-bounds masses ``p_b``, ``p_a``
(``csrc/q_mass.cu``; no TPU kernel: the JAX package leaves the bin
masses to XLA).

On a CUDA tensor each wrapper launches its hand-written kernel (and counts
the launch in ``<wrapper>.launches``, or in ``<wrapper>.captures`` when
the launch is recorded into a CUDA graph; the device loop counts the
graph's replays in ``<wrapper>.graph_launches``); on a CPU tensor it computes the
plain torch version beside it (``ei_diff_plain``,
``fused_sample_ei_plain``, ``q_mass_diff_plain``); any other device
raises.  A build or launch failure raises: nothing falls back.
``ei_diff`` and ``fused_sample_ei`` score with the loop of
``csrc/mixture_lse.cuh`` (per-component constants hoisted, one exp2 per
term on a base-2 carry); the plain versions stay the function the JAX
package computes.
"""

from __future__ import annotations

import torch

__all__ = ["mode", "supports", "armed", "build_cohort", "ei_diff", "ei_diff_plain",
           "ei_diff_reference", "pallas_available", "fused_sample_ei", "fused_sample_ei_plain",
           "q_mass_diff", "q_mass_diff_plain", "ei_cost", "fused_cost"]

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


#: the JAX package's name for the kernel's plain twin
ei_diff_reference = ei_diff_plain


def pallas_available():
    """True where ``ei_diff`` launches its CUDA kernel (the JAX package's
    question is whether Mosaic lowers): a card is visible and the kernel's
    library is built or ``nvcc`` can build it."""
    if not torch.cuda.is_available():
        return False
    from . import _build

    try:
        return _build._target("ei_diff")[1].exists() or bool(_build._nvcc())
    except RuntimeError:
        return False


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


def ei_cost(P, n, m):
    """The least work of one ``ei_diff`` launch at ``(P, n, m)``:
    ``(ops, bytes)``.  ``ops`` counts the exponentials, one per candidate,
    component and mixture (the special-function work that bounds the
    kernel); ``bytes`` reads ``x`` and writes the output once, plus the
    six component tables.  A lower bound on the launch's work: the
    roofline of ``chip_smoke.py`` and the ``suggest.tpe`` cost gauges of
    ``obs/health.py`` both read it."""
    return 2 * P * n * m, 4 * (2 * P * n + 6 * P * m)


def fused_cost(P, N, m):
    """The least work of one ``fused_sample_ei`` launch at ``(P, N, m)``:
    ``(ops, bytes)``.  Two exponentials per candidate and component (one
    per mixture) plus one ``ndtri`` per candidate; the bytes are the two
    uniforms and the two outputs once, nine tables and the two bounds."""
    return 2 * P * N * m + P * N, 16 * P * N + 36 * P * m + 8 * P


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


# ---------------------------------------------------------------------------
# the quantized-bin score
# ---------------------------------------------------------------------------


def q_mass_diff_plain(x, wb, mb, sb, wa, ma, sa, q, lo, hi, islog, p_b, p_a, bounded,
                      has_log):
    """Plain torch version of :func:`q_mass_diff`: the below mixture's
    quantized-bin log-density minus the above one's, each with its
    truncation term (``tpe._q_lpdf_group``, the float32 function the JAX
    package computes, its FMAs rounded once through float64 products)."""
    from .algos import tpe

    return (tpe._q_lpdf_group(x, wb, mb, sb, lo, hi, q, islog, bounded, has_log, p_b)
            - tpe._q_lpdf_group(x, wa, ma, sa, lo, hi, q, islog, bounded, has_log, p_a))


def q_mass_diff(x, wb, mb, sb, wa, ma, sa, q, lo, hi, islog, p_b, p_a, bounded, has_log):
    """Quantized-bin EI score of value-space candidates ``x[G, N]`` under
    the below/above component tables ``[G, m]`` (float32), with per-label
    rows ``q``, ``lo``, ``hi`` (float32 ``[G]``; t-space bounds, read when
    ``bounded``), ``islog`` (bool ``[G]``, read when ``has_log``) and the
    tables' in-bounds masses ``p_b``, ``p_a`` (float32 ``[G]``,
    ``tpe._p_accept_group``): ``log max(M_b, EPS) - log max(M_a, EPS) -
    log p_b + log p_a`` ``[G, N]``, ``M`` a mixture's mass of each
    candidate's bin.  CUDA tensors launch ``csrc/q_mass.cu`` for the bin
    masses (counted in ``q_mass_diff.launches``) and add the truncation
    terms as ``tpe._normalize_ei`` does for ``ei_diff``; CPU tensors take
    :func:`q_mass_diff_plain`; any other device raises."""
    tables = (wb, mb, sb, wa, ma, sa)
    P, N, m = _check("q_mass_diff", x, tables, (q, lo, hi, p_b, p_a))
    if islog.dtype != torch.bool or tuple(islog.shape) != (P,) or islog.device != x.device:
        raise ValueError(f"q_mass_diff: islog must be bool [P={P}] on {x.device}")
    if x.device.type == "cpu":
        return q_mass_diff_plain(x, *tables, q, lo, hi, islog, p_b, p_a, bounded, has_log)
    if x.device.type != "cuda":
        raise ValueError(f"q_mass_diff: no kernel for device {x.device}")
    _launchable("q_mass_diff", P, (x, *tables, q, lo, hi, islog))
    from ._build import library
    from .algos import tpe

    raw = torch.empty_like(x)
    if P and N:
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = library("q_mass").q_mass_diff_f32(
                x.data_ptr(), *(t.data_ptr() for t in tables), q.data_ptr(), lo.data_ptr(),
                hi.data_ptr(), islog.data_ptr(), raw.data_ptr(), P, N, m,
                int(bool(bounded)), int(bool(has_log)), stream)
            capturing = torch.cuda.is_current_stream_capturing()
        if err != 0:
            raise RuntimeError(f"q_mass_diff kernel launch failed: CUDA error {err}")
        _count(q_mass_diff, capturing)
    return tpe._normalize_ei(raw, p_b, p_a)


q_mass_diff.launches = q_mass_diff.captures = q_mass_diff.graph_launches = 0

# the library and the plan's keys of each kernel's C entry
_PLANS = {"ei_diff": ("ei_diff", ("per_thread", "splits")),
          "fused_sample_ei": ("fused_sample_ei", ("cols", "rows")),
          "q_mass_diff": ("q_mass", ("lanes", "per_block"))}


def _launch_plan(kernel, P, n, m):
    """The launch the C entry of ``kernel`` (``"ei_diff"``,
    ``"fused_sample_ei"`` or ``"q_mass_diff"``) makes at shape
    ``(P, n, m)`` on the current card, for reports: ``{"per_thread" |
    "cols" | "lanes", "splits" | "rows" | "per_block", "blocks",
    "threads"}``.  Builds the kernel; needs the CUDA toolkit.  Raises if
    the card cannot be queried."""
    import ctypes

    from ._build import library

    stem, keys = _PLANS[kernel]
    out = (ctypes.c_int * 4)()
    err = getattr(library(stem), f"{kernel}_plan")(P, n, m,
                                                   ctypes.cast(out, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"{kernel}: launch plan failed: CUDA error {err}")
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
