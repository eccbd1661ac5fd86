"""Static, space-derived history quantization (counterpart of
``hyperopt_tpu/quant.py``).

``HYPEROPT_TPU_HIST_DTYPE=int8|fp8`` stores the device mirror's ``vals``
as per-label affine codes ``t(x) ≈ zero + q * scale``, ``q`` an int8
(round to nearest on a 255-point grid) or a ``torch.float8_e4m3fn`` in
the same normalized range; losses stay bf16.  The rules of the reference
hold unchanged:

1. qparams are pure functions of the space: bounds for the uniform
   families, ``mu ± 4σ`` for the unbounded normals, the exact integer
   grid for discrete families; log families code ``log x``.
2. Snap-at-ingest: a history that arms qparams stores every host value as
   the dequantized grid point (:func:`snap_np`), so every later encode,
   on the host or on the device, rounds an exact grid point to the same
   code.
3. A space the code cannot represent (``q*`` families, discrete families
   past the code's exact-integer range, bounds too tight for f32 round
   trips) degrades to bf16 storage with one warning per (context, name);
   ``fallback_count()`` counts the degrades (the metrics plane that
   publishes it is not ported yet).

Every read site decodes to float32 before the Parzen/EI math
(``tpe._read_vals``), so the kernels never see codes.  Numpy has no
float8 type: the host fp8 round trip goes through
``torch.from_numpy(...).to(torch.float8_e4m3fn)``, which rounds as
``ml_dtypes`` does.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

__all__ = [
    "QUANT_NAMES",
    "is_quant_name",
    "vals_dtype",
    "losses_dtype",
    "quant_dtype_name",
    "mirror_float_dtype",
    "label_qparams",
    "space_qparams",
    "resolve",
    "quantize",
    "dequantize",
    "snap_np",
    "quantize_np",
    "fallback_count",
]

logger = logging.getLogger(__name__)

QUANT_NAMES = ("int8", "fp8")

EPS = 1e-12
_QMAX = 127.0  # symmetric code range; -128 unused so the grid is odd

# int8 round-trips every integer in [-127, 127]; float8_e4m3fn (3 mantissa
# bits) only the integers up to 2**4
_DISCRETE_LIMIT = {"int8": 255, "fp8": 33}

_STORAGE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "int8": torch.int8, "fp8": torch.float8_e4m3fn}

_warned = set()
_fallbacks = 0


def _fallback(reason, key):
    global _fallbacks
    _fallbacks += 1
    if key not in _warned:
        _warned.add(key)
        logger.warning("quantized history unavailable (%s); falling back to "
                       "bf16 storage for this history (warn-once)", reason)


def fallback_count():
    """How many histories or cohorts degraded to bf16 in this process."""
    return _fallbacks


def is_quant_name(name):
    return str(name) in QUANT_NAMES


def vals_dtype(name):
    """torch storage dtype of the ``vals`` arrays under storage ``name``."""
    return _STORAGE[str(name)]


def quant_dtype_name(dt):
    """``"int8"``/``"fp8"`` when ``dt`` is a code storage dtype, else None:
    every read and write site dispatches on the history leaf's dtype."""
    if dt == torch.int8:
        return "int8"
    if dt == torch.float8_e4m3fn:
        return "fp8"
    return None


def losses_dtype(name):
    """Storage dtype of ``losses``: bf16 under the code modes (they have no
    static scale and drive the below/above argsort), else the mode's own."""
    if is_quant_name(name):
        return torch.bfloat16
    return _STORAGE[str(name)]


def mirror_float_dtype(name):
    """The torch dtype of a history that is stored by a plain cast, with
    no code path (the device loop's resident state): float32 and bf16 pass
    through, and int8/fp8 degrade to bf16 with the warn-once fallback, as
    a cast to int8 would truncate values, not encode them."""
    if is_quant_name(name):
        _fallback(f"{name} history is not supported on this path "
                  "(affine-code reads are not wired here)", ("mirror", str(name)))
        return torch.bfloat16
    return _STORAGE[str(name)]


def label_qparams(dist, name):
    """``(scale, zero, islog)`` for one ``Dist`` under storage ``name``, or
    None when the family cannot be coded exactly enough."""
    from .algos.tpe import _parzen_from, _prior_probs

    name = str(name)
    fam = dist.family
    if fam in ("categorical", "randint"):
        K = int(_prior_probs(dist).shape[0])
        if K > _DISCRETE_LIMIT.get(name, 0):
            return None
        offset = int(dist.params[0]) if fam == "randint" else 0
        return (1.0, float(offset + (K - 1) // 2), False)
    try:
        _, _, low, high, q, islog = _parzen_from(dist)
    except ValueError:
        return None
    if q is not None:
        return None
    if math.isfinite(low) and math.isfinite(high):
        zero = 0.5 * (low + high)
        scale = (high - low) / (2.0 * _QMAX)
    else:
        mu, sigma = float(dist.params[0]), float(dist.params[1])
        zero = mu
        scale = (8.0 * sigma) / (2.0 * _QMAX)
    if not (scale > 0.0) or not math.isfinite(scale):
        return None
    # a grid finer than ~8 ulp of the zero offset cannot round-trip
    if scale <= 8.0 * float(np.spacing(np.float32(abs(zero)))):
        return None
    return (float(scale), float(zero), bool(islog))


def space_qparams(cs, name):
    """Per-label qparams of a compiled space, or None when any label cannot
    be coded (the whole mirror degrades together)."""
    out = {}
    for l in cs.labels:
        qp = label_qparams(cs.params[l].dist, name)
        if qp is None:
            return None
        out[l] = qp
    return out


def resolve(cs, name, context="history"):
    """``(effective_name, qparams_or_None)``: a code name resolves to itself
    and its qparams when the space can be coded, else to ``bfloat16``
    (warn once per (context, name))."""
    name = str(name)
    if not is_quant_name(name):
        return name, None
    qp = space_qparams(cs, name)
    if qp is None:
        _fallback(f"{name} cannot represent this space", (context, name))
        return "bfloat16", None
    return name, qp


def quantize(x, qp, name):
    """float32 values (a tensor) → storage codes on the same device, in the
    reference's order: log for log families, ``(t - zero) / scale``, clip,
    then (int8) round half to even.  The division is a product with the
    float32 reciprocal of ``scale``, as XLA compiles the reference's
    in-trace encode; on a snapped grid value both give the host's code."""
    scale, zero, islog = qp
    t = x.to(torch.float32)
    if islog:
        t = torch.log(torch.clamp(t, min=EPS))
    z = torch.tensor(np.float32(zero), device=t.device)
    inv = torch.tensor(np.float32(1.0) / np.float32(scale), device=t.device)
    q = torch.clamp((t - z) * inv, -_QMAX, _QMAX)
    if str(name) == "int8":
        q = torch.round(q)
    return q.to(vals_dtype(name))


def dequantize(q, qp):
    """Storage codes → float32 values: ``zero + q * scale`` rounded once,
    as XLA's fused multiply-add computes the reference's decode, then
    ``exp`` for log families."""
    scale, zero, islog = qp
    t = (q.to(torch.float64) * float(np.float32(scale))
         + float(np.float32(zero))).to(torch.float32)
    return torch.exp(t) if islog else t


def quantize_np(x, qp, name):
    """Host encode with the operation order of :func:`quantize` (numpy
    float32 arithmetic, as the reference's host path).  Returns a CPU
    tensor in the storage dtype: numpy has no float8 type."""
    scale, zero, islog = qp
    x = np.atleast_1d(np.asarray(x, np.float32))
    t = np.log(np.maximum(x, np.float32(EPS))).astype(np.float32) if islog else x
    q = np.clip((t - np.float32(zero)) / np.float32(scale), -_QMAX, _QMAX)
    if str(name) == "int8":
        return torch.from_numpy(np.rint(q).astype(np.int8))
    return torch.from_numpy(np.ascontiguousarray(q, np.float32)).to(torch.float8_e4m3fn)


def snap_np(x, qp, name):
    """Host encode→decode round trip: the value the device mirror decodes
    for ``x`` (a scalar for a scalar).  Idempotent by the scale guard of
    :func:`label_qparams`."""
    scale, zero, islog = qp
    x = np.asarray(x, np.float32)
    scalar = x.ndim == 0
    q = quantize_np(x, qp, name).to(torch.float32).numpy()
    t2 = (q * np.float32(scale) + np.float32(zero)).astype(np.float32)
    out = np.exp(t2).astype(np.float32) if islog else t2
    return out[0] if scalar else out
