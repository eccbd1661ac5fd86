"""Device resolution and environment knobs (counterpart of the parts of
``hyperopt_tpu/_env.py`` that the ask→tell loop and the study scheduler
read)."""

from __future__ import annotations

import os

import torch

__all__ = ["resolve_device", "parse_hist_dtype", "parse_megakernel", "parse_compile_widen",
           "parse_service_max_studies", "parse_service_max_pending",
           "parse_service_idle_sec", "not_ported"]


def resolve_device(device=None):
    """The ``torch.device`` an entry point runs on.

    ``None`` means the CUDA card.  Without one this raises instead of
    running on the CPU: a CPU run is asked for with ``device="cpu"``."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "hyperopt_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev


_HIST_DTYPES = {
    "": "float32", "f32": "float32", "fp32": "float32", "float32": "float32",
    "bf16": "bfloat16", "bfloat16": "bfloat16",
    "int8": "int8", "i8": "int8",
    "fp8": "fp8", "f8": "fp8", "float8": "fp8", "float8_e4m3fn": "fp8",
}


def parse_hist_dtype():
    """``HYPEROPT_TPU_HIST_DTYPE``: the storage name of the padded
    history's device mirror, ``float32`` (default), ``bfloat16``, ``int8``
    or ``fp8``, with the JAX package's aliases.  The host arrays stay
    float32; ``int8``/``fp8`` hold the space-derived affine codes of
    ``quant.py`` (losses in bf16).  An unknown value raises."""
    raw = os.environ.get("HYPEROPT_TPU_HIST_DTYPE", "").strip().lower()
    if raw not in _HIST_DTYPES:
        raise ValueError(f"HYPEROPT_TPU_HIST_DTYPE={raw!r}: expected one of "
                         "float32|bfloat16|int8|fp8 (or f32|bf16|i8|f8)")
    return _HIST_DTYPES[raw]


def parse_megakernel():
    """``HYPEROPT_TPU_MEGAKERNEL``: ``"on"`` (unset, ``1``, ``on``) routes
    the study-batched cohort of every space ``megakernel.supports``
    through the fused sample-and-score kernel (its plain twin for CPU
    tensors); ``"off"`` (``0``, ``off``) keeps the grouped ``ei_diff``
    program.  ``interpret`` runs a Pallas interpreter in the JAX package
    only, and raises here, as does any other value."""
    raw = os.environ.get("HYPEROPT_TPU_MEGAKERNEL", "").strip().lower()
    if raw in ("", "1", "on", "true", "yes"):
        return "on"
    if raw in ("0", "off", "false", "no"):
        return "off"
    if raw == "interpret":
        raise ValueError("HYPEROPT_TPU_MEGAKERNEL=interpret runs the Pallas "
                         "interpreter of the JAX package; hyperopt_tpu_torch "
                         "takes on|off")
    raise ValueError(f"HYPEROPT_TPU_MEGAKERNEL={raw!r}: expected on|off (1|0)")


def parse_compile_widen():
    """``HYPEROPT_TPU_COMPILE_WIDEN``: widen the study scheduler's cohorts
    (``1``/``on``/``true``/``yes``; off by default).  A widened cohort (an
    unconditional space) keeps off the fused kernel and scores in grouped
    ``ei_diff``, as the JAX package's widened cohort does, so its proposals
    match a fused cohort's only to the kernels' agreement; keep the flag
    stable for a service's lifetime."""
    raw = os.environ.get("HYPEROPT_TPU_COMPILE_WIDEN", "").strip().lower()
    return raw in ("1", "on", "true", "yes")


def _pos_int(var, default):
    raw = os.environ.get(var, "").strip()
    if not raw:
        return default
    v = int(raw)
    if v < 1:
        raise ValueError(f"{var}={raw!r}: expected a positive integer")
    return v


def parse_service_max_studies():
    """``HYPEROPT_TPU_SERVICE_MAX_STUDIES``: live studies a scheduler
    admits (default 4096)."""
    return _pos_int("HYPEROPT_TPU_SERVICE_MAX_STUDIES", 4096)


def parse_service_max_pending():
    """``HYPEROPT_TPU_SERVICE_MAX_PENDING``: asked-but-untold trials a
    study may hold (default 64)."""
    return _pos_int("HYPEROPT_TPU_SERVICE_MAX_PENDING", 64)


def parse_service_idle_sec():
    """``HYPEROPT_TPU_SERVICE_IDLE_SEC``: seconds of inactivity before a
    study's cohort slot is freed (default 600; ``0``/``off``: never)."""
    raw = os.environ.get("HYPEROPT_TPU_SERVICE_IDLE_SEC", "").strip().lower()
    if not raw:
        return 600.0
    if raw in ("0", "off", "false", "no"):
        return float("inf")
    sec = float(raw)
    if sec < 0:
        raise ValueError(f"HYPEROPT_TPU_SERVICE_IDLE_SEC={raw!r}: expected a "
                         "non-negative duration")
    return sec


def not_ported(what, item):
    """The error a not-yet-ported option raises, naming its ROADMAP item."""
    return NotImplementedError(
        f"{what} is not ported to hyperopt_tpu_torch yet "
        f"(ROADMAP.md, queue 1, item {item})")
