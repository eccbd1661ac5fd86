"""Device resolution and environment knobs (counterpart of the parts of
``hyperopt_tpu/_env.py`` that the ask→tell loop reads)."""

from __future__ import annotations

import os

import torch

__all__ = ["resolve_device", "parse_hist_dtype", "not_ported"]


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


def parse_hist_dtype():
    """``HYPEROPT_TPU_HIST_DTYPE``: the padded history's storage type.

    The port stores float32 only; the compressed and quantized mirrors
    come with the study-batched cohort (ROADMAP.md, queue 1, item 8)."""
    raw = os.environ.get("HYPEROPT_TPU_HIST_DTYPE", "").strip().lower()
    if raw in ("", "f32", "fp32", "float32"):
        return "float32"
    raise NotImplementedError(
        f"HYPEROPT_TPU_HIST_DTYPE={raw!r}: hyperopt_tpu_torch keeps float32 "
        "history only; bf16/int8/fp8 storage arrives with the study-batched "
        "cohort and quantized history (ROADMAP.md, queue 1, item 8)")


def not_ported(what, item):
    """The error a not-yet-ported option raises, naming its ROADMAP item."""
    return NotImplementedError(
        f"{what} is not ported to hyperopt_tpu_torch yet "
        f"(ROADMAP.md, queue 1, item {item})")
