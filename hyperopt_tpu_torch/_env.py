"""Device resolution and environment knobs (counterpart of the parts of
``hyperopt_tpu/_env.py`` that the ask→tell loop, the study scheduler and
the evaluation backends read).

:data:`KNOBS` sorts every ``HYPEROPT_TPU_*`` knob of the JAX package into
one of three treatments:

* ``honoured`` — the port reads it and does what the JAX package does;
* ``refused`` — it arms a path the port has not ported: where the JAX
  package reads it, the port's entry point raises ``not_ported(knob,
  item)`` when the knob is set to a value that arms it
  (:func:`refuse_armed_knobs`), or the entry point that reads it is not
  in the port yet;
* ``none`` — it tunes XLA only (compile cache, buffer donation, the
  deprecated Pallas alias) and changes no result and no file: it is
  accepted and has no effect.

A knob the JAX package reads only on its default-on planes (the degrade
ladder; quality, load and tenant telemetry) raises nothing while unset,
so those planes' absence is a documented gap until they are ported.
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple

import torch

__all__ = ["resolve_device", "parse_hist_dtype", "parse_megakernel", "parse_compile_widen",
           "parse_service_max_studies", "parse_service_max_pending",
           "parse_service_idle_sec", "not_ported", "Knob", "KNOBS",
           "refuse_armed_knobs"]


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


_OFF = ("0", "off", "false", "no")


def _set(raw):
    return raw != ""


def _set_not_off(raw):
    return raw != "" and raw.lower() not in _OFF


class Knob(NamedTuple):
    """One ``HYPEROPT_TPU_*`` knob: its ``treatment`` (``honoured``,
    ``refused`` or ``none``), the ROADMAP item that ports it (refused
    knobs), where the JAX package reads it, the port's entry points that
    refuse it (``refused_at``; empty when that entry point is not ported
    yet), the predicate on its stripped value that says it arms the path
    (``arms``), and the knob it is only read under (``under``: that one
    raises first)."""

    treatment: str
    item: int | None
    read_in: str
    refused_at: tuple = ()
    arms: Callable[[str], bool] | None = None
    under: str | None = None


_FMIN = ("fmin",)
_SCHED = ("StudyScheduler",)

KNOBS = {
    # honoured: the port reads them as the JAX package does
    "HYPEROPT_TPU_HIST_DTYPE": Knob("honoured", None, "base, algos/tpe, device_fmin, "
                                    "service/scheduler (parse_hist_dtype)"),
    "HYPEROPT_TPU_MEGAKERNEL": Knob("honoured", None, "megakernel, algos/tpe, "
                                    "service/scheduler (parse_megakernel)"),
    "HYPEROPT_TPU_COMPILE_WIDEN": Knob("honoured", None, "service/scheduler"),
    "HYPEROPT_TPU_SERVICE_MAX_STUDIES": Knob("honoured", None, "service/scheduler"),
    "HYPEROPT_TPU_SERVICE_MAX_PENDING": Knob("honoured", None, "service/scheduler"),
    "HYPEROPT_TPU_SERVICE_IDLE_SEC": Knob("honoured", None, "service/scheduler"),
    "HYPEROPT_TPU_TRIAL_RETRIES": Knob("honoured", None, "retry.RetryPolicy.from_env "
                                       "(the worker CLI's default)"),
    "HYPEROPT_TPU_CHAOS": Knob("honoured", None, "chaos (filestore's io site, the "
                               "worker's trial site)"),
    "HYPEROPT_TPU_WATCHDOG": Knob("honoured", None, "obs/watchdog (the executor and the "
                                  "worker beat it; fmin's own beats come with item 14)"),
    # refused where the port has the entry point that reads them
    "HYPEROPT_TPU_OBS": Knob("refused", 14, "fmin via obs.ObsConfig (a path streams "
                             "JSONL)", _FMIN,
                             lambda r: r != "" and r.lower() not in ("1", "basic", "0", "off")),
    "HYPEROPT_TPU_PROFILE": Knob("refused", 14, "fmin via obs.ObsConfig (device "
                                 "captures)", _FMIN, _set),
    "HYPEROPT_TPU_OBS_HTTP": Knob("refused", 14, "fmin via obs.ObsConfig (scrape "
                                  "server)", _FMIN, _set_not_off),
    "HYPEROPT_TPU_DEVMEM": Knob("refused", 14, "fmin via obs.ObsConfig (device-memory "
                                "sampler)", _FMIN, _set_not_off),
    "HYPEROPT_TPU_FLIGHT": Knob("refused", 14, "fmin via obs.ObsConfig (a dump path; "
                                "0/off, which disables the recorder, is honoured "
                                "by obs/flight)", _FMIN,
                                lambda r: r not in ("", "0", "1", "off")),
    "HYPEROPT_TPU_SHARD": Knob("refused", 12, "algos/tpe, device_fmin.DeviceLoopRunner, "
                               "service/scheduler (a sharded program)",
                               ("tpe.suggest", "DeviceLoopRunner", "StudyScheduler"),
                               _set_not_off),
    "HYPEROPT_TPU_HIST_SHARD_MIN": Knob("refused", 12, "parallel/sharding",
                                        under="HYPEROPT_TPU_SHARD"),
    "HYPEROPT_TPU_SERVICE_WAL": Knob("refused", 13, "service/scheduler (a journal path)",
                                     _SCHED, lambda r: r != "" and r.lower() not in (
                                         "1", "on", "true", "yes", "auto") + _OFF),
    "HYPEROPT_TPU_COMPILE_PLANE": Knob("refused", 13, "service/scheduler",
                                       _SCHED, lambda r: r.lower() in (
                                           "1", "on", "true", "yes", "auto")),
    "HYPEROPT_TPU_COMPILE_BANK_TOP_N": Knob("refused", 13, "service/compile_plane",
                                            under="HYPEROPT_TPU_COMPILE_PLANE"),
    "HYPEROPT_TPU_SERVICE_DEGRADE": Knob("refused", 13, "service/scheduler (the degrade "
                                         "ladder; on by default there)", _SCHED,
                                         _set_not_off),
    "HYPEROPT_TPU_STORE_GC": Knob("refused", 13, "service/scheduler", _SCHED, _set_not_off),
    "HYPEROPT_TPU_STORE_WATERMARK": Knob("refused", 13, "service/scheduler", _SCHED,
                                         _set_not_off),
    "HYPEROPT_TPU_QUALITY": Knob("refused", 14, "service/scheduler (on by default "
                                 "there)", _SCHED, _set_not_off),
    "HYPEROPT_TPU_LOAD": Knob("refused", 14, "service/scheduler (on by default there)",
                              _SCHED, _set_not_off),
    "HYPEROPT_TPU_TENANT": Knob("refused", 14, "service/scheduler (on by default there)",
                                _SCHED, _set_not_off),
    "HYPEROPT_TPU_TENANT_TOP_K": Knob("refused", 14, "service/scheduler (the tenant "
                                      "ledger)", _SCHED, _set),
    # refused: the entry point that reads them is not in the port yet
    "HYPEROPT_TPU_ALLGATHER_TIMEOUT": Knob("refused", 12, "parallel/driver"),
    "HYPEROPT_TPU_PAYLOAD": Knob("refused", 12, "parallel/payload"),
    "HYPEROPT_TPU_FLEET_SHARDS": Knob("refused", 12, "service/fleet"),
    "HYPEROPT_TPU_FLEET_LEASE_TTL": Knob("refused", 12, "service/fleet"),
    "HYPEROPT_TPU_FLEET_ADDR": Knob("refused", 12, "service/server"),
    "HYPEROPT_TPU_SERVICE": Knob("refused", 13, "service/server"),
    "HYPEROPT_TPU_SERVICE_ACCESS_LOG": Knob("refused", 13, "service/server"),
    "HYPEROPT_TPU_SERVICE_DEADLINE_MS": Knob("refused", 13, "service/server"),
    "HYPEROPT_TPU_SERVICE_QUEUE": Knob("refused", 13, "service/overload"),
    "HYPEROPT_TPU_REQTRACE": Knob("refused", 14, "service/server"),
    "HYPEROPT_TPU_SERVICE_SLO": Knob("refused", 14, "service/server"),
    "HYPEROPT_TPU_QUALITY_SLO": Knob("refused", 14, "service/server"),
    "HYPEROPT_TPU_LOAD_SLO": Knob("refused", 14, "service/server"),
    "HYPEROPT_TPU_TENANT_SLO": Knob("refused", 14, "service/server"),
    "HYPEROPT_TPU_TENANT_QUOTA": Knob("refused", 14, "service/overload"),
    "HYPEROPT_TPU_PROBE": Knob("refused", 14, "service/server"),
    "HYPEROPT_TPU_PROBE_PERIOD": Knob("refused", 14, "obs/prober"),
    "HYPEROPT_TPU_PROBE_SLO": Knob("refused", 14, "service/server"),
    # no counterpart: they tune XLA only
    "HYPEROPT_TPU_NO_CACHE": Knob("none", None, "fmin (the XLA compilation cache)"),
    "HYPEROPT_TPU_COMPILE_CACHE": Knob("none", None, "fmin (the XLA compilation cache)"),
    "HYPEROPT_TPU_NO_DONATION": Knob("none", None, "algos/tpe (XLA buffer donation)"),
    "HYPEROPT_TPU_PALLAS": Knob("none", None, "megakernel, algos/tpe (a deprecated "
                                "alias routing EI through the Pallas kernel; the port's "
                                "EI always runs in its own kernel)"),
}


def refuse_armed_knobs(entry):
    """Raise ``not_ported(knob, item)`` for the first refused knob that
    ``entry`` (``"fmin"``, ``"tpe.suggest"``, ``"DeviceLoopRunner"``,
    ``"StudyScheduler"``) reads and that is set to a value arming it."""
    for name, knob in KNOBS.items():
        if entry in knob.refused_at:
            raw = os.environ.get(name, "").strip()
            if knob.arms(raw):
                raise not_ported(f"{name}={raw!r}", knob.item)
