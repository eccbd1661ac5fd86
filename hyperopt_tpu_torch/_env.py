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
* ``none`` — it tunes XLA only (disabling the compilation cache,
  buffer donation, the deprecated Pallas alias) and changes no result and
  no file: it is accepted and has no effect.

Where the JAX package warns about a malformed service, plane or fleet
value and falls back, the port raises ``ValueError`` naming the knob, as
for its other knobs.  The observability knobs (``HYPEROPT_TPU_OBS_HTTP``,
``HYPEROPT_TPU_DEVMEM``) warn once and disable, as the reference's do.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, NamedTuple

import torch

__all__ = ["resolve_device", "parse_hist_dtype", "parse_megakernel", "parse_compile_widen",
           "parse_service_max_studies", "parse_service_max_pending",
           "parse_service_idle_sec", "parse_shard", "parse_hist_shard_min",
           "parse_allgather_timeout", "DEFAULT_HIST_SHARD_MIN", "parse_service",
           "parse_service_wal", "parse_service_deadline_ms", "parse_service_queue",
           "parse_service_degrade", "parse_reqtrace", "parse_service_access_log",
           "parse_service_slo", "parse_compile_plane", "parse_compile_bank_top_n",
           "parse_store_watermark", "parse_store_gc", "parse_quality", "parse_quality_slo",
           "parse_load", "parse_load_slo", "parse_fleet_shards", "parse_fleet_lease_ttl",
           "parse_fleet_addr", "parse_tenant", "parse_tenant_top_k", "parse_tenant_quota",
           "parse_tenant_slo", "parse_obs_http", "parse_devmem_period",
           "DEFAULT_DEVMEM_PERIOD_SEC", "not_ported", "Knob", "KNOBS",
           "refuse_armed_knobs"]


logger = logging.getLogger(__name__)


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


def parse_shard():
    """``HYPEROPT_TPU_SHARD``: how many local devices the single-study tick
    and the cohorts shard over, or None (unset, ``0``/``off``: unsharded).
    ``auto``/``on``/``all`` means every local device (returned as ``-1``),
    an integer ``k >= 1`` the first ``k``.  Any other value raises."""
    raw = os.environ.get("HYPEROPT_TPU_SHARD", "").strip().lower()
    if raw in ("",) + _OFF:
        return None
    if raw in ("on", "true", "yes", "auto", "all"):
        return -1
    try:
        k = int(raw)
    except ValueError:
        raise ValueError(f"HYPEROPT_TPU_SHARD={raw!r}: expected a device count "
                         "or auto|on|off") from None
    if k < 1:
        raise ValueError(f"HYPEROPT_TPU_SHARD={raw!r}: expected a positive device count")
    return k


# history capacity at which a sharded program also splits the history's
# capacity axis over the mesh (below it every entry holds the whole history)
DEFAULT_HIST_SHARD_MIN = 65536


def parse_hist_shard_min():
    """``HYPEROPT_TPU_HIST_SHARD_MIN``: the capacity threshold at which a
    sharded program splits the history axis (default 65536)."""
    return _pos_int("HYPEROPT_TPU_HIST_SHARD_MIN", DEFAULT_HIST_SHARD_MIN)


def parse_allgather_timeout():
    """``HYPEROPT_TPU_ALLGATHER_TIMEOUT``: seconds every collective of
    ``fmin_multihost`` may take before the run checkpoints and raises
    ``FleetDegraded``, or None (unset, ``0``/``off``: no deadline)."""
    raw = os.environ.get("HYPEROPT_TPU_ALLGATHER_TIMEOUT", "").strip().lower()
    if raw in ("",) + _OFF:
        return None
    try:
        sec = float(raw)
    except ValueError:
        raise ValueError(f"HYPEROPT_TPU_ALLGATHER_TIMEOUT={raw!r}: expected a "
                         "timeout in seconds") from None
    if not sec > 0:
        raise ValueError(f"HYPEROPT_TPU_ALLGATHER_TIMEOUT={raw!r}: expected a "
                         "positive timeout")
    return sec


# -- the service plane's knobs (the JAX package's readers, value for value)


def parse_service():
    """``HYPEROPT_TPU_SERVICE=<port>`` (or ``<host>:<port>``): the bind
    value ``python -m hyperopt_tpu_torch.service.server`` takes when
    ``--port`` is absent, or None (unset, ``0``/``off``)."""
    raw = os.environ.get("HYPEROPT_TPU_SERVICE", "").strip()
    if raw.lower() in ("",) + _OFF:
        return None
    host, _, port_s = raw.rpartition(":")
    try:
        port = int(port_s)
    except ValueError:
        raise ValueError(f"HYPEROPT_TPU_SERVICE={raw!r}: expected a port or "
                         "host:port") from None
    if not 1 <= port <= 65535:
        raise ValueError(f"HYPEROPT_TPU_SERVICE={raw!r}: expected a port in [1, 65535]")
    return raw if host else port


def parse_service_wal():
    """``HYPEROPT_TPU_SERVICE_WAL``: ``"auto"`` (unset, ``1``/``on``/``auto``:
    journal under the store root when the scheduler has one), None
    (``0``/``off``: never) or an explicit journal path."""
    raw = os.environ.get("HYPEROPT_TPU_SERVICE_WAL", "").strip()
    if raw.lower() in ("", "1", "on", "true", "yes", "auto"):
        return "auto"
    if raw.lower() in _OFF:
        return None
    return raw


DEFAULT_SERVICE_DEADLINE_MS = 30000.0


def parse_service_deadline_ms():
    """``HYPEROPT_TPU_SERVICE_DEADLINE_MS``: the server's default request
    deadline in milliseconds (default 30000; ``0``/``off``: none)."""
    raw = os.environ.get("HYPEROPT_TPU_SERVICE_DEADLINE_MS", "").strip()
    if not raw:
        return DEFAULT_SERVICE_DEADLINE_MS
    if raw.lower() in _OFF:
        return None
    try:
        ms = float(raw)
    except ValueError:
        raise ValueError(f"HYPEROPT_TPU_SERVICE_DEADLINE_MS={raw!r}: expected "
                         "milliseconds or 0/off") from None
    if not ms > 0:
        raise ValueError(f"HYPEROPT_TPU_SERVICE_DEADLINE_MS={raw!r}: expected a "
                         "positive deadline")
    return ms


def parse_service_queue():
    """``HYPEROPT_TPU_SERVICE_QUEUE``: asks admitted (queued or in a wave)
    before new asks shed with 429 (default 256; tells at 4x)."""
    return _pos_int("HYPEROPT_TPU_SERVICE_QUEUE", 256)


DEFAULT_DEGRADE_RECOVER_WAVES = 8


def parse_service_degrade():
    """``HYPEROPT_TPU_SERVICE_DEGRADE``: the degrade ladder's patience,
    clean waves before it climbs a level (unset/``on``: 8, a positive
    integer), or None (``0``/``off``: a tick fault fails its asks)."""
    raw = os.environ.get("HYPEROPT_TPU_SERVICE_DEGRADE", "").strip().lower()
    if raw in ("", "on", "true", "yes", "auto"):
        return DEFAULT_DEGRADE_RECOVER_WAVES
    if raw in _OFF:
        return None
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(f"HYPEROPT_TPU_SERVICE_DEGRADE={raw!r}: expected a clean-wave "
                         "count or 0/off") from None
    if n < 1:
        raise ValueError(f"HYPEROPT_TPU_SERVICE_DEGRADE={raw!r}: expected a positive "
                         "clean-wave count")
    return n


def parse_reqtrace():
    """``HYPEROPT_TPU_REQTRACE``: request-trace ids on (default) or off
    (``0``/``off``)."""
    return os.environ.get("HYPEROPT_TPU_REQTRACE", "").strip().lower() not in _OFF


def parse_service_access_log():
    """``HYPEROPT_TPU_SERVICE_ACCESS_LOG=<path>``: the server's JSONL
    access log, or None (unset, ``0``/``off``)."""
    raw = os.environ.get("HYPEROPT_TPU_SERVICE_ACCESS_LOG", "").strip()
    if raw.lower() in ("",) + _OFF:
        return None
    return raw


def parse_service_slo():
    """``HYPEROPT_TPU_SERVICE_SLO``: the SLO plane's targets (unset/``on``:
    the defaults of ``obs/slo.py``; ``avail=99.9,ask_p99_ms=250,ask_pct=99,
    shed=2`` tunes them), or None (``0``/``off``).  An unknown token
    raises."""
    from .obs.slo import DEFAULT_TARGETS

    raw = os.environ.get("HYPEROPT_TPU_SERVICE_SLO", "").strip()
    if raw.lower() in _OFF:
        return None
    targets = {k: dict(v) for k, v in DEFAULT_TARGETS.items()}
    if raw.lower() in ("", "1", "on", "true", "yes", "auto"):
        return targets
    for token in raw.split(","):
        token = token.strip()
        if not token:
            continue
        key, _, val = token.partition("=")
        key = key.strip().lower()
        try:
            v = float(val)
        except ValueError:
            v = None
        if v is not None and key in ("avail", "availability") and 0 < v < 100:
            targets["availability"]["target"] = v / 100.0
        elif v is not None and key in ("ask_p99_ms", "ask_ms") and v > 0:
            targets["ask_latency"]["threshold_ms"] = v
        elif v is not None and key == "ask_pct" and 0 < v < 100:
            targets["ask_latency"]["target"] = v / 100.0
        elif v is not None and key == "shed" and 0 <= v < 100:
            targets["shed_rate"]["target"] = min(0.9999, 1.0 - v / 100.0)
        else:
            raise ValueError(f"HYPEROPT_TPU_SERVICE_SLO: bad token {token!r} (expected "
                             "avail=, ask_p99_ms=, ask_pct= or shed= with a sane value)")
    return targets


def parse_compile_plane():
    """``HYPEROPT_TPU_COMPILE_PLANE``: arm the compile plane (``1``/``on``;
    off by default).  In the port it keeps the signature census and
    builds the kernel libraries before a server listens."""
    raw = os.environ.get("HYPEROPT_TPU_COMPILE_PLANE", "").strip().lower()
    return raw in ("1", "on", "true", "yes", "auto")


DEFAULT_COMPILE_BANK_TOP_N = 8


def parse_compile_bank_top_n():
    """``HYPEROPT_TPU_COMPILE_BANK_TOP_N``: census keys whose cohort stacks
    the compile plane allocates before the listener opens (default 8)."""
    raw = os.environ.get("HYPEROPT_TPU_COMPILE_BANK_TOP_N", "").strip()
    if not raw:
        return DEFAULT_COMPILE_BANK_TOP_N
    try:
        v = int(raw)
    except ValueError:
        raise ValueError(f"HYPEROPT_TPU_COMPILE_BANK_TOP_N={raw!r}: expected an "
                         "integer") from None
    if v < 0:
        raise ValueError(f"HYPEROPT_TPU_COMPILE_BANK_TOP_N={raw!r}: expected a "
                         "non-negative integer")
    return v


DEFAULT_STORE_WATERMARK = 0.02


def parse_store_watermark():
    """``HYPEROPT_TPU_STORE_WATERMARK``: the low-disk threshold, a free
    fraction below 1 or a free byte count from 1 (default 0.02), or None
    (``0``/``off``)."""
    raw = os.environ.get("HYPEROPT_TPU_STORE_WATERMARK", "").strip()
    if not raw:
        return DEFAULT_STORE_WATERMARK
    if raw.lower() in _OFF:
        return None
    try:
        v = float(raw)
    except ValueError:
        raise ValueError(f"HYPEROPT_TPU_STORE_WATERMARK={raw!r}: expected a free "
                         "fraction, a byte count or 0/off") from None
    return v if v > 0 else None


def parse_store_gc():
    """``HYPEROPT_TPU_STORE_GC``: whether the disk-watermark rung may run
    the bounded store GC (default on; ``0``/``off``)."""
    return os.environ.get("HYPEROPT_TPU_STORE_GC", "").strip().lower() not in _OFF


# -- the serving planes' and the fleet's knobs (the JAX package's readers,
# value for value; a malformed value raises)


def parse_quality():
    """``HYPEROPT_TPU_QUALITY``: the scheduler's search-quality plane is
    armed (default on; ``0``/``off`` disarms it)."""
    return os.environ.get("HYPEROPT_TPU_QUALITY", "").strip().lower() not in _OFF


def _slo_tokens(var, targets, apply):
    """Fold ``key=number`` tokens of ``var`` into ``targets`` with
    ``apply(targets, key, value)``, which returns False for a token it
    does not take; a bad token raises."""
    raw = os.environ.get(var, "").strip()
    for token in raw.split(","):
        token = token.strip()
        if not token:
            continue
        key, _, val = token.partition("=")
        try:
            v = float(val)
        except ValueError:
            v = None
        if v is None or not apply(targets, key.strip().lower(), v):
            raise ValueError(f"{var}: bad token {token!r}")
    return targets


def _slo_targets(var, table):
    """The targets of an SLO knob: None for ``0``/``off``, a copy of
    ``table`` for unset/``on``, else None (tokens to fold)."""
    raw = os.environ.get(var, "").strip().lower()
    if raw in _OFF:
        return None, False
    targets = {k: dict(v) for k, v in table.items()}
    return targets, raw in ("", "1", "on", "true", "yes", "auto")


def parse_quality_slo():
    """``HYPEROPT_TPU_QUALITY_SLO``: the stagnant-fraction objective the
    server installs beside an armed quality plane (unset/``on``: the
    default; ``stagnant=N`` allows N percent of live tells on stagnant
    studies), or None (``0``/``off``)."""
    from .obs.slo import QUALITY_TARGETS

    targets, default = _slo_targets("HYPEROPT_TPU_QUALITY_SLO", QUALITY_TARGETS)
    if targets is None or default:
        return targets

    def apply(t, key, v):
        if key in ("stagnant", "stagnation") and 0 <= v < 100:
            t["stagnation"]["target"] = min(0.9999, 1.0 - v / 100.0)
            return True
        return False

    return _slo_tokens("HYPEROPT_TPU_QUALITY_SLO", targets, apply)


def parse_load():
    """``HYPEROPT_TPU_LOAD``: the scheduler's cost ledger is armed (default
    on; ``0``/``off`` disarms it)."""
    return os.environ.get("HYPEROPT_TPU_LOAD", "").strip().lower() not in _OFF


def parse_load_slo():
    """``HYPEROPT_TPU_LOAD_SLO``: the fleet-imbalance objective (unset/
    ``on``: the default; ``skew=N`` the heat-skew bound, above 1;
    ``balanced=N`` the percent of observations allowed over it), or None
    (``0``/``off``)."""
    from .obs.slo import LOAD_TARGETS

    targets, default = _slo_targets("HYPEROPT_TPU_LOAD_SLO", LOAD_TARGETS)
    if targets is None or default:
        return targets

    def apply(t, key, v):
        if key == "skew" and v > 1.0:
            t["imbalance"]["skew_max"] = v
        elif key == "balanced" and 0 <= v < 100:
            t["imbalance"]["target"] = min(0.9999, 1.0 - v / 100.0)
        else:
            return False
        return True

    return _slo_tokens("HYPEROPT_TPU_LOAD_SLO", targets, apply)


DEFAULT_FLEET_SHARDS = 8
DEFAULT_FLEET_LEASE_TTL = 15.0


def parse_fleet_shards():
    """``HYPEROPT_TPU_FLEET_SHARDS``: the study-shard count of a fleet
    store root (default 8; write-once per root)."""
    return _pos_int("HYPEROPT_TPU_FLEET_SHARDS", DEFAULT_FLEET_SHARDS)


def parse_fleet_lease_ttl():
    """``HYPEROPT_TPU_FLEET_LEASE_TTL``: seconds without a heartbeat after
    which a shard lease is reclaimable (default 15)."""
    raw = os.environ.get("HYPEROPT_TPU_FLEET_LEASE_TTL", "").strip()
    if not raw:
        return DEFAULT_FLEET_LEASE_TTL
    try:
        sec = float(raw)
    except ValueError:
        raise ValueError(f"HYPEROPT_TPU_FLEET_LEASE_TTL={raw!r}: expected a duration "
                         "in seconds") from None
    if not sec > 0:
        raise ValueError(f"HYPEROPT_TPU_FLEET_LEASE_TTL={raw!r}: expected a positive "
                         "duration")
    return sec


def parse_fleet_addr():
    """``HYPEROPT_TPU_FLEET_ADDR``: the URL a replica advertises in the
    ownership table, or None (unset, ``0``/``off``: the bound URL)."""
    raw = os.environ.get("HYPEROPT_TPU_FLEET_ADDR", "").strip()
    if raw.lower() in ("",) + _OFF:
        return None
    return raw.rstrip("/")


def parse_tenant():
    """``HYPEROPT_TPU_TENANT``: the scheduler's tenant ledger and its
    weighted-fair wave packer are armed (default on; ``0``/``off``)."""
    return os.environ.get("HYPEROPT_TPU_TENANT", "").strip().lower() not in _OFF


def parse_tenant_top_k():
    """``HYPEROPT_TPU_TENANT_TOP_K``: the tenant ledger's named-row bound
    (default 64)."""
    from .obs.tenant import DEFAULT_TOP_K

    return _pos_int("HYPEROPT_TPU_TENANT_TOP_K", DEFAULT_TOP_K)


def parse_tenant_quota():
    """``HYPEROPT_TPU_TENANT_QUOTA``: asks one tenant may hold admitted at
    once before it sheds, or None (unset, ``0``/``off``: no budget)."""
    raw = os.environ.get("HYPEROPT_TPU_TENANT_QUOTA", "").strip()
    if raw.lower() in ("",) + _OFF:
        return None
    try:
        q = int(raw)
    except ValueError:
        raise ValueError(f"HYPEROPT_TPU_TENANT_QUOTA={raw!r}: expected a positive "
                         "integer or 0/off") from None
    if q < 1:
        raise ValueError(f"HYPEROPT_TPU_TENANT_QUOTA={raw!r}: expected a positive "
                         "integer or 0/off")
    return q


def parse_tenant_slo():
    """``HYPEROPT_TPU_TENANT_SLO``: the per-tenant objectives (unset/``on``:
    the defaults; ``avail=``, ``ask_p=``, ``shed=`` a good fraction in
    (0, 1), ``ask_ms=`` the latency threshold), or None (``0``/``off``)."""
    from .obs.slo import TENANT_TARGETS

    targets, default = _slo_targets("HYPEROPT_TPU_TENANT_SLO", TENANT_TARGETS)
    if targets is None or default:
        return targets

    def apply(t, key, v):
        if key == "avail" and 0.0 < v < 1.0:
            t["availability"]["target"] = v
        elif key == "ask_p" and 0.0 < v < 1.0:
            t["ask_p99"]["target"] = v
        elif key == "ask_ms" and v > 0:
            t["ask_p99"]["threshold_ms"] = v
        elif key == "shed" and 0.0 < v < 1.0:
            t["shed_rate"]["target"] = v
        else:
            return False
        return True

    return _slo_tokens("HYPEROPT_TPU_TENANT_SLO", targets, apply)


# the observability knobs warn once and disable on a malformed value, as
# the JAX package's do: a telemetry setting never takes down the run
_warned_envs = set()


def _warn_once(var, raw, why):
    if var not in _warned_envs:
        _warned_envs.add(var)
        logger.warning("%s=%r is not %s; disabling (observability env "
                       "values warn-and-disable, never raise)", var, raw, why)


def parse_obs_http(env=None):
    """``HYPEROPT_TPU_OBS_HTTP=<port>`` (or ``<host>:<port>``) → the value
    for ``ObsConfig.http_port``, or None when unset, disabled or invalid.
    ``0`` in the environment means off (the ``obs_http=0`` argument binds
    an ephemeral port)."""
    env = os.environ if env is None else env
    raw = env.get("HYPEROPT_TPU_OBS_HTTP", "").strip()
    if raw.lower() in ("", "0", "off", "false", "no"):
        return None
    host, _, port_s = raw.rpartition(":")
    try:
        port = int(port_s)
    except ValueError:
        _warn_once("HYPEROPT_TPU_OBS_HTTP", raw, "an integer port (or host:port)")
        return None
    if not 1 <= port <= 65535:
        _warn_once("HYPEROPT_TPU_OBS_HTTP", raw, "a port in [1, 65535]")
        return None
    return raw if host else port


#: the device-memory sampler's period when ``HYPEROPT_TPU_DEVMEM`` is
#: ``1``/``on``
DEFAULT_DEVMEM_PERIOD_SEC = 10.0


def parse_devmem_period(env=None):
    """``HYPEROPT_TPU_DEVMEM=<seconds>`` → the device-memory sampler's
    period, or None when unset, disabled or invalid; ``1``/``on`` selects
    :data:`DEFAULT_DEVMEM_PERIOD_SEC`."""
    env = os.environ if env is None else env
    raw = env.get("HYPEROPT_TPU_DEVMEM", "").strip()
    if raw.lower() in ("", "0", "off", "false", "no"):
        return None
    if raw.lower() in ("1", "on", "true", "yes"):
        return DEFAULT_DEVMEM_PERIOD_SEC
    try:
        period = float(raw)
    except ValueError:
        _warn_once("HYPEROPT_TPU_DEVMEM", raw, "a sample period in seconds")
        return None
    if not period > 0:
        _warn_once("HYPEROPT_TPU_DEVMEM", raw, "a positive sample period")
        return None
    return period


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
    item: int | str | None
    read_in: str
    refused_at: tuple = ()
    arms: Callable[[str], bool] | None = None
    under: str | None = None


_SCHED = ("StudyScheduler",)
_SERVER = ("ServiceHTTPServer",)

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
    "HYPEROPT_TPU_SHARD": Knob("honoured", None, "algos/tpe, device_fmin.DeviceLoopRunner, "
                               "service/scheduler (parse_shard)"),
    "HYPEROPT_TPU_HIST_SHARD_MIN": Knob("honoured", None, "parallel/sharding "
                                        "(parse_hist_shard_min)"),
    "HYPEROPT_TPU_ALLGATHER_TIMEOUT": Knob("honoured", None, "parallel/driver "
                                           "(parse_allgather_timeout)"),
    "HYPEROPT_TPU_PAYLOAD": Knob("honoured", None, "parallel/payload (wire_format)"),
    "HYPEROPT_TPU_WATCHDOG": Knob("honoured", None, "obs/watchdog (the executor and the "
                                  "worker beat it, and so does fmin's loop)"),
    # the run's observability planes (obs.ObsConfig.from_env)
    "HYPEROPT_TPU_OBS": Knob("honoured", None, "fmin, fmin_multihost via "
                             "obs.ObsConfig (a path streams JSONL)"),
    "HYPEROPT_TPU_PROFILE": Knob("honoured", None, "fmin, fmin_multihost via "
                                 "obs.ObsConfig (torch.profiler captures; "
                                 "full:<dir> traces the whole run)"),
    "HYPEROPT_TPU_OBS_HTTP": Knob("honoured", None, "fmin, fmin_multihost via "
                                  "obs.ObsConfig (the scrape server)"),
    "HYPEROPT_TPU_DEVMEM": Knob("honoured", None, "fmin, fmin_multihost via "
                                "obs.ObsConfig (the device-memory sampler)"),
    "HYPEROPT_TPU_FLIGHT": Knob("honoured", None, "obs/flight and obs.ObsConfig "
                                "(0/off disables the recorder, a path pins "
                                "its dump file)"),
    # the kernel libraries: the port's only compiled artifacts
    "HYPEROPT_TPU_COMPILE_CACHE": Knob("honoured", None, "_build (where the nvcc "
                                       "libraries are built and loaded; fmin's "
                                       "compile_cache= sets it per process)"),
    "HYPEROPT_TPU_SERVICE": Knob("honoured", None, "service/server (parse_service)"),
    "HYPEROPT_TPU_SERVICE_WAL": Knob("honoured", None, "service/scheduler (parse_service_wal)"),
    "HYPEROPT_TPU_SERVICE_DEGRADE": Knob("honoured", None, "service/scheduler (the degrade "
                                         "ladder, on by default)"),
    "HYPEROPT_TPU_SERVICE_QUEUE": Knob("honoured", None, "service/overload (AdmissionGuard)"),
    "HYPEROPT_TPU_SERVICE_DEADLINE_MS": Knob("honoured", None, "service/server"),
    "HYPEROPT_TPU_SERVICE_ACCESS_LOG": Knob("honoured", None, "service/server"),
    "HYPEROPT_TPU_COMPILE_PLANE": Knob("honoured", None, "service/scheduler, "
                                       "service/server (the census and the kernel "
                                       "build before the listener)"),
    "HYPEROPT_TPU_COMPILE_BANK_TOP_N": Knob("honoured", None, "service/compile_plane"),
    "HYPEROPT_TPU_STORE_GC": Knob("honoured", None, "service/scheduler"),
    "HYPEROPT_TPU_STORE_WATERMARK": Knob("honoured", None, "service/scheduler"),
    "HYPEROPT_TPU_REQTRACE": Knob("honoured", None, "service/server, service/client"),
    "HYPEROPT_TPU_SERVICE_SLO": Knob("honoured", None, "service/server (obs/slo)"),
    "HYPEROPT_TPU_QUALITY": Knob("honoured", None, "service/scheduler (parse_quality; on "
                                 "by default)"),
    "HYPEROPT_TPU_LOAD": Knob("honoured", None, "service/scheduler (parse_load; on by "
                              "default)"),
    "HYPEROPT_TPU_TENANT": Knob("honoured", None, "service/scheduler (parse_tenant; on by "
                                "default)"),
    "HYPEROPT_TPU_TENANT_TOP_K": Knob("honoured", None, "service/scheduler "
                                      "(parse_tenant_top_k)"),
    "HYPEROPT_TPU_QUALITY_SLO": Knob("honoured", None, "service/server "
                                     "(parse_quality_slo)"),
    "HYPEROPT_TPU_LOAD_SLO": Knob("honoured", None, "service/server (parse_load_slo)"),
    "HYPEROPT_TPU_TENANT_SLO": Knob("honoured", None, "service/server (parse_tenant_slo)"),
    "HYPEROPT_TPU_TENANT_QUOTA": Knob("honoured", None, "service/overload "
                                      "(parse_tenant_quota)"),
    "HYPEROPT_TPU_FLEET_SHARDS": Knob("honoured", None, "service/fleet "
                                      "(parse_fleet_shards)"),
    "HYPEROPT_TPU_FLEET_LEASE_TTL": Knob("honoured", None, "service/fleet "
                                         "(parse_fleet_lease_ttl)"),
    "HYPEROPT_TPU_FLEET_ADDR": Knob("honoured", None, "service/server (parse_fleet_addr, "
                                    "for --fleet)"),
    # refused at the server: the blackbox prober
    "HYPEROPT_TPU_PROBE": Knob("refused", "14b", "service/server (the blackbox prober)",
                               _SERVER, lambda r: r.lower() in ("1", "on", "true", "yes")),
    "HYPEROPT_TPU_PROBE_PERIOD": Knob("refused", "14b", "obs/prober",
                                      under="HYPEROPT_TPU_PROBE"),
    "HYPEROPT_TPU_PROBE_SLO": Knob("refused", "14b", "service/server (with the prober)",
                                   under="HYPEROPT_TPU_PROBE"),
    # no counterpart: they tune XLA only (the port has no compilation
    # cache to disable: a kernel library is built once per source hash)
    "HYPEROPT_TPU_NO_CACHE": Knob("none", None, "fmin (the XLA compilation cache)"),
    "HYPEROPT_TPU_NO_DONATION": Knob("none", None, "algos/tpe (XLA buffer donation)"),
    "HYPEROPT_TPU_PALLAS": Knob("none", None, "megakernel, algos/tpe (a deprecated "
                                "alias routing EI through the Pallas kernel; the port's "
                                "EI always runs in its own kernel)"),
}


def refuse_armed_knobs(entry):
    """Raise ``not_ported(knob, item)`` for the first refused knob that
    ``entry`` (``"StudyScheduler"``, ``"ServiceHTTPServer"``) reads and
    that is set to a value arming it."""
    for name, knob in KNOBS.items():
        if entry in knob.refused_at:
            raw = os.environ.get(name, "").strip()
            if knob.arms(raw):
                raise not_ported(f"{name}={raw!r}", knob.item)
