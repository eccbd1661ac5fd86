"""Lean wire formats for the multi-controller per-generation exchange
(counterpart of ``hyperopt_tpu/parallel/payload.py``; the bytes are the
same for the same rows).

Each generation, every controller evaluates its round-robin shard of the
proposal batch and must ship the results — raw losses plus the per-label
active masks of conditional params — to every other controller
(``driver.fmin_multihost``).  The naive encoding is float32 rows
``[vals... are already known globally, so: active(L) as 0/1 floats, loss,
evaluated flag]`` = ``4 * (L + 2)`` bytes per trial.  The lean encoding
packs the ``L + 1`` boolean flags into a uint8 bitfield and keeps the loss
as its own narrow f32 column:

* ``f32`` rows: ``[W, L + 2]`` float32 — ``4L + 8`` bytes/trial
* ``u8`` rows:  4 loss bytes + ``ceil((L+1)/8)`` mask bytes/trial

For an 8-label space that is 40 → 6 bytes per trial (>6x; ≥2x for any L).
The fold is the same whichever encoding delivered the rows, so the lean
form is the default.  ``HYPEROPT_TPU_PAYLOAD=f32`` selects the wide debug rows
(same homogeneous-endianness assumption — both formats byte-view f32).

Both forms serialize to ONE uint8 buffer per controller (``to_wire``) so a
generation costs a single allgather whatever the format.  Byte views of
f32 assume a homogeneous (little-endian in practice) controller fleet —
the same assumption ``torch.distributed`` makes about tensor bytes.

The ``evaluated`` flag marks real rows: controller shards pad to a common
width so allgather shapes agree, and padding rows must never fold (their
loss bytes are arbitrary).
"""

from __future__ import annotations

import os

import numpy as np

__all__ = [
    "wire_format",
    "mask_nbytes",
    "row_nbytes",
    "to_wire",
    "from_wire",
    "fold_generation",
]


def wire_format(env=None):
    """``"u8"`` (default, lean) or ``"f32"`` (wide debug rows), from
    ``HYPEROPT_TPU_PAYLOAD``."""
    env = os.environ if env is None else env
    fmt = env.get("HYPEROPT_TPU_PAYLOAD", "u8").strip().lower() or "u8"
    if fmt not in ("u8", "f32"):
        raise ValueError(
            f"HYPEROPT_TPU_PAYLOAD must be 'u8' or 'f32', got {fmt!r}")
    return fmt


def mask_nbytes(L):
    """Bitfield bytes per trial: L active bits + 1 evaluated bit."""
    return (L + 1 + 7) // 8


def row_nbytes(L, fmt="u8"):
    """Wire bytes per trial row."""
    if fmt == "f32":
        return 4 * (L + 2)
    return 4 + mask_nbytes(L)


def to_wire(losses, active, evaluated, fmt="u8"):
    """Encode one controller's padded result shard as a ``uint8 [W,
    row_nbytes]`` buffer (ONE collective per generation).

    ``losses``: f32 [W] raw losses (NaN = failed trial; arbitrary on
    padding rows); ``active``: bool [W, L]; ``evaluated``: bool [W] —
    False marks padding rows appended to equalize shard widths.
    """
    losses = np.ascontiguousarray(losses, np.float32)
    active = np.asarray(active, bool)
    evaluated = np.asarray(evaluated, bool)
    W, L = active.shape
    if fmt == "f32":
        rows = np.empty((W, L + 2), np.float32)
        rows[:, :L] = active  # 0/1 floats — the wide legacy encoding
        rows[:, L] = losses
        rows[:, L + 1] = evaluated
        return np.ascontiguousarray(rows).view(np.uint8).reshape(
            W, 4 * (L + 2))
    bits = np.zeros((W, L + 1), bool)
    bits[:, :L] = active
    bits[:, L] = evaluated
    out = np.empty((W, row_nbytes(L, "u8")), np.uint8)
    out[:, :4] = losses.view(np.uint8).reshape(W, 4)
    out[:, 4:] = np.packbits(bits, axis=1)
    return out


def from_wire(buf, L, fmt="u8"):
    """Invert :func:`to_wire`: ``(losses f32 [W], active bool [W, L],
    evaluated bool [W])``.  Loss bytes round-trip exactly (bit pattern,
    incl. NaN payloads — the fold digest depends on it)."""
    buf = np.ascontiguousarray(buf, np.uint8)
    W = buf.shape[0]
    if fmt == "f32":
        rows = buf.reshape(W, -1).view(np.float32).reshape(W, L + 2)
        return (rows[:, L].copy(), rows[:, :L] != 0.0, rows[:, L + 1] != 0.0)
    losses = buf[:, :4].copy().view(np.float32).reshape(W)
    bits = np.unpackbits(buf[:, 4:], axis=1, count=L + 1).astype(bool)
    return losses, bits[:, :L], bits[:, L]


def fold_generation(hist, raw_losses, start, labels, flats, losses,
                    active_rows):
    """Fold one generation's results into the padded numpy history, global
    trial-id order — the ONE fold both wire formats (and the single-process
    path) share, so "bitwise-identical fold" is true by construction and
    pinned by test on top.

    ``hist``: the driver's padded SoA dict; ``raw_losses``: the raw
    as-evaluated loss array (digest replay source); ``flats``: ``{label:
    f32 [B]}`` packed proposals (globally known); ``losses``: f32 [B] raw;
    ``active_rows``: bool [B, L] in ``labels`` order.
    """
    B = len(losses)
    end = start + B
    ok = np.isfinite(losses)
    hist["losses"][start:end] = np.where(ok, losses, np.inf).astype(np.float32)
    hist["has_loss"][start:end] = ok
    raw_losses[start:end] = losses
    for j, l in enumerate(labels):
        hist["vals"][l][start:end] = np.asarray(flats[l], np.float32)
        hist["active"][l][start:end] = active_rows[:, j]
