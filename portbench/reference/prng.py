"""threefry2x32 keys and draws (the counter-based generator of
``jax.random`` under ``jax_threefry_partitionable``), written from the
algorithm: a key is two 32-bit words held in int64 lanes, a draw of
``n`` words is the cipher of each element's flat index ``(hi, lo)``,
and a 32-bit word is the XOR of the cipher's two outputs.  Uniforms are
kept in float64: the 23 random mantissa bits give the same ``[0, 1)``
grid as the float32 draw, so only the scaling to ``[lo, hi)`` differs,
by under half a float32 ulp."""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry(k0, k1, x0, x1):
    """20 rounds of threefry2x32 on broadcast int64 lanes holding uint32."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) & M32) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def key(seed, device="cpu"):
    """The key of a 32-bit seed: words ``(0, seed)``; ``seed`` may be a
    tensor of seeds."""
    s = torch.as_tensor(seed, dtype=torch.int64, device=device) & M32
    return torch.stack([torch.zeros_like(s), s], -1)


def fold_in(k, data):
    """The cipher of the count ``(0, data)`` under ``k``; ``data`` (an int
    or an int64 tensor) broadcasts against the key's leading dims."""
    d = torch.as_tensor(data, dtype=torch.int64, device=k.device) & M32
    b0, b1 = threefry(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    b0, b1 = torch.broadcast_tensors(b0, b1)
    return torch.stack([b0, b1], -1)


def split(k, i):
    """The ``i``-th key of a split of ``k`` (the cipher of ``(0, i)``)."""
    return fold_in(k, i)


def bits(k, n):
    """``n`` 32-bit words per key: ``[..., n]``."""
    idx = torch.arange(n, dtype=torch.int64, device=k.device)
    b0, b1 = threefry(k[..., 0, None], k[..., 1, None], idx >> 32, idx & M32)
    return b0 ^ b1


def f32(v):
    """A Python number rounded to float32, as a float."""
    return float(np.float32(v))


def unit(k, n=None):
    """Uniforms on the float32 grid of ``[0, 1)``: the word's top 23 bits
    over 2**23; ``n=None`` draws one per key (the flat index 0)."""
    w = bits(k, 1 if n is None else n)
    u = (w >> 9).to(torch.float64) / 2.0 ** 23
    return u[..., 0] if n is None else u


def uniform(k, lo, hi, n=None):
    """``max(lo, lo + u * (hi - lo))`` with float32 bounds, in float64."""
    lo, hi = f32(lo), f32(hi)
    return torch.clamp(unit(k, n) * (hi - lo) + lo, min=lo)


def randint(k, lo, hi):
    """One integer in ``[lo, hi)`` per key: two words from the halves of
    a split, combined modulo the span in uint32 arithmetic."""
    higher = bits(split(k, 0), 1)[..., 0]
    lower = bits(split(k, 1), 1)[..., 0]
    span = max(int(hi) - int(lo), 1) & M32
    mult = (2 ** 16) % span
    mult = (mult * mult) % span
    off = ((((higher % span) * mult) & M32) + lower % span) & M32
    return int(lo) + off % span


def seed_words(seed):
    """(low, high) 32-bit words of an integer seed."""
    return int(seed) & M32, (int(seed) >> 32) & M32


def label_hash(label):
    """The 31-bit CRC32 of a label's UTF-8 bytes that folds it into keys."""
    import zlib

    return zlib.crc32(label.encode("utf-8")) & 0x7FFFFFFF
