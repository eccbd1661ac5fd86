"""Counter-based threefry2x32 keys and draws, bit-compatible with ``jax.random``.

Counterpart of the ``jax.random`` calls the JAX package makes (``PRNGKey``,
``fold_in``, ``split``, ``uniform``, ``normal``, ``randint``,
``categorical``) under ``jax_threefry_partitionable=True``: a draw of shape
``S`` is threefry2x32 over the (hi, lo) words of each element's flat index
in ``S``, and a 32-bit draw is ``bits1 ^ bits2``.  Keys, uniforms, integer
draws and normals (XLA's float32 ``erfinv``) match jax bit for bit;
``categorical`` goes through torch's ``log`` and matches to a few ulp.

A key is an int64 tensor ``[..., 2]`` holding two uint32 words.  Every
function broadcasts over the leading key dimensions, which is how the
port writes out what the JAX package does with ``vmap`` over keys.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .utils import device_constant

__all__ = [
    "PRNGKey",
    "fold_in",
    "split",
    "random_bits",
    "uniform",
    "normal",
    "randint",
    "categorical",
    "seed_words",
]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_SQRT2_F32 = float(np.float32(np.sqrt(2.0)))
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_F32_TINY = float(np.finfo(np.float32).tiny)


def _words(x, device):
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _M32


def threefry2x32(key, x0, x1):
    """The threefry2x32 block cipher (20 rounds) of count words ``(x0, x1)``
    under ``key``; all operands broadcast, words live in int64 lanes."""
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def PRNGKey(seed, device=None):
    """``jax.random.PRNGKey`` for a 32-bit seed: the words ``(0, seed)``."""
    seed = _words(seed, device)
    return torch.stack([torch.zeros_like(seed), seed], dim=-1)


def fold_in(key, data):
    """``jax.random.fold_in``: threefry of the count ``(0, data)``; ``data``
    broadcasts against the key's leading dimensions.  An integer ``data``
    enters the cipher as a Python word, so no tensor is made for it."""
    if isinstance(data, (int, np.integer)):
        b0, b1 = threefry2x32(key, 0, int(data) & _M32)
        return torch.stack((b0, b1), dim=-1)
    data = _words(data, key.device)
    b0, b1 = threefry2x32(key, torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(b0, b1), dim=-1)


def split(key, num=2):
    """``jax.random.split``: ``[..., num, 2]`` keys, the i-th being threefry
    of the count ``(0, i)``."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key[..., None, :], torch.zeros_like(i), i)
    return torch.stack(torch.broadcast_tensors(b0, b1), dim=-1)


def random_bits(key, shape):
    """32-bit draws ``[..., *shape]`` (int64 lanes holding uint32)."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key[..., None, :], idx >> 32, idx & _M32)
    return (b0 ^ b1).reshape(key.shape[:-1] + shape)


def _bcast(v, nd, device):
    """A per-key bound (scalar or ``[...]``) shaped to broadcast against a
    ``[..., *shape]`` draw with ``nd`` trailing dims; a Python bound is a
    cached device constant."""
    if torch.is_tensor(v):
        v = v.to(dtype=torch.float32, device=device)
    else:
        v = device_constant(float(v), torch.float32, device)
    return v.reshape(v.shape + (1,) * nd)


def uniform(key, shape=(), minval=0.0, maxval=1.0):
    """``jax.random.uniform`` in float32: 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled to ``[minval, maxval)``.

    XLA contracts the scaling ``f * (hi - lo) + lo`` into one fused
    multiply-add.  The float64 product of two float32 values is exact, so
    one float64 add rounded to float32 gives the same bits."""
    shape = tuple(shape)
    bits = random_bits(key, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = _bcast(minval, len(shape), key.device)
    hi = _bcast(maxval, len(shape), key.device)
    scaled = (f.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


# XLA's float32 erfinv (Giles' single-precision form): a degree-8
# polynomial in w - 2.5 (w < 5) or sqrt(w) - 3, w = -log1p(-x^2)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
# XLA's float32 log1p below |x| < sqrt(2) - 1: Cephes' rational form
# x - x^2/2 + x^3 P(x)/Q(x)
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
            6.5787325942061044846969e0, 2.9911919328553073277375e1,
            6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
            2.2176239823732856465394e2, 3.0909872225312059774938e2,
            2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOG1P_SMALL = float(np.float32(0.41421356237309504880))


def _log1p_xla(x):
    """float32 ``log1p`` of ``x`` in ``(-1, 0]`` as XLA's CPU code computes
    it (bitwise): Cephes' rational form near 0 (Horner steps as fused
    multiply-adds, ``-x^2/2`` fused into the last product), ``log(1 + x)``
    by XLA's ``log`` elsewhere."""
    from .algos.tpe import _fma, _horner, xla_log

    p, q = _horner((_LOG1P_P, _LOG1P_Q), x[None])
    x2 = x * x
    small = x + _fma(x2, -0.5, (x * x2) * (p / q))
    one_px = x + 1.0
    large = xla_log(torch.where(one_px > 0, one_px, torch.ones_like(one_px)))
    return torch.where(x.abs() < _LOG1P_SMALL, small, large)


def _erfinv_xla(u):
    """float32 ``erfinv`` of ``u`` in ``(-1, 1)`` as XLA's CPU code computes
    ``lax.erf_inv`` (bitwise): each Horner step a fused multiply-add, the
    two polynomials evaluated at the same point and the branch selected
    after."""
    from .algos.tpe import _horner, xla_sqrt

    w = -_log1p_xla(u * -u)
    lt5 = w < 5.0
    z = torch.where(lt5, w - 2.5, xla_sqrt(w) - 3.0)
    lo, hi = _horner((_ERFINV_LT5, _ERFINV_GE5), z[None])
    return torch.where(lt5, lo, hi) * u


def normal(key, shape=()):
    """``jax.random.normal``: ``sqrt(2) * erfinv(U(nextafter(-1, 0), 1))``,
    with XLA's float32 ``erfinv`` (bitwise)."""
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    return _erfinv_xla(u) * _SQRT2_F32


def randint(key, shape, minval, maxval):
    """``jax.random.randint`` (int32 semantics): two 32-bit draws from the
    two halves of ``split(key)``, combined modulo the span exactly as
    ``jax._src.random._randint`` does in uint32 arithmetic."""
    shape = tuple(shape)
    ks = split(key)
    higher = random_bits(ks[..., 0, :], shape)
    lower = random_bits(ks[..., 1, :], shape)
    lo, hi = (v.to(dtype=torch.int64, device=key.device) if torch.is_tensor(v)
              else device_constant(int(v), torch.int64, key.device)
              for v in (minval, maxval))
    lo = lo.reshape(lo.shape + (1,) * len(shape))
    hi = hi.reshape(hi.shape + (1,) * len(shape))
    span = torch.where(hi <= lo, torch.ones_like(hi), (hi - lo) & _M32)
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _M32) % span
    off = ((((higher % span) * mult) & _M32) + lower % span) & _M32
    return lo + off % span


def categorical(key, logits, shape=()):
    """``jax.random.categorical`` with replacement: ``[..., *shape]`` draws,
    each the argmax of ``logits[..., K]`` plus low-mode Gumbel noise."""
    shape = tuple(shape)
    K = logits.shape[-1]
    u = uniform(key, shape + (K,), _F32_TINY, 1.0)
    logits = logits.reshape(logits.shape[:-1] + (1,) * len(shape) + (K,))
    return torch.argmax(-torch.log(-torch.log(u)) + logits, dim=-1)


def seed_words(seed):
    """(low 32 bits, high 32 bits) of an integer seed — the tick's key is
    ``fold_in(PRNGKey(low), high)`` (the JAX package's ``tpe._seed_words``
    and ``rand.seed_to_key``)."""
    seed = int(seed)
    return seed & _M32, (seed >> 32) & _M32
