"""The port's float32 ``erf`` and ``ndtri`` against the JAX package's
(``jax.lax.erf`` and ``jax.scipy.special.ndtri`` as XLA compiles them on
the CPU), measured on 10^6 points.  ``erf`` is bitwise: the port computes
XLA's clamped rational form with its FMAs.  ``ndtri`` is Cephes' formula
term for term; its tail branch still goes through torch's ``log``, which
differs from XLA's by an ulp on some inputs, so the test pins the
bitwise share and the largest ulp gap, and prints them with
``torch.special.ndtri``'s for comparison (``pytest -s``)."""

import numpy as np
import torch

import jax
import jax.numpy as jnp
from jax.scipy.special import ndtri as jax_ndtri

from hyperopt_tpu_torch.algos import tpe


def _ulps(a, b):
    """Distance in float32 units in the last place (ordered bit patterns)."""
    def ordered(x):
        i = x.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def test_erf_is_xlas_float32_erf():
    z = np.linspace(-6, 6, 10**6).astype(np.float32)
    want = np.asarray(jax.jit(jax.lax.erf)(jnp.asarray(z)))
    got = tpe.erf(torch.from_numpy(z)).numpy()
    before = _ulps(torch.erf(torch.from_numpy(z)).numpy(), want)
    print(f"erf on 1e6 points in [-6, 6]: torch.erf bitwise {np.mean(before == 0):.6f}, "
          f"max {before.max()} ulp; port bitwise {np.mean(got == want):.6f}")
    np.testing.assert_array_equal(got, want)


def test_ndtri_follows_jax_ndtri():
    p = np.linspace(1e-7, 1 - 1e-7, 10**6).astype(np.float32)
    want = np.asarray(jax.jit(jax_ndtri)(jnp.asarray(p)))
    got = _ulps(tpe.ndtri(torch.from_numpy(p)).numpy(), want)
    before = _ulps(torch.special.ndtri(torch.from_numpy(p)).numpy(), want)
    print(f"ndtri on 1e6 points in [1e-7, 1-1e-7]: torch.special.ndtri bitwise "
          f"{np.mean(before == 0):.6f}, max {before.max()} ulp; port bitwise "
          f"{np.mean(got == 0):.6f}, max {got.max()} ulp")
    assert np.mean(got == 0) >= 0.94 and got.max() <= 6
    central = (p > np.float32(np.exp(-2.0))) & (p < np.float32(-np.expm1(-2.0)))
    assert (got[central] == 0).all()  # the central rational branch is exact
