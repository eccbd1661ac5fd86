"""The port's float32 ``erf``, ``log``, ``sqrt`` and ``ndtri`` against the
JAX package's (``jax.lax.erf``, ``jnp.log``, ``jnp.sqrt`` and
``jax.scipy.special.ndtri`` as XLA compiles them on the CPU), each on 10^6
points, all bitwise: the port computes XLA's forms with their FMAs.  Each
test prints torch's own function's bitwise share beside the port's for
comparison (``pytest -s``).  The last test counts the operators each
one runs per call: on the card, each is a launch of the sequential ask.
"""

import numpy as np
import pytest
import torch
import torch.utils._python_dispatch

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


def test_log_is_xlas_float32_log():
    # positive normal inputs, the only ones ndtri gives it
    x = np.concatenate([np.geomspace(1e-7, 1.0, 5 * 10**5), np.geomspace(1.0, 64.0, 5 * 10**5)])
    x = x.astype(np.float32)
    want = np.asarray(jax.jit(jnp.log)(jnp.asarray(x)))
    got = tpe.xla_log(torch.from_numpy(x)).numpy()
    before = torch.log(torch.from_numpy(x)).numpy()
    print(f"log on 1e6 points in [1e-7, 64]: torch.log bitwise {np.mean(before == want):.6f}; "
          f"port bitwise {np.mean(got == want):.6f}")
    np.testing.assert_array_equal(got, want)


def test_sqrt_is_xlas_float32_sqrt():
    x = np.linspace(1.0, 64.0, 10**6).astype(np.float32)
    want = np.asarray(jax.jit(jnp.sqrt)(jnp.asarray(x)))
    got = tpe.xla_sqrt(torch.from_numpy(x)).numpy()
    before = torch.sqrt(torch.from_numpy(x)).numpy()
    print(f"sqrt on 1e6 points in [1, 64]: torch.sqrt bitwise {np.mean(before == want):.6f}; "
          f"port bitwise {np.mean(got == want):.6f}")
    np.testing.assert_array_equal(got, want)


def test_ndtri_follows_jax_ndtri():
    p = np.linspace(1e-7, 1 - 1e-7, 10**6).astype(np.float32)
    want = np.asarray(jax.jit(jax_ndtri)(jnp.asarray(p)))
    got = _ulps(tpe.ndtri(torch.from_numpy(p)).numpy(), want)
    before = _ulps(torch.special.ndtri(torch.from_numpy(p)).numpy(), want)
    print(f"ndtri on 1e6 points in [1e-7, 1-1e-7]: torch.special.ndtri bitwise "
          f"{np.mean(before == 0):.6f}, max {before.max()} ulp; port bitwise "
          f"{np.mean(got == 0):.6f}, max {got.max()} ulp")
    assert (got == 0).all(), f"{np.mean(got == 0)} bitwise, max {got.max()} ulp"


class _CountOps(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the operators a call runs, views aside: on a CUDA tensor each
    is one kernel launch."""

    _VIEWS = {"view", "_unsafe_view", "select", "unbind", "slice", "alias", "detach",
              "expand", "unsqueeze", "squeeze"}

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ not in self._VIEWS:
            self.n += 1
        return func(*args, **(kwargs or {}))


# a sequential ask is a chain of ~1,700 such launches, paid for on the host
@pytest.mark.parametrize("name,fn,limit", [("ndtri", tpe.ndtri, 180), ("erf", tpe.erf, 35),
                                           ("xla_log", tpe.xla_log, 50)])
def test_special_function_stays_lean(name, fn, limit):
    x = torch.rand(2, 1024, generator=torch.Generator().manual_seed(0)) * 0.98 + 0.01
    with _CountOps() as count:
        fn(x)
    print(f"{name}: {count.n} operators per call")
    assert count.n <= limit
