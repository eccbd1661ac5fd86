"""The EI kernel's plain version against the JAX package's jnp twin
(``ei_diff_reference``) and its Pallas kernel run in interpret mode
(``_build_ei(n, m, interpret=True)``), plus the wrapper's routing and
checks.  The kernel itself runs only on the card: tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hyperopt_tpu import megakernel as ref_mk
from hyperopt_tpu_torch import megakernel

RTOL, ATOL = 1e-5, 1e-6


def _inputs(P, n, m, seed, dead=0):
    """x [P, n] and six component tables [P, m] from numpy; ``dead`` zero
    weights per row (they score -1e30)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3, 3, (P, n)).astype(np.float32)
    tabs = []
    for _ in range(2):
        w = rng.uniform(0.1, 1.0, (P, m)).astype(np.float32)
        w[:, m - dead:] = 0.0
        w /= w.sum(1, keepdims=True)
        mu = rng.normal(size=(P, m)).astype(np.float32)
        s = rng.uniform(0.2, 2.0, (P, m)).astype(np.float32)
        tabs += [w, mu, s]
    return x, tabs


def _ref_twin(x, tabs):
    return np.asarray(ref_mk.ei_diff_reference(jnp.asarray(x), *map(jnp.asarray, tabs)))


@pytest.mark.parametrize("n,m", [(24, 2), (24, 129), (1000, 17), (1024, 129)])
def test_plain_matches_reference_twin(n, m):
    x, tabs = _inputs(1, n, m, seed=n + m)
    got = megakernel.ei_diff_plain(torch.as_tensor(x), *map(torch.as_tensor, tabs))
    np.testing.assert_allclose(got.numpy()[0], _ref_twin(x[0], [t[0] for t in tabs]),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("m", [2, 17, 129])
def test_plain_matches_pallas_interpret(m):
    n = 1024
    x, tabs = _inputs(1, n, m, seed=m, dead=1 if m > 2 else 0)
    kern = ref_mk._build_ei(n, m, interpret=True)
    ref = np.asarray(kern(jnp.asarray(x[0]).reshape(n // 128, 128),
                          *(jnp.asarray(t[0]) for t in tabs))).reshape(n)
    got = megakernel.ei_diff_plain(torch.as_tensor(x), *map(torch.as_tensor, tabs))
    np.testing.assert_allclose(got.numpy()[0], ref, rtol=RTOL, atol=ATOL)


def test_dead_components_and_batch_rows():
    P, n, m = 5, 24, 17
    x, tabs = _inputs(P, n, m, seed=3, dead=6)
    got = megakernel.ei_diff(torch.as_tensor(x), *map(torch.as_tensor, tabs)).numpy()
    assert np.isfinite(got).all()
    for p in range(P):
        np.testing.assert_allclose(got[p], _ref_twin(x[p], [t[p] for t in tabs]),
                                   rtol=RTOL, atol=ATOL, err_msg=f"row {p}")


def test_cpu_tensors_take_the_plain_version_without_counting():
    x, tabs = _inputs(2, 24, 5, seed=1)
    before = megakernel.ei_diff.launches
    got = megakernel.ei_diff(torch.as_tensor(x), *map(torch.as_tensor, tabs))
    want = megakernel.ei_diff_plain(torch.as_tensor(x), *map(torch.as_tensor, tabs))
    assert torch.equal(got, want)
    assert megakernel.ei_diff.launches == before


def test_wrapper_rejects_bad_inputs():
    x, tabs = _inputs(2, 24, 5, seed=1)
    tx, tt = torch.as_tensor(x), [torch.as_tensor(t) for t in tabs]
    with pytest.raises(TypeError):
        megakernel.ei_diff(tx.double(), *tt)
    with pytest.raises(ValueError):
        megakernel.ei_diff(tx[0], *tt)
    with pytest.raises(ValueError):
        megakernel.ei_diff(tx, *tt[:5], tt[5][:, :3])
    with pytest.raises(ValueError):
        megakernel.ei_diff(tx[:1], *tt)

