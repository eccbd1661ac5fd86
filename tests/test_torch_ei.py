"""The EI kernel's plain version against the JAX package's jnp twin
(``ei_diff_reference``) and its Pallas kernel run in interpret mode
(``_build_ei(n, m, interpret=True)``), a float32 numpy model of the CUDA
kernel's arithmetic (``csrc/mixture_lse.cuh``: base-2 constants, the
one-exp carry, the component axis split and merged) against the same
twin, plus the wrapper's routing and checks.  The kernel itself runs only
on the card: tests/test_torch_cuda.py."""

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



# ---------------------------------------------------------------------------
# a float32 model of the kernel's arithmetic (csrc/mixture_lse.cuh, ei_diff.cu)
# ---------------------------------------------------------------------------

F32 = np.float32
LOG2E, LN2 = F32(1.4426950408889634), F32(0.6931471805599453)
DEAD2 = F32(-1.4426950408889634e30)
SQRT_HALF_LOG2E = F32(0.8493218002880191)
LOG_SQRT_2PI = F32(0.9189385332046727)


def _fma(a, b, c):
    return (np.float64(a) * b + c).astype(F32)


def _carry(x, c, k, mu, lo, hi):
    """One block's (mx, se) over components [lo, hi): t = c - ((x - mu) k)^2,
    one exp2 per term."""
    mx, se = np.full(x.shape, -np.inf, F32), np.zeros(x.shape, F32)
    for i in range(lo, hi):
        y = ((x - mu[i]) * k[i]).astype(F32)
        t = _fma(-y, y, c[i])
        d = (t - mx).astype(F32)
        e = np.exp2(-np.abs(d)).astype(F32)
        up = d > 0
        se = _fma(se, np.where(up, e, F32(1)), np.where(up, F32(1), e))
        mx = np.maximum(mx, t)
    return mx, se


def _merge(a, b):
    (mx1, se1), (mx2, se2) = a, b
    M = np.maximum(mx1, mx2)
    with np.errstate(invalid="ignore"):
        s1 = np.where(se1 > 0, se1 * np.exp2(mx1 - M), F32(0))
        s2 = np.where(se2 > 0, se2 * np.exp2(mx2 - M), F32(0))
    return np.where(se1 > 0, M, mx2).astype(F32), (s1 + s2).astype(F32)


def _kernel_model(x, tabs, splits):
    """``ei_diff`` of one row as the kernel computes it, with the component
    axis split into ``splits`` blocks (at most m) and their carries merged."""
    m = tabs[0].shape[0]
    splits = min(splits, m)
    lse = []
    for w, mu, s in (tabs[:3], tabs[3:]):
        with np.errstate(divide="ignore"):
            logw = np.log(np.maximum(w, F32(1e-12)))
        c = np.where(w > 0, LOG2E * ((logw - np.log(s)) - LOG_SQRT_2PI), DEAD2).astype(F32)
        k = (SQRT_HALF_LOG2E / s).astype(F32)
        acc = None
        for sp in range(splits):
            part = _carry(x, c, k, mu, m * sp // splits, m * (sp + 1) // splits)
            acc = part if acc is None else _merge(acc, part)
        lse.append(acc[0] + np.log2(acc[1]))
    return (LN2 * (lse[0] - lse[1])).astype(F32)


def _case(case):
    """(x [n], six tables [m]) of one model case."""
    if case == "m1":
        x, tabs = _inputs(1, 200, 1, seed=11)
    elif case == "dead":
        x, tabs = _inputs(1, 300, 17, seed=12, dead=6)
    elif case == "all_dead_below":
        x, tabs = _inputs(1, 300, 33, seed=13)
        tabs[0][:] = 0.0
    elif case == "far":
        # every candidate 20 sigma or more from every component; the below
        # mixture narrower than the above, as a fit to the best trials is,
        # so that EI is not a difference of two nearly equal log-densities
        # (whose float32 rounding no float32 evaluation escapes)
        x, tabs = _inputs(1, 256, 65, seed=14)
        tabs[2] = (0.2 + 0.3 * (tabs[2] - 0.2) / 1.8).astype(F32)
        tabs[5] = (1.0 + (tabs[5] - 0.2) / 1.8).astype(F32)
        reach = max(np.abs(tabs[i]).max() + 20 * tabs[i + 1].max() for i in (1, 4))
        x = np.where(x >= 0, reach + x, -reach + x).astype(F32)
    else:
        x, tabs = _inputs(1, 512, 129, seed=15)
    return x[0], [t[0] for t in tabs]


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("case", ["mixed", "dead", "all_dead_below", "far", "m1"])
def test_kernel_arithmetic_matches_reference_twin(case, splits):
    x, tabs = _case(case)
    got = _kernel_model(x, tabs, splits)
    want = _ref_twin(x, tabs)
    # the twin marks dead components -inf, the kernels the stand-in -1e30
    want = np.where(np.isneginf(want), F32(-1e30), want)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the card's tolerance, as chip_smoke.py and tests/test_torch_cuda.py hold it
    assert (np.abs(got - want) <= 1e-4 * np.maximum(1.0, np.abs(want))).all()
