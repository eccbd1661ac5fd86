"""The port's threefry PRNG against ``jax.random``: keys, uniforms and
integer draws and normals bit for bit; categorical to a few ulp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperopt_tpu.algos import rand as ref_rand
from hyperopt_tpu.algos import tpe as ref_tpe
from hyperopt_tpu_torch import prng
from hyperopt_tpu_torch.algos import rand

SEEDS = [0, 1, 123456789, 2**32 - 1]


def _np(k):
    return np.asarray(k).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_bitwise(seed):
    jk, pk = jax.random.PRNGKey(seed), prng.PRNGKey(seed, "cpu")
    np.testing.assert_array_equal(_np(jk), pk.numpy())
    for d in (0, 7, 2**31 - 1, 0x9B10B, 2**32 - 1):
        np.testing.assert_array_equal(_np(jax.random.fold_in(jk, d)),
                                      prng.fold_in(pk, d).numpy())
    for num in (2, 5):
        np.testing.assert_array_equal(_np(jax.random.split(jk, num)),
                                      prng.split(pk, num).numpy())


@pytest.mark.parametrize("shape", [(), (7,), (3, 5), (1000,)])
def test_uniform_bitwise(shape):
    rng = np.random.default_rng(len(shape))
    for seed in SEEDS:
        jk, pk = jax.random.PRNGKey(seed), prng.PRNGKey(seed, "cpu")
        lo, hi = sorted(rng.uniform(-20, 20, 2).astype(np.float32).tolist())
        for a, b in ((0.0, 1.0), (lo, hi), (-5.0, 10.0)):
            ref = np.asarray(jax.random.uniform(jk, shape, minval=a, maxval=b))
            got = prng.uniform(pk, shape, a, b).numpy()
            assert ref.shape == got.shape
            np.testing.assert_array_equal(ref.view(np.int32), got.view(np.int32))


def test_uniform_batched_keys_and_bounds_bitwise():
    ids = np.arange(9, dtype=np.uint32) * 977
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(3), i))(jnp.asarray(ids))
    pkeys = prng.fold_in(prng.PRNGKey(3, "cpu"), torch.as_tensor(ids.astype(np.int64)))
    np.testing.assert_array_equal(_np(keys), pkeys.numpy())
    lo = np.linspace(-3, 2, 9).astype(np.float32)
    hi = lo + np.linspace(0.5, 7, 9).astype(np.float32)
    ref = jax.vmap(lambda k, a, b: jax.random.uniform(k, (4,), minval=a, maxval=b))(
        keys, jnp.asarray(lo), jnp.asarray(hi))
    got = prng.uniform(pkeys, (4,), torch.as_tensor(lo), torch.as_tensor(hi))
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("lo,hi", [(0, 2), (3, 17), (-4, 5), (0, 100000)])
def test_randint_bitwise(lo, hi):
    for seed in SEEDS:
        jk, pk = jax.random.PRNGKey(seed), prng.PRNGKey(seed, "cpu")
        for shape in ((), (64,)):
            ref = np.asarray(jax.random.randint(jk, shape, lo, hi))
            np.testing.assert_array_equal(ref, prng.randint(pk, shape, lo, hi).numpy())


def test_normal_and_categorical_at_tolerance():
    logits = np.log(np.asarray([0.1, 0.2, 0.3, 0.4], np.float32))
    for seed in SEEDS:
        jk, pk = jax.random.PRNGKey(seed), prng.PRNGKey(seed, "cpu")
        np.testing.assert_allclose(np.asarray(jax.random.normal(jk, (500,))),
                                   prng.normal(pk, (500,)).numpy(),
                                   rtol=1e-5, atol=1e-6)
        ref = np.asarray(jax.random.categorical(jk, jnp.asarray(logits), shape=(200,)))
        got = prng.categorical(pk, torch.as_tensor(logits), (200,)).numpy()
        np.testing.assert_array_equal(ref, got)


def test_normal_bitwise():
    """``normal`` carries XLA's float32 ``erfinv`` and ``log1p``: 2**18
    draws per seed equal jax's bit for bit, tails (``w >= 5``) included."""
    for seed in SEEDS:
        want = np.asarray(jax.jit(lambda k: jax.random.normal(k, (2**18,)))(
            jax.random.PRNGKey(seed)))
        got = prng.normal(prng.PRNGKey(seed, "cpu"), (2**18,)).numpy()
        assert (np.abs(want) > 2.95).sum() > 100  # the w >= 5 branch ran
        np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("seed", [0, 2**31 - 1, 2**40 + 12345, 2**63 - 1])
def test_seed_to_key_and_seed_words(seed):
    np.testing.assert_array_equal(np.asarray(ref_tpe._seed_words(seed)).astype(np.int64),
                                  np.asarray(prng.seed_words(seed)))
    np.testing.assert_array_equal(_np(ref_rand.seed_to_key(seed)),
                                  rand.seed_to_key(seed, "cpu").numpy())
