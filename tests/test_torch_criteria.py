"""``criteria.py`` and the zoo's simple domains against the JAX package's.

The criteria run on seeded inputs whose scores span the Mills-ratio tail
and the body, at the parity standard (rtol 1e-5, atol 1e-6; ``erf`` is
XLA's float32 form in both).  The domains compile to the reference's
parameter tables and their objectives give the reference's losses on
sampled points; the zoo keeps the reference's order."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hyperopt_tpu import criteria as ref_criteria, zoo as ref_zoo
from hyperopt_tpu.spaces import compile_space as ref_compile
from hyperopt_tpu_torch import criteria, spaces, zoo

RTOL, ATOL = 1e-5, 1e-6


def _inputs(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    mean = rng.normal(0.0, 3.0, n).astype(np.float32)
    var = rng.uniform(0.01, 4.0, n).astype(np.float32)
    thresh = np.float32(rng.uniform(-1.0, 1.0))
    return mean, var, thresh


@pytest.mark.parametrize("fn", ["EI_gaussian", "logEI_gaussian", "UCB"])
def test_criteria_match_the_reference(fn):
    mean, var, thresh = _inputs()
    if fn == "logEI_gaussian":  # reach deep into the tail, scores below -10
        mean = mean * np.float32(8.0)
    arg = np.float32(1.5) if fn == "UCB" else thresh
    want = np.asarray(getattr(ref_criteria, fn)(jnp.asarray(mean), jnp.asarray(var), arg))
    got = getattr(criteria, fn)(torch.from_numpy(mean), torch.from_numpy(var), arg).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    if fn == "logEI_gaussian":
        assert ((mean - thresh) / np.sqrt(var) < -10).sum() > 100
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_empirical_ei_matches_the_reference():
    samples = np.random.default_rng(1).normal(0, 1, 1000).astype(np.float32)
    want = float(ref_criteria.EI_empirical(jnp.asarray(samples), 0.3))
    np.testing.assert_allclose(float(criteria.EI_empirical(samples, 0.3)), want, rtol=RTOL)


NEW = ("n_arms", "distractor", "gauss_wave", "gauss_wave2", "many_dists")


def test_zoo_keeps_the_reference_order():
    assert list(zoo.ZOO) == list(ref_zoo.ZOO)


@pytest.mark.parametrize("name", NEW)
def test_new_domains_match_the_reference(name):
    rd, pd = ref_zoo.ZOO[name], zoo.ZOO[name]
    rcs, pcs = ref_compile(rd.space), spaces.compile_space(pd.space)
    assert rcs.labels == pcs.labels
    for l in rcs.labels:
        assert rcs.params[l].dist == pcs.params[l].dist or (
            rcs.params[l].dist.family == pcs.params[l].dist.family
            and tuple(rcs.params[l].dist.params) == tuple(pcs.params[l].dist.params)), l
        assert rcs.params[l].conditions == pcs.params[l].conditions, l
    assert pd.loss_target == rd.loss_target
    rng = np.random.default_rng(4)
    for _ in range(20):
        flat = {}
        for l in pcs.labels:
            d = pcs.params[l].dist
            if d.family in ("categorical", "randint"):
                flat[l] = int(rng.integers(0, 2))
            else:
                flat[l] = float(rng.uniform(0.2, 0.9))
        if name == "n_arms":
            rp = pp = flat["arm"]
        else:
            rp, pp = rcs.assemble(flat), pcs.assemble(flat)
        np.testing.assert_allclose(pd.objective(pp), rd.objective(rp), rtol=1e-6, err_msg=name)
