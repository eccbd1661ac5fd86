"""The port's space IR and prior sampler against the JAX package's: the
same keys give the same draws per family (bitwise where no
transcendental is involved), grouped and unrolled draws agree bitwise, and
conditional active masks are identical on the zoo spaces."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hyperopt_tpu.hp as ref_hp
from hyperopt_tpu import spaces as ref_spaces
from hyperopt_tpu import zoo as ref_zoo
import hyperopt_tpu_torch.hp as hp
from hyperopt_tpu_torch import prng, spaces
from hyperopt_tpu_torch import zoo

EXACT = ("uniform", "quniform", "randint", "uniformint", "categorical")

FAMILIES = {
    "uniform": lambda h, l: h.uniform(l, -4, 7),
    "quniform": lambda h, l: h.quniform(l, 0, 10, 3),
    "loguniform": lambda h, l: h.loguniform(l, -2, 1),
    "qloguniform": lambda h, l: h.qloguniform(l, 0, 3, 2),
    "normal": lambda h, l: h.normal(l, 4, 7),
    "qnormal": lambda h, l: h.qnormal(l, 0, 10, 2),
    "lognormal": lambda h, l: h.lognormal(l, -2, 2),
    "qlognormal": lambda h, l: h.qlognormal(l, 0, 2, 1),
    "randint": lambda h, l: h.randint(l, 10),
    "uniformint": lambda h, l: h.uniformint(l, -3, 5),
    "categorical": lambda h, l: h.pchoice(l, [(0.2, 0), (0.5, 1), (0.3, 2)]),
}


def _keys(n, seed=5):
    ids = np.arange(n, dtype=np.uint32) * 7919
    k = jax.random.fold_in(jax.random.PRNGKey(seed), 9)
    ref = jax.vmap(lambda i: jax.random.fold_in(k, i))(jnp.asarray(ids))
    port = prng.fold_in(prng.fold_in(prng.PRNGKey(seed, "cpu"), 9),
                        torch.as_tensor(ids.astype(np.int64)))
    return ref, port


def _compare(family, ref, got, label):
    ref = np.asarray(ref)
    got = got.numpy()
    if family in EXACT:
        np.testing.assert_array_equal(ref, got, err_msg=label)
    else:
        np.testing.assert_allclose(ref, got, rtol=1e-5, atol=1e-6, err_msg=label)


def _all_families(h):
    """Two labels of every family (drawn grouped) and a singleton."""
    space = {f"{f}_{i}": make(h, f"{f}_{i}") for f, make in FAMILIES.items() for i in range(2)}
    space["solo"] = h.uniform("solo", 0, 1)
    return space


def test_prior_draws_match_reference():
    rcs = ref_spaces.compile_space(_all_families(ref_hp))
    pcs = spaces.compile_space(_all_families(hp))
    assert rcs.labels == pcs.labels
    rkeys, pkeys = _keys(200)
    ref = jax.vmap(rcs.sample_flat)(rkeys)
    out = pcs.sample_flat(pkeys)
    for label in rcs.labels:
        _compare(rcs.params[label].dist.family, ref[label], out[label], label)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_grouped_draws_bitwise_equal_unrolled(family):
    """``draw_dist_group`` inside ``sample_flat`` equals one ``draw_dist``
    per label on that label's key, bit for bit."""
    pcs = spaces.compile_space({f"a{i}": FAMILIES[family](hp, f"a{i}") for i in range(3)})
    _, pkeys = _keys(64, seed=11)
    grouped = pcs.sample_flat(pkeys)
    for label in pcs.labels:
        k = prng.fold_in(pkeys, spaces.label_hash(label))
        assert torch.equal(grouped[label], spaces.draw_dist(pcs.params[label].dist, k)), label


@pytest.mark.parametrize("name", ["quadratic1", "branin", "q1_choice", "hr_conditional"])
def test_zoo_draws_and_active_masks_match(name):
    rcs = ref_spaces.compile_space(ref_zoo.ZOO[name].space)
    pcs = spaces.compile_space(zoo.ZOO[name].space)
    assert rcs.labels == pcs.labels
    assert rcs.signature() == pcs.signature()
    rkeys, pkeys = _keys(128, seed=2)
    ref = jax.vmap(rcs.sample_flat)(rkeys)
    out = pcs.sample_flat(pkeys)
    for label in rcs.labels:
        _compare(rcs.params[label].dist.family, ref[label], out[label], label)
    ref_act = rcs.active_flat({l: np.asarray(v) for l, v in ref.items()})
    port_act = pcs.active_flat(out)
    for label in rcs.labels:
        np.testing.assert_array_equal(np.asarray(ref_act[label]) * np.ones(128, bool),
                                      np.asarray(port_act[label]) * np.ones(128, bool),
                                      err_msg=label)


def test_sample_space_eval_and_assemble():
    space = zoo.ZOO["hr_conditional"].space
    point = spaces.sample(space, 3, device="cpu")
    assert point["kind"] in ("hartmann", "rosen")
    assert spaces.space_eval(space, {"family": [1], "r_scale": [0.5],
                                     **{f"r{i}": [0.0] for i in range(20)}})["scale"] == 0.5
    ref_point = ref_spaces.sample(ref_zoo.ZOO["hr_conditional"].space, 3)
    assert ref_point["kind"] == point["kind"]
    np.testing.assert_allclose(ref_point["xs"], point["xs"], rtol=1e-6)
