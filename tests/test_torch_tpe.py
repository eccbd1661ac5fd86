"""The port's TPE tick against the JAX package's, from the same history
(carried across by ``convert.padded_history_from_numpy``) and the same
seed words: per-label and grouped ``(value, ei)`` proposals for every
numeric and discrete family, the candidate pools, the tick's history
fold, and the tie order of the below/above split and the Parzen fit."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hyperopt_tpu.hp as ref_hp
from hyperopt_tpu import spaces as ref_spaces
from hyperopt_tpu.algos import tpe as ref_tpe
import hyperopt_tpu_torch.hp as hp
from hyperopt_tpu_torch import convert, prng, spaces
from hyperopt_tpu_torch.algos import tpe

RTOL, ATOL = 1e-5, 1e-6
DISCRETE = ("randint", "categorical")


def _space(h):
    """One label of every family; families sharing a pipeline shape form
    the groups (bounded, bounded-quantized, unbounded, unbounded-quantized,
    five-bucket discrete), and the two-way choice is a singleton."""
    return {
        "u0": h.uniform("u0", -5, 5),
        "lu1": h.loguniform("lu1", -3, 2),
        "qu0": h.quniform("qu0", 0, 10, 2),
        "qlu1": h.qloguniform("qlu1", 0, 3, 2),
        "ui0": h.uniformint("ui0", 1, 6),
        "n1": h.normal("n1", 1, 3),
        "ln0": h.lognormal("ln0", 0, 1),
        "qn1": h.qnormal("qn1", 0, 8, 2),
        "qln0": h.qlognormal("qln0", 1, 1, 1),
        "ri1": h.randint("ri1", 2, 7),
        "pc0": h.pchoice("pc0", [(0.25, 0), (0.35, 1), (0.15, 2), (0.25, 3), (0.0, 4)]),
        "solo": h.choice("solo", [{"a": h.uniform("a", 0, 1)}, {"b": h.normal("b", 0, 1)}]),
    }


RCS = ref_spaces.compile_space(_space(ref_hp))
PCS = spaces.compile_space(_space(hp))


def _history(n=70, seed=0, rcs=RCS, cap=128):
    """A reference padded history (cap 128) from prior draws: tied losses,
    some trials without a loss, conditional labels inactive half the time."""
    rng = np.random.default_rng(seed)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(seed), i))(
        jnp.arange(cap, dtype=jnp.uint32))
    flats = jax.vmap(rcs.sample_flat)(keys)
    acts = rcs.active_flat({l: np.asarray(v) for l, v in flats.items()})
    live = np.arange(cap) < n
    has = live & (rng.uniform(size=cap) > 0.1)
    losses = np.round(rng.normal(size=cap), 1).astype(np.float32)  # many ties
    out = {
        "losses": np.where(has, losses, np.inf).astype(np.float32),
        "has_loss": has,
        "vals": {l: np.where(live, np.asarray(flats[l], np.float32), 0.0).astype(np.float32)
                 for l in rcs.labels},
        "active": {l: np.asarray(acts[l]) * np.ones(cap, bool) & live for l in rcs.labels},
    }
    return out, n


def _ref_hist(h):
    return {"losses": jnp.asarray(h["losses"]), "has_loss": jnp.asarray(h["has_loss"]),
            "vals": {l: jnp.asarray(v) for l, v in h["vals"].items()},
            "active": {l: jnp.asarray(v) for l, v in h["active"].items()}}


def _port_hist(h, n, rcs=RCS):
    ph = convert.padded_history_from_numpy(rcs.labels, h["vals"], h["active"],
                                           h["losses"], h["has_loss"], device="cpu", n=n)
    return ph.device_view()


def _keys(ids, seed=(7, 3)):
    """Tick keys ``fold_in(fold_in(PRNGKey(lo), hi), id)`` in both packages."""
    k = jax.random.fold_in(jax.random.PRNGKey(seed[0]), seed[1])
    ref = jax.vmap(lambda i: jax.random.fold_in(k, i))(jnp.asarray(ids, jnp.uint32))
    port = prng.fold_in(prng.fold_in(prng.PRNGKey(seed[0], "cpu"), seed[1]),
                        torch.as_tensor(np.asarray(ids, np.int64)))
    return ref, port


CFGS = {
    "argmax": {"prior_weight": 1.0, "n_EI_candidates": 24, "gamma": 0.25, "LF": 25},
    "softmax_eps": {"prior_weight": 1.0, "n_EI_candidates": 32, "gamma": 0.25, "LF": 25,
                    "ei_select": "softmax", "ei_tau": 0.5, "prior_eps": 0.4},
}


def _ref_split(ref_hist, cfg):
    return ref_tpe.split_below_above(ref_hist["losses"], ref_hist["has_loss"],
                                     cfg["gamma"], cfg["LF"])


def _top2_tied(label, ref_hist, rkey, cfg):
    """True when the reference's two best EI scores for ``label`` at key
    ``rkey`` are within tolerance, so either pick is right."""
    below, above = _ref_split(ref_hist, cfg)
    act = ref_hist["active"][label]
    k = jax.random.fold_in(rkey, ref_spaces.label_hash(label))
    dist = RCS.params[label].dist
    fn = (ref_tpe._propose_discrete if dist.family in DISCRETE else ref_tpe._propose_numeric)
    _, ei = fn(k, dist, ref_hist["vals"][label], below & act, above & act, cfg, raw=True)
    top = np.sort(np.asarray(ei))[-2:]
    return bool(np.isclose(top[0], top[1], rtol=RTOL, atol=ATOL))


def _check(out_ref, out_port, ref_hist, rkeys, cfg):
    for label in RCS.labels:
        rv, rei = (np.asarray(a) for a in out_ref[label])
        pv, pei = (a.numpy() for a in out_port[label])
        fam = RCS.params[label].dist.family
        same = rv == pv if fam in DISCRETE else np.isclose(rv, pv, rtol=RTOL, atol=ATOL)
        for b in np.flatnonzero(~same):
            assert _top2_tied(label, ref_hist, rkeys[b], cfg), (label, b, rv[b], pv[b])
        np.testing.assert_allclose(pei, rei, rtol=RTOL, atol=ATOL, err_msg=f"{label} ei")


@functools.lru_cache(maxsize=None)
def _ref_propose(group, cfg_name):
    """The reference's jitted proposal step, vmapped over ids (compiled once
    per module run)."""
    return jax.jit(jax.vmap(ref_tpe.build_propose_with_scores(RCS, CFGS[cfg_name],
                                                              group=group),
                            in_axes=(None, 0)))


@pytest.mark.parametrize("group,cfg_name", [(False, "argmax"), (True, "argmax"),
                                            (True, "softmax_eps")])
def test_proposals_match_reference(group, cfg_name):
    cfg = CFGS[cfg_name]
    h, n = _history()
    ids = np.arange(6) * 31 + 5
    rkeys, pkeys = _keys(ids)
    ref_hist = _ref_hist(h)
    ref = _ref_propose(group, cfg_name)(ref_hist, rkeys)
    port = tpe.build_propose_with_scores(PCS, cfg, group=group)(_port_hist(h, n), pkeys)
    _check(ref, port, ref_hist, rkeys, cfg)


def _lcbench_space(h):
    """LCBench's seven hyperparameters (Zimmer et al.): its quantized group
    is bounded and holds two log-int labels beside one int label."""
    return {"batch_size": h.qloguniform("batch_size", np.log(16), np.log(512), 1),
            "learning_rate": h.loguniform("learning_rate", np.log(1e-4), np.log(1e-1)),
            "momentum": h.uniform("momentum", 0.1, 0.99),
            "weight_decay": h.uniform("weight_decay", 1e-5, 0.1),
            "num_layers": h.uniformint("num_layers", 1, 5),
            "max_units": h.qloguniform("max_units", np.log(64), np.log(1024), 1),
            "max_dropout": h.uniform("max_dropout", 0.0, 1.0)}


def test_lcbench_quantized_group_proposes_bit_for_bit_like_reference():
    """The batch driver's configuration (64 candidates, gamma 1, LF 100,
    softmax at tau 0.5, prior_eps 0.1) on LCBench's space: the quantized
    group's proposals, scored through ``megakernel.q_mass_diff``'s plain
    twin, equal the reference's bit for bit and their EI at the parity
    standard; the other labels at the parity standard."""
    rcs = ref_spaces.compile_space(_lcbench_space(ref_hp))
    pcs = spaces.compile_space(_lcbench_space(hp))
    cfg = {"prior_weight": 1.0, "n_EI_candidates": 64, "gamma": 1.0, "LF": 100,
           "ei_select": "softmax", "ei_tau": 0.5, "prior_eps": 0.1}
    h, n = _history(n=200, seed=9, rcs=rcs, cap=256)
    ids = np.arange(16) * 7 + 1
    rkeys, pkeys = _keys(ids, seed=(11, 5))
    ref = jax.jit(jax.vmap(ref_tpe.build_propose_with_scores(rcs, cfg, group=True),
                           in_axes=(None, 0)))(_ref_hist(h), rkeys)
    port = tpe.build_propose_with_scores(pcs, cfg, group=True)(_port_hist(h, n, rcs), pkeys)
    for label in rcs.labels:
        rv, rei = (np.asarray(a) for a in ref[label])
        pv, pei = (a.numpy() for a in port[label])
        if label in ("batch_size", "num_layers", "max_units"):
            np.testing.assert_array_equal(pv, rv, err_msg=label)
        else:
            np.testing.assert_allclose(pv, rv, rtol=RTOL, atol=ATOL, err_msg=label)
        np.testing.assert_allclose(pei, rei, rtol=RTOL, atol=ATOL, err_msg=f"{label} ei")


@pytest.mark.parametrize("label", ["u0", "lu1", "qu0", "qlu1", "ui0", "n1", "ln0",
                                   "qn1", "qln0", "ri1", "pc0", "a"])
def test_candidate_pools_match_reference(label):
    """Per-label raw (samples, ei) pools, one id: samples and EI scores
    candidate by candidate."""
    cfg = CFGS["argmax"]
    h, n = _history(seed=4)
    ref_hist, dev = _ref_hist(h), _port_hist(h, n)
    rkeys, pkeys = _keys([11])
    rb, ra = ref_tpe.split_below_above(ref_hist["losses"], ref_hist["has_loss"], 0.25, 25)
    pb, pa = tpe.split_below_above(dev["losses"], dev["has_loss"], 0.25, 25)
    np.testing.assert_array_equal(np.asarray(rb), pb.numpy())
    dist = RCS.params[label].dist
    rfn = ref_tpe._propose_discrete if dist.family in DISCRETE else ref_tpe._propose_numeric
    pfn = tpe._propose_discrete if dist.family in DISCRETE else tpe._propose_numeric
    ract, pact = ref_hist["active"][label], dev["active"][label]
    # jitted, as the reference's ask runs it: XLA contracts mu + sigma * ndtri(u)
    # into one FMA, which the port mirrors and an op-by-op run does not
    rfn = jax.jit(functools.partial(rfn, dist=dist, cfg=cfg, raw=True))
    rs, rei = rfn(jax.random.fold_in(rkeys[0], ref_spaces.label_hash(label)),
                  vals=ref_hist["vals"][label], below_mask=rb & ract, above_mask=ra & ract)
    ps, pei = pfn(prng.fold_in(pkeys, spaces.label_hash(label)), PCS.params[label].dist,
                  dev["vals"][label], pb & pact, pa & pact, cfg, raw=True)
    if dist.family in DISCRETE:
        np.testing.assert_array_equal(np.asarray(rs), ps.numpy()[0])
    else:
        np.testing.assert_allclose(np.asarray(rs), ps.numpy()[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pei.numpy()[0], np.asarray(rei), rtol=RTOL, atol=ATOL)


def test_split_below_above_ties_keep_insertion_order():
    losses = np.asarray([1.0, 0.5, 0.5, 0.5, 2.0, 0.5, np.inf, 0.5], np.float32)
    has = np.isfinite(losses)
    for gamma, LF in ((0.25, 25), (1.0, 3), (2.0, 25)):
        rb, ra = ref_tpe.split_below_above(jnp.asarray(losses), jnp.asarray(has), gamma, LF)
        pb, pa = tpe.split_below_above(torch.as_tensor(losses), torch.as_tensor(has),
                                       gamma, LF)
        np.testing.assert_array_equal(np.asarray(rb), pb.numpy())
        np.testing.assert_array_equal(np.asarray(ra), pa.numpy())


def test_parzen_fit_with_duplicate_observations():
    obs = np.asarray([0.3, 0.3, -1.0, 0.3, 2.0, 0.0, 0.0, 5.0], np.float32)
    for mask in (np.ones(8, bool), np.asarray([1, 1, 0, 1, 1, 0, 1, 1], bool),
                 np.zeros(8, bool)):
        for LF in (2, 25):
            ref = ref_tpe.adaptive_parzen_normal(jnp.asarray(obs), jnp.asarray(mask), 1.0,
                                                 jnp.float32(0.5), jnp.float32(3.0), LF)
            got = tpe.adaptive_parzen_normal(torch.as_tensor(obs), torch.as_tensor(mask),
                                             1.0, 0.5, 3.0, LF)
            for r, g in zip(ref, got):
                np.testing.assert_allclose(np.asarray(r), g.numpy(), rtol=RTOL, atol=ATOL)


def test_tick_folds_rows_then_proposes_like_reference():
    """The fused tick: rows finished since the last tick fold into the
    device history in place, then the proposal equals the reference's."""
    cfg = CFGS["argmax"]
    h, n = _history(n=40, seed=2)
    ph = convert.padded_history_from_numpy(RCS.labels, h["vals"], h["active"], h["losses"],
                                           h["has_loss"], device="cpu", n=n - 5)
    ph.device_state()  # mirror holds n-5 rows
    ph.commit_device()
    ph.n = n  # five more rows finished on the host
    dev, rows = ph.device_state()
    assert rows.shape == (5, 2 * len(RCS.labels) + 3)
    ids = torch.as_tensor([40, 41, 42])
    mat = tpe._tick(PCS, tpe.build_propose(PCS, cfg), dev, rows, (3 << 32) | 7, ids)
    ph.commit_device()
    for l in RCS.labels:
        np.testing.assert_array_equal(dev["vals"][l].numpy(), h["vals"][l])
        np.testing.assert_array_equal(dev["active"][l].numpy(), h["active"][l])
    np.testing.assert_array_equal(dev["has_loss"].numpy(), h["has_loss"])
    rkeys, _ = _keys([40, 41, 42])
    ref = _ref_propose(True, "argmax")(_ref_hist(h), rkeys)
    for j, l in enumerate(RCS.labels):
        r = np.asarray(ref[l][0], np.float32)
        if RCS.params[l].dist.family in DISCRETE:
            np.testing.assert_array_equal(r, mat[:, j].numpy(), err_msg=l)
        else:
            np.testing.assert_allclose(r, mat[:, j].numpy(), rtol=RTOL, atol=ATOL, err_msg=l)


@pytest.mark.parametrize("label", ["u0", "lu1", "qu0", "qlu1", "n1", "ln0", "qn1", "qln0"])
def test_lpdfs_match_reference(label):
    """``gmm1_lpdf``/``lgmm1_lpdf`` with and without quantization, on the
    same fitted mixture and points, against the reference's.  A quantized
    bin's mass is a difference of two CDF values near each other, so the
    port's ``erf`` is XLA's float32 formula: tail bins compare in the log
    like every other."""
    cfg = CFGS["argmax"]
    h, n = _history(seed=6)
    ref_hist, dev = _ref_hist(h), _port_hist(h, n)
    below, _ = _ref_split(ref_hist, cfg)
    act = ref_hist["active"][label]
    pmu, psig, low, high, q, log_space = ref_tpe._parzen_from(RCS.params[label].dist)
    vals = np.asarray(ref_hist["vals"][label])
    obs = np.log(np.maximum(vals, 1e-12)) if log_space else vals
    rfit = ref_tpe.adaptive_parzen_normal(jnp.asarray(obs, jnp.float32), below & act, 1.0,
                                          jnp.float32(pmu), jnp.float32(psig), 25)
    pfit = tpe.adaptive_parzen_normal(torch.tensor(obs, dtype=torch.float32),
                                      torch.tensor(np.asarray(below & act)), 1.0,
                                      pmu, psig, 25)
    x = np.asarray(ref_hist["vals"][label])[np.asarray(act)][:20]
    rl, pl = ((ref_tpe.lgmm1_lpdf, tpe.lgmm1_lpdf) if log_space
              else (ref_tpe.gmm1_lpdf, tpe.gmm1_lpdf))
    for qq in {q, None}:
        ref = np.asarray(rl(jnp.asarray(x), *rfit, low, high, qq))
        got = pl(torch.tensor(x), *pfit, low, high, qq).numpy()
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL, err_msg=f"q={qq}")


def test_history_conversion_infers_live_rows():
    h, n = _history(n=33, seed=1)
    ph = convert.padded_history_from_numpy(RCS.labels, h["vals"], h["active"],
                                           h["losses"], h["has_loss"], device="cpu")
    assert ph.cap == 128 and ph.n == int(np.flatnonzero(
        h["has_loss"] | np.any([h["active"][l] for l in RCS.labels], 0))[-1]) + 1
    assert ph.n <= 33
    dev = ph.device_view()
    np.testing.assert_array_equal(dev["losses"].numpy(), h["losses"])

