"""The plain reference against the port on the CPU, at small sizes (both
kernels' plain paths): a 40-trial device-loop search and a batch-64
driver search of 256 evaluations pass the comparison well inside its
limits, and the reference's threefry draws are the port's bit for bit."""

import numpy as np
import pytest
import torch

import run
from conftest import BENCH, tiny_config
from reference import check, prng, tpe

from hyperopt_tpu_torch import prng as port_prng
from hyperopt_tpu_torch import spaces


def _numbers(name, mix, seeds):
    cfg = tiny_config(name)
    config = run._load(BENCH / "configs" / f"{name}.py", f"_config_{name}")
    entry = run._load(BENCH / "entries" / f"{mix}.py", f"_entry_{mix}")
    program = entry.Entry(cfg, config.fn, "cpu")
    searches = [program.extract(program.search(s), s) for s in seeds]
    return cfg, entry.judge(cfg, config.objective, searches, 64, seeds[0])


@pytest.mark.parametrize("name, mix", [("branin", "fmin_device_loop"),
                                       ("lcbench", "fmin_multihost")])
def test_port_passes_the_reference_at_small_sizes(name, mix):
    cfg, got = _numbers(name, mix, [2 ** 33 + 7, 123456789])
    assert got["checked_proposals"] > 0
    assert check.correct(got, cfg["limits"]), got
    assert got["fold_errors"] == 0
    # float32 rounding alone: far below the limits
    assert got["draw_gap"] < 1e-6 and got["loss_gap"] < 1e-5, got


def test_threefry_keys_and_draws_are_the_ports_bit_for_bit():
    seeds = [0, 1, 2 ** 31 - 1, 2 ** 32 - 1, 77]
    for s in seeds:
        k_ref = prng.fold_in(prng.key(s), 12345)
        k_port = port_prng.fold_in(port_prng.PRNGKey(s), 12345)
        assert torch.equal(k_ref, k_port)
        assert torch.equal(prng.bits(k_ref, 40), port_prng.random_bits(k_port, (40,)))
        assert torch.equal(prng.split(k_ref, 1), port_prng.split(k_port)[1])
        u_ref = prng.uniform(k_ref, -5.0, 10.0, 64)
        u_port = port_prng.uniform(k_port, (64,), -5.0, 10.0).double()
        assert (u_ref - u_port).abs().max() <= 15 * 2.0 ** -24
        assert torch.equal(prng.randint(k_ref, 1, 9), port_prng.randint(k_port, (), 1, 9))


def test_label_hash_is_the_ports():
    for label in ("x", "y", "batch_size", "learning_rate", "max_units"):
        assert prng.label_hash(label) == spaces.label_hash(label)


def test_log_grid_draws_and_bins_follow_the_ports():
    """A qloguniform label: the prior draw is the port's ``draw_dist``, and
    a grid point's bin mass integrates its value-space bin in log space."""
    from hyperopt_tpu_torch.hp import qloguniform

    spec = ["qloguniform", float(np.log(16)), float(np.log(512)), 1]
    label = tpe.Label("batch_size", spec)
    keys = prng.fold_in(prng.key(2 ** 32 + 5), torch.arange(4096))
    got = spaces.draw_dist(qloguniform("batch_size", *spec[1:]).dist, keys).double()
    want = tpe.prior_draw(label, keys)
    assert ((want - got[:, None]).abs().min(-1).values == 0).all()
    assert got.min() >= 16 and got.max() <= 512
    w, mu, s = (torch.tensor([[v]], dtype=torch.float64) for v in (1.0, np.log(100.0), 0.5))
    v = torch.tensor([16.0, 100.0, 512.0], dtype=torch.float64)
    mass = tpe._bin_mass(label, v, w, mu, s)
    lo = torch.log(torch.tensor([16.0, 99.5, 511.5], dtype=torch.float64))
    hi = torch.log(torch.tensor([16.5, 100.5, 512.0], dtype=torch.float64))
    ref = tpe.ndtr((hi - np.log(100.0)) / 0.5) - tpe.ndtr((lo - np.log(100.0)) / 0.5)
    assert torch.allclose(mass, ref, rtol=0, atol=1e-15)


def test_parzen_fit_and_split_follow_the_documented_rules():
    obs = torch.tensor([[3.0, 1.0, 2.0, 9.0]], dtype=torch.float64)
    mask = torch.tensor([[True, True, True, False]])
    w, mu, s = tpe.parzen(obs, mask, 5.0, 10.0, 1.0, 25)
    assert mu[0, :4].tolist() == [1.0, 2.0, 3.0, 5.0]  # the prior sorted in
    assert np.isclose(float(w[0].sum()), 1.0) and float(w[0, 4]) == 0.0
    # sigma: the larger neighbour gap, clipped to [10 / min(100, 5), 10]
    assert s[0, :4].tolist() == [2.0, 2.0, 2.0, 10.0]
    losses = torch.tensor([[3.0, 1.0, 2.0, 0.5]], dtype=torch.float64)
    below, above = tpe.split_below(losses, torch.tensor([[True] * 4]), 1.0, 25)
    assert below.tolist() == [[False, True, False, True]]   # ceil(sqrt(4)) = 2 best
    assert above.tolist() == [[True, False, True, False]]


def test_a_grid_rounding_in_a_thin_tail_reads_both_ways():
    """A log-grid candidate deep in a narrow component's tail, whose value
    lies hundredths of a step from a half step: the program's float32
    component CDF (``0.5 (1 + erf)``, ~1e-7 off in the draw's uniform) may
    round it either way, and the judge reads both; a value that no
    candidate reaches still reads as a gap."""
    spec = ["qloguniform", float(np.log(64)), float(np.log(1024)), 1]
    label = tpe.Label("max_units", spec)
    below = tuple(torch.tensor([v], dtype=torch.float64) for v in
                  ([0.5, 0.5], [np.log(599.0), label.prior_mu], [0.0815, label.prior_sigma]))
    keys = prng.fold_in(prng.key(2 ** 32 + 11), torch.arange(2000))
    fi = torch.zeros(2000, dtype=torch.int64)
    mu, s, u, x = tpe.candidates(label, below, fi, keys, 64)
    v = torch.exp(torch.clamp(mu + s * torch.special.ndtri(u), min=label.lo, max=label.hi))
    by_value = label.to_grid(v[..., ::2]).flatten(2)   # the value-space tolerance alone
    both = x[..., 0::2] != x[..., 1::2]
    only_u = [(c, i, r) for c, i, r in both.nonzero().tolist()
              if float(s[c, i, 2 * r]) < 0.1 and not (by_value[c] == x[c, i, 2 * r + 1]).any()]
    assert only_u, "no narrow candidate that the uniform's tolerance alone reads both ways"
    c, i, r = only_u[0]
    flipped = x[c, i, 2 * r + 1]
    assert float(u[c, i, 2 * r]) < 0.01 or float(u[c, i, 2 * r]) > 0.99   # a thin tail
    cfg = {"n_EI_candidates": 64, "prior_eps": 0.0}
    draw, _ = tpe.judge(label, (below, below), fi[:1], keys[[c]], flipped[None], cfg)
    assert float(draw[0]) == 0.0
    far = float(x[c].max()) + 3.0
    draw, _ = tpe.judge(label, (below, below), fi[:1], keys[[c]],
                        torch.tensor([far], dtype=torch.float64), cfg)
    assert float(draw[0]) >= 1.0 / (label.vhi - label.vlo)


def test_a_value_is_matched_in_its_candidates_uniforms(monkeypatch):
    """Two candidates 1.6e-5 apart in t-space, the second deep in its
    component's tail: the program's float32 CDF moves that one's uniform by
    1.2e-7 and its value by 3.3e-5, to the first's side.  The judge matches
    the value in the candidates' uniforms, to the tail candidate, and judges
    that one's selection."""
    label = tpe.Label("learning_rate", ["loguniform", -9.210340371976182, -2.3025850929940455])
    ndtri = torch.special.ndtri
    u = torch.tensor([0.28607177734375, 0.999891996383667], dtype=torch.float64)
    mu = torch.tensor([-5.058398675320672, 0.0], dtype=torch.float64)
    s = torch.full((2,), 0.11909922894796787, dtype=torch.float64)
    x0 = mu[0] + s[0] * ndtri(u[0])
    mu[1] = x0 + 1.6e-5 - s[1] * ndtri(u[1])
    x = mu + s * ndtri(u)

    def fake(label_, below, fi, keys, n):
        return tuple(t[None, :, None].expand(keys.shape[0], 2, 3) for t in (mu, s, u, x))

    monkeypatch.setattr(tpe, "candidates", fake)
    fits = tuple(tuple(torch.tensor([[v]], dtype=torch.float64) for v in f)
                 for f in ((1.0, -5.2, 0.3), (1.0, -4.0, 0.6)))
    cfg = {"n_EI_candidates": 2, "prior_eps": 0.0, "ei_select": "softmax", "ei_tau": 0.5}
    fi = torch.zeros(1, dtype=torch.int64)
    # a key whose Gumbel noise ranks the tail candidate first by a margin
    for k in range(64):
        key = prng.fold_in(prng.key(2 ** 32 + 17), torch.tensor([k]))
        us = prng.uniform(prng.fold_in(key, 0x5E1EC7), tpe.U_TINY, 1.0 - tpe.U_TINY, 2)[0]
        gumbel = -torch.log(-torch.log(us))
        if float(gumbel[1] - gumbel[0]) > 0.1:
            break
    assert float(gumbel[1] - gumbel[0]) > 0.1
    shifted = x[1] + s[1] * (ndtri(u[1] - 1.2e-7) - ndtri(u[1]))
    assert abs(float(shifted - x[0])) < abs(float(shifted - x[1]))   # nearer the first in t
    draw, gap = tpe.judge(label, fits, fi, key, torch.exp(shifted)[None], cfg)
    assert float(draw[0]) < tpe.U_TOL and float(gap[0]) == 0.0
