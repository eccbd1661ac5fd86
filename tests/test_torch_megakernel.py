"""The fused sample-and-score kernel's plain twin against the JAX package's
Pallas kernel, the arming knobs, and a cohort built with the fused route
against the reference's megakernel cohort.  Tolerance: the parity
standard, rtol 1e-5 and atol 1e-6 on candidates and EI (the two run the
same float32 formulas; torch's ``log``/``exp`` differ from XLA's by up to
an ulp).

Under this jax (0.9.0) ``_build_fused``'s ``pallas_call`` does not trace:
its ``ndtri`` captures the Cephes coefficient arrays as constants.  So the
test runs the kernel body ``_make_fused_kernel`` itself under ``jit``, on
array-backed refs, which is what the Pallas interpreter executes; and the
reference's interpreted cohort build disarms to its jnp program (its own
lowering probe), which is then what the cohort is held against."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hyperopt_tpu import hp as ref_hp, megakernel as ref_mk
from hyperopt_tpu.algos import tpe as ref_tpe
from hyperopt_tpu.base import Domain as RefDomain
from hyperopt_tpu_torch import convert, hp, megakernel
from hyperopt_tpu_torch._env import parse_hist_dtype, parse_megakernel
from hyperopt_tpu_torch.algos import tpe
from hyperopt_tpu_torch.base import Domain

RTOL, ATOL = 1e-5, 1e-6
CFG = {"prior_weight": 1.0, "n_EI_candidates": 24, "gamma": 0.25,
       "LF": 25, "ei_select": "argmax", "ei_tau": 1.0, "prior_eps": 0.0}


def _tables(m, dead, center, spread, low, high, seed):
    """Seeded float32 mixture tables ``[m]`` (the last ``dead`` components
    carry no weight) and the sampling tables of the below mixture."""
    rng = np.random.default_rng(seed)
    out = {}
    for side in ("b", "a"):
        w = rng.uniform(0.1, 1.0, m).astype(np.float32)
        w[m - dead:] = 0.0
        out["w" + side] = (w / w.sum()).astype(np.float32)
        out["m" + side] = (center + spread * rng.standard_normal(m)).astype(np.float32)
        out["s" + side] = rng.uniform(0.05, 1.5, m).astype(np.float32) * np.float32(spread)
    bounded = np.isfinite(low)
    lo = torch.tensor([low if bounded else 0.0], dtype=torch.float32)
    hi = torch.tensor([high if bounded else 0.0], dtype=torch.float32)
    cdf, ab, bb = tpe._sample_tables(torch.from_numpy(out["wb"])[None],
                                     torch.from_numpy(out["mb"])[None],
                                     torch.from_numpy(out["sb"])[None], lo, hi, bounded)
    out.update(cdf=cdf[0].numpy(), ab=ab[0].numpy(), bb=bb[0].numpy())
    return out, lo, hi, bounded


ORDER = ("cdf", "mb", "sb", "ab", "bb", "wb", "wa", "ma", "sa")


class _Ref:
    """An array standing in for a Pallas ref: indexing reads, slice
    assignment replaces."""

    def __init__(self, a):
        self.a = a

    def __getitem__(self, i):
        return self.a[i]

    def __setitem__(self, i, v):
        self.a = self.a.at[i].set(v)


def _pallas_body(n, m, low, high, uc, u0, tables):
    """The reference kernel body over all ``n`` candidates at once (each
    (8, 128) block of its grid computes the same elementwise function)."""
    body = ref_mk._make_fused_kernel(m, low, high)

    def run(uc2d, u02d, *tabs):
        x, ei = _Ref(jnp.zeros_like(uc2d)), _Ref(jnp.zeros_like(uc2d))
        body(_Ref(uc2d), _Ref(u02d), *map(_Ref, tabs), x, ei)
        return x.a, ei.a

    return jax.jit(run)(jnp.asarray(uc.reshape(n // 128, 128)),
                        jnp.asarray(u0.reshape(n // 128, 128)),
                        *(jnp.asarray(t) for t in tables))


@pytest.mark.parametrize("m", [17, 129])
@pytest.mark.parametrize("label", ["bounded_linear", "bounded_log", "unbounded_linear",
                                   "unbounded_log", "bounded_dead"])
def test_plain_twin_matches_the_pallas_kernel(label, m):
    """``fused_sample_ei_plain`` against the body of ``_build_fused(n, m,
    low, high, interpret=True)`` on identical uniforms and tables, n = 1024
    (the kernel's lane tiling)."""
    low, high, center, spread, dead = {
        "bounded_linear": (-5.0, 5.0, 0.0, 2.0, 0),
        "bounded_log": (-4.0, 0.0, -2.0, 1.0, 0),      # t-space of loguniform(-4, 0)
        "unbounded_linear": (-np.inf, np.inf, 1.0, 3.0, 0),
        "unbounded_log": (-np.inf, np.inf, 0.0, 1.0, 0),  # lognormal(0, 1) in t-space
        "bounded_dead": (0.0, 1.0, 0.5, 0.3, m // 3),
    }[label]
    n = 1024
    tabs, lo, hi, bounded = _tables(m, dead, center, spread, low, high, seed=m + len(label))
    rng = np.random.default_rng(m)
    uc = rng.uniform(size=n).astype(np.float32)
    u0 = rng.uniform(size=n).astype(np.float32)
    rx, rei = _pallas_body(n, m, float(low), float(high), uc, u0, [tabs[k] for k in ORDER])
    px, pei = megakernel.fused_sample_ei_plain(
        torch.from_numpy(uc)[None], torch.from_numpy(u0)[None],
        *(torch.from_numpy(tabs[k])[None] for k in ORDER), lo, hi, bounded)
    np.testing.assert_allclose(px[0].numpy(), np.asarray(rx).ravel(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pei[0].numpy(), np.asarray(rei).ravel(), rtol=RTOL, atol=ATOL)
    if bounded:
        assert (px >= low).all() and (px < high).all()


def test_the_wrapper_takes_the_plain_twin_on_cpu_and_checks_its_inputs():
    tabs, lo, hi, _ = _tables(33, 4, 0.0, 1.0, -2.0, 2.0, seed=3)
    P, N = 3, 50
    uc = torch.rand(P, N, generator=torch.Generator().manual_seed(0))
    u0 = torch.rand(P, N, generator=torch.Generator().manual_seed(1))
    t = [torch.from_numpy(tabs[k])[None].expand(P, -1).contiguous() for k in ORDER]
    low, high = lo.expand(P).contiguous(), hi.expand(P).contiguous()
    before = megakernel.fused_sample_ei.launches
    x, ei = megakernel.fused_sample_ei(uc, u0, *t, low, high, True)
    px, pei = megakernel.fused_sample_ei_plain(uc, u0, *t, low, high, True)
    assert megakernel.fused_sample_ei.launches == before  # no kernel on the CPU
    assert torch.equal(x, px) and torch.equal(ei, pei)
    with pytest.raises(TypeError, match="float32"):
        megakernel.fused_sample_ei(uc.double(), u0, *t, low, high, True)
    with pytest.raises(ValueError, match="tables"):
        megakernel.fused_sample_ei(uc, u0, *t[:-1], t[-1][:, :5], low, high, True)
    with pytest.raises(ValueError, match="bounds"):
        megakernel.fused_sample_ei(uc, u0, *t, low[:2], high, True)
    with pytest.raises(ValueError, match="u0"):
        megakernel.fused_sample_ei(uc, u0[:, :7], *t, low, high, True)


def _space(h, kind):
    return {
        "numeric": {"x": h.uniform("x", -5, 5), "lr": h.loguniform("lr", -4, 0),
                    "n": h.normal("n", 0, 2)},
        "randint": {"k": h.randint("k", 4)},
        "choice": {"c": h.choice("c", [1, 2])},
        "quniform": {"q": h.quniform("q", 0, 10, 2)},
        "mixed": {"x": h.uniform("x", -5, 5), "k": h.randint("k", 4)},
    }[kind]


@pytest.mark.parametrize("kind", ["numeric", "randint", "choice", "quniform", "mixed"])
def test_supports_and_armed_follow_the_reference(kind, monkeypatch):
    rcs = RefDomain(None, _space(ref_hp, kind)).cs
    cs = Domain(None, _space(hp, kind)).cs
    assert megakernel.supports(cs) == ref_mk.supports(rcs)
    monkeypatch.delenv("HYPEROPT_TPU_MEGAKERNEL", raising=False)
    assert megakernel.armed(cs) == megakernel.supports(cs)  # on by default
    monkeypatch.setenv("HYPEROPT_TPU_MEGAKERNEL", "0")
    assert not megakernel.armed(cs)


def test_env_knobs(monkeypatch):
    for raw, want in (("", "on"), ("1", "on"), ("on", "on"), ("0", "off"), ("off", "off")):
        monkeypatch.setenv("HYPEROPT_TPU_MEGAKERNEL", raw)
        assert parse_megakernel() == want
    for raw in ("interpret", "bogus"):
        monkeypatch.setenv("HYPEROPT_TPU_MEGAKERNEL", raw)
        with pytest.raises(ValueError, match=raw):
            parse_megakernel()
    for raw, want in (("", "float32"), ("f32", "float32"), ("bf16", "bfloat16"),
                      ("bfloat16", "bfloat16"), ("i8", "int8"), ("int8", "int8"),
                      ("f8", "fp8"), ("float8", "fp8"), ("float8_e4m3fn", "fp8")):
        monkeypatch.setenv("HYPEROPT_TPU_HIST_DTYPE", raw)
        assert parse_hist_dtype() == want
    monkeypatch.setenv("HYPEROPT_TPU_HIST_DTYPE", "int4")
    with pytest.raises(ValueError, match="int4"):
        parse_hist_dtype()


def _hist_stack(labels, S, cap, rng):
    """``tests/test_megakernel.py``'s seeded stack as numpy: ``5 + s``
    live rows in study ``s``, values inside every label's support."""
    vals = {l: np.zeros((S, cap), np.float32) for l in labels}
    act = {l: np.zeros((S, cap), bool) for l in labels}
    losses = np.full((S, cap), np.inf, np.float32)
    has = np.zeros((S, cap), bool)
    for s in range(S):
        for i in range(5 + s):
            for l in labels:
                vals[l][s, i] = rng.uniform(0.05, 0.9)
                act[l][s, i] = True
            losses[s, i] = rng.uniform()
            has[s, i] = True
    return {"vals": vals, "active": act, "losses": losses, "has_loss": has}


def test_fused_cohort_matches_the_reference_megakernel_cohort(monkeypatch):
    """``build_suggest_batched`` with the fused route (its plain twin on the
    CPU) against the JAX package's cohort built under
    ``HYPEROPT_TPU_MEGAKERNEL=interpret``, at ``tests/test_megakernel.py``'s
    shapes: S=2, cap 16, B=2, n=24."""
    space = {"x": (-5, 5), "lr": (-4, 0)}
    rcs = RefDomain(None, {"x": ref_hp.uniform("x", *space["x"]),
                           "lr": ref_hp.loguniform("lr", *space["lr"])}).cs
    cs = Domain(None, {"x": hp.uniform("x", *space["x"]),
                       "lr": hp.loguniform("lr", *space["lr"])}).cs
    S, cap, B = 2, 16, 2
    stack = _hist_stack(rcs.labels, S, cap, np.random.default_rng(7))
    L = len(rcs.labels)
    rows = np.zeros((S, 16, 2 * L + 3), np.float32)
    rows[:, :, -1] = cap
    seeds = np.stack([ref_tpe._seed_words(500 + s) for s in range(S)])
    ids = np.asarray([[3 + s, 9 + s] for s in range(S)], np.uint32)
    # the reference's fused build does not lower under this jax, and its
    # failure disarms the space for the process through the module-global
    # set `_failed`; a private copy keeps that out of the reference's own
    # tests, which use the same space signature
    monkeypatch.setattr(ref_mk, "_failed", set(ref_mk._failed))
    monkeypatch.setenv("HYPEROPT_TPU_MEGAKERNEL", "interpret")
    ref_run = ref_tpe.build_suggest_batched(rcs, CFG, S, cap, B, donate=False)
    _, want = ref_run(jax.tree.map(jnp.asarray, stack), rows, seeds, ids)
    want = np.asarray(want)
    monkeypatch.setenv("HYPEROPT_TPU_MEGAKERNEL", "on")
    assert megakernel.armed(cs)
    run = tpe.build_suggest_batched(cs, CFG, S, cap, B, donate=False)
    _, got = run(convert.cohort_stack_from_numpy(stack, "cpu"), rows, seeds, ids)
    assert got.shape == (S, B, L)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
