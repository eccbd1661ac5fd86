"""Tree-structured Parzen Estimator on torch (counterpart of
``hyperopt_tpu/algos/tpe.py``: the single-study tick and the study-batched
cohort).

One TPE ask is one tick (:func:`_tick`, the counterpart of
``_get_suggest_jit``): fold the trials finished since the last tick into
the device-resident padded history, derive a key per new id, and for
every label fit the adaptive-Parzen below/above mixtures, draw candidates
from the below mixture by inverse CDF, score EI = below log-density −
above log-density, select, and pack ``[B, L]`` values for one readback.
:func:`build_suggest_batched` is the same tick for a cohort of studies
that share a space, with the study axis as a leading batch dimension.

Batching is written out where the JAX package uses ``vmap``: keys carry a
leading id axis ``B``, and the grouped pipelines add a leading label axis
``G`` (``S·G`` for a cohort of ``S`` studies).  The Parzen fits depend on
the history only, so they run once per (study, label) and every id of
the ask shares them; the candidate draws and EI scores are
``[G, B, n_EI_candidates]``.  Un-quantized numeric EI scores go through
the CUDA kernel ``megakernel.ei_diff``, one launch per group covering all
its ids and labels; a cohort of a space ``megakernel.supports`` draws and
scores them in ``megakernel.fused_sample_ei`` instead.  Component picks
are gathers (``torch.gather`` after ``searchsorted``) where the JAX
package used a one-hot matmul, so no matrix product, and hence no TF32
rounding, is involved.  ``erf`` and ``ndtri`` are the float32 formulas
the JAX package's XLA code evaluates.  Compressed history (bf16, int8 or
fp8 codes) decodes to float32 at the read boundary (:func:`_read_vals`).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import megakernel, prng, quant
from .._env import parse_shard
from ..spaces import Dist, label_hash
from ..utils import LRUCache, device_constant
from . import rand

__all__ = [
    "EPS",
    "suggest",
    "suggest_async",
    "adaptive_parzen_normal",
    "linear_forgetting_weights",
    "normal_cdf",
    "lognormal_cdf",
    "gmm1_sample",
    "gmm1_lpdf",
    "lgmm1_sample",
    "lgmm1_lpdf",
    "categorical_posterior",
    "split_below_above",
    "erf",
    "xla_log",
    "xla_sqrt",
    "ndtri",
    "build_propose",
    "build_propose_with_scores",
    "build_propose_candidates",
    "build_suggest_batched",
    "suggest_sharded",
    "widened_profile",
    "cohort_key",
    "cohort_cache_stats",
    "cohort_cache_contains",
]

EPS = 1e-12
_default_prior_weight = 1.0
_default_n_startup_jobs = 20
_default_n_EI_candidates = 24
_default_gamma = 0.25
_default_linear_forgetting = 25

# f32-safe clip for inverse-CDF inputs (~16 ulp at 1.0 in float32)
_U_TINY = 1e-7
_SQRT2 = float(np.float32(math.sqrt(2.0)))
_F32_MAX = float(np.finfo(np.float32).max)


def _f32(v, like):
    """float32 ``v`` on ``like``'s device: a tensor moves there, a Python
    number or list is a cached device constant (no copy from the host on
    later calls, so a captured step can read it)."""
    if torch.is_tensor(v):
        return v.to(dtype=torch.float32, device=like.device)
    return device_constant(v, torch.float32, like.device)


def _fma(a, b, c):
    """``a * b + c`` rounded once, as XLA's fused multiply-add computes the
    JAX package's ``c + a * b``: the float64 product of two float32 values
    is exact.  It matters where the result feeds a steep function, such as
    ``ndtri`` near 0 or 1.  ``b`` and ``c`` may be float32-exact scalars."""
    a, b, c = (t.double() if torch.is_tensor(t) else t for t in (a, b, c))
    return (a * b + c).float()


@functools.lru_cache(maxsize=None)
def _coef_table(polys, device):
    """``[steps, k]`` float64 table of ``k`` polynomials' float32
    coefficients (highest power first), shorter ones led by zeros."""
    steps = max(len(c) for c in polys)
    tab = np.zeros((steps, len(polys)))
    for j, c in enumerate(polys):
        tab[steps - len(c):, j] = np.asarray(c, np.float32)
    return torch.tensor(tab, dtype=torch.float64, device=device)


def _horner(polys, x):
    """The polynomials ``polys`` (a tuple of coefficient tuples, highest
    power first) at float32 or float64-held float32 ``x``, one rounding
    per step as XLA's contracted ``jnp.polyval`` computes it.  ``x`` is
    ``[k, ...]`` (one row per polynomial) or ``[1, ...]`` (shared); the
    result is ``[k, ...]`` float32.  All ``k`` are evaluated together, so
    a step is four launches whatever ``k``; a leading zero coefficient
    leaves a shorter polynomial's value as it would be."""
    tab = _coef_table(polys, x.device)
    col = (len(polys),) + (1,) * (x.dim() - 1)
    xd = x.double()
    y = tab[0].view(col)
    for i in range(1, tab.shape[0]):
        y = (y.double() * xd + tab[i].view(col)).float()
    return y


def _lead(v, nd):
    """A per-label ``[G]`` tensor shaped to broadcast over ``nd`` dims."""
    return v.reshape(v.shape[:1] + (1,) * (nd - 1))


# ---------------------------------------------------------------------------
# special functions: the float32 formulas the JAX package's XLA CPU code
# evaluates, so both packages compute one function (ROADMAP.md queue 3)
# ---------------------------------------------------------------------------

# the clamped rational form of XLA's float32 erf: odd numerator over even
# denominator in z^2, with z clamped where the quotient saturates
_ERF_P = (0.00022905065861350646, 0.0034082910107109506, 0.050955695062380861,
          0.18520832239976145, 1.128379143519084)
_ERF_Q = (-1.1791602954361697e-7, 0.000023547966471313185, 0.0010179625278914885,
          0.014070470171167667, 0.11098505178285362, 0.49746925110067538, 1.0)
_ERF_CLAMP = float(np.float32(3.7439211))

# Cephes' piecewise-rational ndtri (the formula of jax.scipy.special.ndtri):
# P0/Q0 for the central region, P1/Q1 and P2/Q2 (z >= 8) for the tails
_NDTRI_P0 = (-5.99633501014107895267e1, 9.80010754185999661536e1,
             -5.66762857469070293439e1, 1.39312609387279679503e1,
             -1.23916583867381258016e0)
_NDTRI_Q0 = (1.0, 1.95448858338141759834e0, 4.67627912898881538453e0,
             8.63602421390890590575e1, -2.25462687854119370527e2,
             2.00260212380060660359e2, -8.20372256168333339912e1,
             1.59056225126211695515e1, -1.18331621121330003142e0)
_NDTRI_P1 = (4.05544892305962419923e0, 3.15251094599893866154e1,
             5.71628192246421288162e1, 4.40805073893200834700e1,
             1.46849561928858024014e1, 2.18663306850790267539e0,
             -1.40256079171354495875e-1, -3.50424626827848203418e-2,
             -8.57456785154685413611e-4)
_NDTRI_Q1 = (1.0, 1.57799883256466749731e1, 4.53907635128879210584e1,
             4.13172038254672030440e1, 1.50425385692907503408e1,
             2.50464946208309415979e0, -1.42182922854787788574e-1,
             -3.80806407691578277194e-2, -9.33259480895457427372e-4)
_NDTRI_P2 = (3.23774891776946035970e0, 6.91522889068984211695e0,
             3.93881025292474443415e0, 1.33303460815807542389e0,
             2.01485389549179081538e-1, 1.23716634817820021358e-2,
             3.01581553508235416007e-4, 2.65806974686737550832e-6,
             6.23974539184983293730e-9)
_NDTRI_Q2 = (1.0, 6.02427039364742014255e0, 3.67983563856160859403e0,
             1.37702099489081330271e0, 2.16236993594496635890e-1,
             1.34204006088543189037e-2, 3.28014464682127739104e-4,
             2.89247864745380683936e-6, 6.79019408009981274425e-9)
_NDTRI_POLYS = (_NDTRI_P0, _NDTRI_Q0, _NDTRI_P2, _NDTRI_Q2, _NDTRI_P1, _NDTRI_Q1)
_EXP_M2 = float(np.float32(np.exp(-2.0)))
_ONE_MINUS_EXP_M2 = float(np.float32(-np.expm1(-2.0)))
_NEG_SQRT_2PI = -float(np.float32(np.sqrt(2.0 * np.pi)))

# XLA's float32 log (Cephes' logf): the mantissa folded into
# [sqrt(1/2), sqrt(2)) and shifted by -1, a degree-8 polynomial in three
# interleaved groups of three (highest power first), the exponent added
# back as e * (_LOG_Q2 + _LOG_Q1), a split ln 2
_LOG_P = tuple(float(np.float32(c)) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_GROUPS = (_LOG_P[0:3], _LOG_P[3:6], _LOG_P[6:9])
_LOG_Q1, _LOG_Q2 = float(np.float32(-2.12194440e-4)), 0.693359375
_SQRT_HALF = float(np.float32(0.707106781186547524))


def erf(z):
    """float32 ``erf`` by the clamped rational form XLA's CPU code uses."""
    z = torch.clamp(z, -_ERF_CLAMP, _ERF_CLAMP)
    p, q = _horner((_ERF_P, _ERF_Q), (z * z)[None])
    return (z * p) / q


def xla_log(x):
    """float32 ``log`` of positive normal ``x`` as XLA's CPU code computes
    it (bitwise): Cephes' range reduction and polynomial, its
    multiply-adds contracted to FMAs.  ``ndtri`` gives it nothing else, so
    XLA's special cases (zero, subnormal, negative, inf) are left out."""
    bits = x.view(torch.int32)
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)  # in [0.5, 1)
    small = (m < _SQRT_HALF).float()
    e = ((bits >> 23) - 126).float() - small
    f = (m - 1.0) + m * small
    f2 = f * f
    f3 = (f2 * f).double()
    g = _horner(_LOG_GROUPS, f.double()[None])  # the three groups at once
    y = _fma(_fma(_fma(g[0], f3, g[1]), f3, g[2]), f3, e * _LOG_Q1)
    return _fma(e, _LOG_Q2, (f - 0.5 * f2) + y)


def xla_sqrt(v):
    """float32 ``sqrt`` rounded correctly, as XLA's CPU code computes it
    (``torch.sqrt`` on the CPU is an ulp off on some inputs); the float64
    root rounds to the same float32."""
    return torch.sqrt(v.double()).float()


def ndtri(p):
    """Inverse standard-normal CDF of float32 ``p`` in ``(0, 1)``: Cephes'
    piecewise-rational formula as XLA compiles the JAX package's ``ndtri``
    (bitwise): its ``log`` and ``sqrt`` (:func:`xla_log`,
    :func:`xla_sqrt`), ``log(sqrt(y))`` rewritten as ``0.5 * log(y)`` and
    ``a / b / z`` as ``a / (b * z)``.  The fused sample-and-score kernel
    carries the same form."""
    mcp = torch.where(p > _ONE_MINUS_EXP_M2, 1.0 - p, p)
    s = torch.where(mcp == 0.0, torch.full_like(p, 0.5), mcp)
    w = s - 0.5
    ww = w * w
    y = -2.0 * xla_log(s)
    z = xla_sqrt(y)
    first = z - (xla_log(y) * 0.5) / z
    iz = 1.0 / z
    # the six polynomials in one pass: P0/Q0 at ww, the two tails' at 1/z
    p0, q0, p2, q2, p1, q1 = _horner(_NDTRI_POLYS, torch.stack((ww, ww, iz, iz, iz, iz)))
    big = _fma(w * ww, p0 / q0, w) * _NEG_SQRT_2PI
    tail_far = p2 / (q2 * z)
    tail = p1 / (q1 * z)
    x = torch.where(s > _EXP_M2, big, torch.where(z >= 8.0, first - tail_far, first - tail))
    return torch.where(p > _ONE_MINUS_EXP_M2, x, -x)


# ---------------------------------------------------------------------------
# cdf helpers
# ---------------------------------------------------------------------------


def normal_cdf(x, mu, sigma):
    z = (x - mu) / (_SQRT2 * sigma)
    return 0.5 * (1.0 + erf(z))


def lognormal_cdf(x, mu, sigma):
    """CDF at x>=0 of exp(N(mu, sigma)); 0 for x<=0."""
    x = torch.clamp(x, min=0.0)
    safe = torch.clamp(x, min=EPS)
    return torch.where(x > 0, normal_cdf(torch.log(safe), mu, sigma),
                       torch.zeros_like(x))


# ---------------------------------------------------------------------------
# adaptive Parzen fit
# ---------------------------------------------------------------------------


def linear_forgetting_weights(obs_mask, LF):
    """Per-slot forgetting weight in insertion order over ``[..., cap]``:
    the oldest ``N-LF`` live slots ramp linearly from ``1/N`` to 1, the
    newest ``LF`` weigh 1, padding 0."""
    mask = obs_mask.to(torch.float32)
    n = mask.sum(-1, keepdim=True)
    pos = torch.cumsum(mask, -1) - 1.0
    n_ramp = n - LF
    denom = torch.clamp(n_ramp - 1.0, min=1.0)
    inv_n = 1.0 / torch.clamp(n, min=1.0)
    ramp = inv_n + pos * (1.0 - inv_n) / denom
    one = torch.ones_like(ramp)
    w = torch.where(pos >= n_ramp, one, ramp)
    w = torch.where(n <= LF, one, w)
    return w * mask


def adaptive_parzen_normal(obs, obs_mask, prior_weight, prior_mu, prior_sigma, LF):
    """Adaptive Parzen fit over ``[..., cap]`` observations: returns
    ``(weights, mus, sigmas)`` of length ``cap+1`` sorted by location, the
    prior inserted at its place with ``prior_sigma``; each observation's
    sigma is its larger neighbour gap clipped to
    ``[prior_sigma / min(100, 1 + m), prior_sigma]``; weights use linear
    forgetting and sum to 1.  Dead slots get weight 0, ``mu=prior_mu``,
    ``sigma=prior_sigma``.  The sort is stable, as ``jnp.argsort`` is:
    tied values keep insertion order and their forgetting weights."""
    cap = obs.shape[-1]
    obs_mask = obs_mask.to(torch.bool)
    prior_mu = _f32(prior_mu, obs).expand(obs.shape[:-1])
    prior_sigma = _f32(prior_sigma, obs).expand(obs.shape[:-1])
    m = obs_mask.sum(-1, keepdim=True) + 1  # live components incl. prior

    lfw = linear_forgetting_weights(obs_mask, LF)
    vals_c = torch.cat([torch.where(obs_mask, obs, _f32(_F32_MAX, obs)),
                        prior_mu[..., None]], -1)
    wts_c = torch.cat([lfw, torch.full_like(lfw[..., :1], float(prior_weight))], -1)
    idx = torch.arange(cap + 1, device=obs.device)
    prior_c = (idx == cap).expand(vals_c.shape)

    order = torch.argsort(vals_c, dim=-1, stable=True)
    svals = torch.gather(vals_c, -1, order)
    swts = torch.gather(wts_c, -1, order)
    sprior = torch.gather(prior_c, -1, order)

    prev_gap = svals - torch.cat([svals[..., :1], svals[..., :-1]], -1)
    next_gap = torch.cat([svals[..., 1:], svals[..., -1:]], -1) - svals
    prev_ok = (idx >= 1) & (idx < m)
    next_ok = idx < (m - 1)
    neg = torch.full_like(svals, -1.0)
    sigma = torch.maximum(torch.where(prev_ok, prev_gap, neg),
                          torch.where(next_ok, next_gap, neg))
    psig = prior_sigma[..., None].expand_as(sigma)
    sigma = torch.where(m == 1, psig, torch.clamp(sigma, min=0.0))

    minsigma = psig / torch.clamp(1.0 + m.to(torch.float32), max=100.0)
    sigma = torch.minimum(torch.maximum(sigma, minsigma), psig)
    sigma = torch.where(sprior, psig, sigma)

    live = idx < m
    svals = torch.where(live, svals, prior_mu[..., None].expand_as(svals))
    sigma = torch.where(live, sigma, psig)
    swts = torch.where(live, swts, torch.zeros_like(swts))
    swts = swts / swts.sum(-1, keepdim=True)
    return swts, svals, sigma


# ---------------------------------------------------------------------------
# truncated GMM sampling (inverse-CDF truncation) and log-densities
# ---------------------------------------------------------------------------


def _trunc_masses(weights, mus, sigmas, low, high):
    """Per-component in-bounds CDF mass and the mixture acceptance
    probability; ``low``/``high`` are Python floats (±inf = unbounded)."""
    alpha = (normal_cdf(low, mus, sigmas) if math.isfinite(low)
             else torch.zeros_like(mus))
    beta = (normal_cdf(high, mus, sigmas) if math.isfinite(high)
            else torch.ones_like(mus))
    mass = torch.clamp(beta - alpha, 0.0, 1.0)
    p_accept = (weights * mass).sum(-1)
    return alpha, beta, mass, p_accept


def _cdf(w):
    """Normalized CDF of nonnegative component weights ``[G, m]``; kept
    non-decreasing so ``searchsorted`` counts ``#{cdf < u}`` exactly."""
    cdf = torch.cumsum(w, -1)
    cdf = cdf / torch.clamp(cdf[..., -1:], min=EPS)
    return torch.cummax(cdf, -1).values


def _pick(cdf, u):
    """Component index per draw ``u[G, ...]``: the number of CDF entries
    below ``u``, capped at the last component."""
    G, m = cdf.shape
    comp = torch.searchsorted(cdf, u.reshape(G, -1).contiguous())
    return torch.clamp(comp, max=m - 1).reshape(u.shape)


def _take(table, comp):
    """``table[G, m]`` gathered at ``comp[G, ...]``."""
    G = table.shape[0]
    return torch.gather(table, 1, comp.reshape(G, -1)).reshape(comp.shape)


def _sample_tables(weights, mus, sigmas, low, high, bounded):
    """The below mixture's sampling tables ``[G, m]``: the normalized CDF
    of the weights reweighted by in-bounds mass, and each component's
    ``(alpha, beta)`` = its CDF at ``low``/``high`` ``[G]`` (0 and 1 for
    an unbounded group)."""
    if not bounded:
        return _cdf(weights), torch.zeros_like(mus), torch.ones_like(mus)
    alpha = normal_cdf(low[:, None], mus, sigmas)
    beta = normal_cdf(high[:, None], mus, sigmas)
    return _cdf(weights * torch.clamp(beta - alpha, 0.0, 1.0)), alpha, beta


def _draw_uniforms(keys, n_samples):
    """The sampler's two uniform draws ``[..., n]`` per key ``[..., 2]``:
    component picks from ``split(key)[0]``, interval positions from
    ``split(key)[1]``."""
    ks = prng.split(keys)
    return (prng.uniform(ks[..., 0, :], (n_samples,)),
            prng.uniform(ks[..., 1, :], (n_samples,)))


def _draw_from_tables(uc, u0, cdf, mus, sigmas, alpha, beta, low, high, bounded):
    """Candidates ``x[G, ...]`` from uniforms ``uc``/``u0`` ``[G, ...]`` and
    tables ``[G, m]``: the component at the first ``cdf >= uc`` (the last
    if none), ``x = mu + sigma * ndtri(clip(alpha + u0 (beta - alpha)))``
    with single-rounding FMAs, clamped for a bounded group into
    ``[low, nextafter(high, low)]``.  The plain version of the fused
    kernel's sampling half."""
    comp = _pick(cdf, uc)
    mu_s, sigma_s = _take(mus, comp), _take(sigmas, comp)
    a_s, b_s = _take(alpha, comp), _take(beta, comp)
    u = torch.clamp(_fma(u0, b_s - a_s, a_s), _U_TINY, 1.0 - _U_TINY)
    x = _fma(sigma_s, ndtri(u), mu_s)
    if not bounded:
        return x
    nd = x.dim()
    return torch.minimum(torch.maximum(x, _lead(low, nd)),
                         _lead(torch.nextafter(high, low), nd))


def _gmm1_sample_bounded(keys, weights, mus, sigmas, low, high, n_samples):
    """Truncated-mixture draws for labels with finite bounds ``low``/
    ``high`` ``[G]``: keys ``[G, B, 2]``, tables ``[G, m]`` → ``[G, B, n]``.
    The component is drawn from the weights reweighted by truncated mass,
    then ``x = mu + sigma * ndtri(U(alpha, beta))``, clamped into
    ``[low, nextafter(high, low)]``."""
    cdf, alpha, beta = _sample_tables(weights, mus, sigmas, low, high, True)
    uc, u0 = _draw_uniforms(keys, n_samples)
    return _draw_from_tables(uc, u0, cdf, mus, sigmas, alpha, beta, low, high, True)


def gmm1_sample(keys, weights, mus, sigmas, low, high, q, n_samples):
    """``n_samples`` draws per key ``[B, 2]`` from one truncated (optionally
    quantized) mixture ``[m]``; ``low``/``high`` are Python floats."""
    low, high = float(low), float(high)
    if q is None and math.isfinite(low) and math.isfinite(high):
        return _gmm1_sample_bounded(
            keys[None], weights[None], mus[None], sigmas[None],
            _f32([low], weights), _f32([high], weights), n_samples)[0]
    alpha, beta, mass, _ = _trunc_masses(weights, mus, sigmas, low, high)
    cdf = _cdf((weights * mass)[None])
    ks = prng.split(keys)
    comp = _pick(cdf, prng.uniform(ks[..., 0, :], (n_samples,))[None])
    mu_s, sigma_s = _take(mus[None], comp)[0], _take(sigmas[None], comp)[0]
    a_s, b_s = _take(alpha[None], comp)[0], _take(beta[None], comp)[0]
    u0 = prng.uniform(ks[..., 1, :], (n_samples,))
    u = torch.clamp(_fma(u0, b_s - a_s, a_s), _U_TINY, 1.0 - _U_TINY)
    x = _fma(sigma_s, ndtri(u), mu_s)
    if math.isfinite(low):
        x = torch.clamp(x, min=low)
    if math.isfinite(high):
        x = torch.clamp(x, max=float(np.nextafter(np.float32(high), np.float32(low))))
    if q is not None:
        x = torch.round(x / q) * q
    return x


def lgmm1_sample(keys, weights, mus, sigmas, low, high, q, n_samples):
    """Truncated lognormal mixture draws: the underlying normal is truncated
    to the log-space ``[low, high]``, the draw is its exp, then quantized."""
    x = torch.exp(gmm1_sample(keys, weights, mus, sigmas, low, high, None, n_samples))
    if q is not None:
        x = torch.round(x / q) * q
    return x


def _mixture_lse(x, weights, mus, sigmas):
    """``log sum_i w_i N(x; mu_i, sigma_i)`` for tables ``[m]``, plain torch."""
    comp = (torch.log(torch.clamp(weights, min=EPS))[:, None]
            - 0.5 * ((x.reshape(1, -1) - mus[:, None]) / sigmas[:, None]) ** 2
            - torch.log(sigmas)[:, None] - 0.5 * math.log(2.0 * math.pi))
    comp = torch.where(weights[:, None] > 0, comp, torch.full_like(comp, -math.inf))
    return torch.logsumexp(comp, 0).reshape(x.shape)


def _q_prob(ub, lb, weights, mus, sigmas, cdf):
    """Mixture mass of the bins ``[lb, ub]`` (``[..., N]`` against tables
    ``[..., m]``)."""
    W, MU, SG = weights[..., None], mus[..., None], sigmas[..., None]
    ub, lb = ub[..., None, :], lb[..., None, :]
    return (W * (cdf(ub, MU, SG) - cdf(lb, MU, SG))).sum(-2)


def gmm1_lpdf(x, weights, mus, sigmas, low, high, q):
    """Log-density of one truncated (quantized) mixture ``[m]`` at ``x``;
    the quantized case integrates each bin ``[x-q/2, x+q/2] ∩ [low, high]``."""
    low, high = float(low), float(high)
    _, _, _, p_accept = _trunc_masses(weights, mus, sigmas, low, high)
    lpa = torch.log(torch.clamp(p_accept, min=EPS))
    if q is None:
        out = _mixture_lse(x, weights, mus, sigmas) - lpa
        return out.masked_fill(~_in_support(x, low, high, False), -math.inf)
    flat = x.reshape(-1)
    ub, lb = flat + q / 2, flat - q / 2
    if math.isfinite(high):
        ub = torch.clamp(ub, max=high)
    if math.isfinite(low):
        lb = torch.clamp(lb, min=low)
    prob = _q_prob(ub, lb, weights, mus, sigmas, normal_cdf)
    return (torch.log(torch.clamp(prob, min=EPS)) - lpa).reshape(x.shape)


def lgmm1_lpdf(x, weights, mus, sigmas, low, high, q):
    """Log-density of one truncated lognormal mixture ``[m]``; ``low``/
    ``high`` are log-space bounds, and the quantized case integrates
    value-space bins with the lower edge clamped at 0."""
    low, high = float(low), float(high)
    _, _, _, p_accept = _trunc_masses(weights, mus, sigmas, low, high)
    lpa = torch.log(torch.clamp(p_accept, min=EPS))
    if q is None:
        logx = torch.log(torch.clamp(x, min=EPS))
        out = _mixture_lse(logx, weights, mus, sigmas) - logx - lpa
        return out.masked_fill(~_in_support(x, low, high, True), -math.inf)
    flat = x.reshape(-1)
    ub = flat + q / 2
    lb = torch.clamp(flat - q / 2, min=0.0)
    if math.isfinite(high):
        ub = torch.clamp(ub, max=math.exp(high))
    if math.isfinite(low):
        lb = torch.clamp(lb, min=math.exp(low))
    prob = _q_prob(ub, lb, weights, mus, sigmas, lognormal_cdf)
    return (torch.log(torch.clamp(prob, min=EPS)) - lpa).reshape(x.shape)


def _in_support(x, low, high, log_space):
    """Where the (log-space) truncated density at value ``x`` is finite."""
    inb = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    t = x
    if log_space:
        inb = x > 0
        t = torch.log(torch.clamp(x, min=EPS))
    if math.isfinite(low):
        inb = inb & (t >= low)
    if math.isfinite(high):
        inb = inb & (t < high)
    return inb


def _q_lpdf_group(x, weights, mus, sigmas, lo, hi, q, islog, bounded,
                  has_log=True):
    """Quantized-bin log-density for a group: ``x[G, ...]`` against tables
    ``[G, m]`` and per-label statics ``[G]``, bin for bin the per-label
    q-paths (normal cdf on the bounded support for linear labels,
    lognormal cdf with the lower edge at 0 for log labels)."""
    G = x.shape[0]
    flat = x.reshape(G, -1)
    q2 = (q / 2)[:, None]
    ub, lb = flat + q2, flat - q2
    if bounded:
        ubn, lbn = torch.minimum(ub, hi[:, None]), torch.maximum(lb, lo[:, None])
    else:
        ubn, lbn = ub, lb
    prob = _q_prob(ubn, lbn, weights, mus, sigmas, normal_cdf)
    if has_log:
        lbl = torch.clamp(lb, min=0.0)
        if bounded:
            ubl = torch.minimum(ub, torch.exp(hi)[:, None])
            lbl = torch.maximum(lbl, torch.exp(lo)[:, None])
        else:
            ubl = ub
        pl = _q_prob(ubl, lbl, weights, mus, sigmas, lognormal_cdf)
        prob = torch.where(islog[:, None], pl, prob)
    p_accept = _p_accept_group(weights, mus, sigmas, lo, hi, bounded)
    out = (torch.log(torch.clamp(prob, min=EPS))
           - torch.log(torch.clamp(p_accept, min=EPS))[:, None])
    return out.reshape(x.shape)


def _p_accept_group(weights, mus, sigmas, lo, hi, bounded):
    """Each label's in-bounds mixture mass ``[G]`` (``sum(weights)`` for an
    unbounded group)."""
    if not bounded:
        return weights.sum(-1)
    alpha = normal_cdf(lo[:, None], mus, sigmas)
    beta = normal_cdf(hi[:, None], mus, sigmas)
    return (weights * torch.clamp(beta - alpha, 0.0, 1.0)).sum(-1)


def _ei_kernel(x_t, below, above, p_b, p_a):
    """EI of t-space points ``x_t[G, ...]`` under the group's below/above
    tables ``(w, mu, sigma)`` ``[G, m]``, through ``megakernel.ei_diff``
    (one launch for every id and label of the group), plus the truncation
    normalizers ``-log p_b + log p_a`` ``[G]``."""
    G = x_t.shape[0]
    raw = megakernel.ei_diff(x_t.reshape(G, -1).contiguous(), *below, *above)
    return _normalize_ei(raw.reshape(x_t.shape), p_b, p_a)


def _normalize_ei(raw, p_b, p_a):
    """Raw two-mixture log-density difference ``[G, ...]`` plus the
    truncation normalizers ``-log p_b + log p_a`` ``[G]``."""
    nd = raw.dim()
    return (raw - _lead(torch.log(torch.clamp(p_b, min=EPS)), nd)
            + _lead(torch.log(torch.clamp(p_a, min=EPS)), nd))


def _nan_to_neg_inf(ei):
    # -inf − -inf must never win the argmax
    return ei.masked_fill(torch.isnan(ei), -math.inf)


# ---------------------------------------------------------------------------
# categorical / randint posterior and the below/above split
# ---------------------------------------------------------------------------


def categorical_posterior(obs, obs_mask, prior_p, prior_weight, LF):
    """Pseudocount-smoothed posterior over ``K`` buckets for ``obs[..., cap]``
    and ``prior_p[..., K]``: forgetting-weighted counts plus
    ``K * prior_weight * prior_p``, normalized.  Out-of-range observations
    count nowhere."""
    K = prior_p.shape[-1]
    lfw = linear_forgetting_weights(obs_mask, LF)
    onehot = (obs[..., None] == torch.arange(K, device=obs.device)).to(torch.float32)
    counts = (onehot * lfw[..., None]).sum(-2)
    pseudo = counts + K * prior_weight * prior_p
    return pseudo / pseudo.sum(-1, keepdim=True)


def split_below_above(losses, has_loss, gamma, LF):
    """Boolean masks ``[..., cap]`` of the best ``min(ceil(gamma*sqrt(N)),
    LF)`` trials vs the rest, over trials that reported a loss; ties keep
    insertion order (stable sort).  Leading dims are studies."""
    cap = losses.shape[-1]
    N = has_loss.sum(-1, keepdim=True).to(torch.float32)
    n_below = torch.clamp(torch.ceil(gamma * torch.sqrt(N)), max=float(LF))
    keyed = torch.where(has_loss, losses, _f32(_F32_MAX, losses))
    order = torch.argsort(keyed, dim=-1, stable=True)
    pos = torch.arange(cap, device=losses.device).expand(order.shape)
    rank = torch.empty_like(order).scatter_(-1, order, pos)
    below = (rank < n_below) & has_loss
    return below, has_loss & ~below


# ---------------------------------------------------------------------------
# per-family proposals
# ---------------------------------------------------------------------------


def _parzen_from(dist: Dist):
    """Static (prior_mu, prior_sigma, low, high, q, log_space) of a numeric
    family."""
    fam, p = dist.family, dist.params
    inf = float("inf")
    if fam == "uniform":
        low, high = p
        return 0.5 * (low + high), high - low, low, high, None, False
    if fam == "quniform":
        low, high, q = p
        return 0.5 * (low + high), high - low, low, high, q, False
    if fam == "uniformint":
        # the reference lowers hp.uniformint to quniform(low-0.5, high+0.5, q=1)
        low, high = p[0] - 0.5, p[1] + 0.5
        return 0.5 * (low + high), high - low, low, high, 1.0, False
    if fam == "loguniform":
        low, high = p
        return 0.5 * (low + high), high - low, low, high, None, True
    if fam == "qloguniform":
        low, high, q = p
        return 0.5 * (low + high), high - low, low, high, q, True
    if fam == "normal":
        mu, sigma = p
        return mu, sigma, -inf, inf, None, False
    if fam == "qnormal":
        mu, sigma, q = p
        return mu, sigma, -inf, inf, q, False
    if fam == "lognormal":
        mu, sigma = p
        return mu, sigma, -inf, inf, None, True
    if fam == "qlognormal":
        mu, sigma, q = p
        return mu, sigma, -inf, inf, q, True
    raise ValueError(f"no parzen prior for family {dist.family!r}")


def _stack_parzen_statics(parz):
    """Per-label ``_parzen_from`` tuples stacked into the group statics
    (unbounded groups never read low/high, so 0.0 keeps them finite;
    unquantized labels carry q=1.0)."""
    return {
        "prior_mu": np.asarray([p[0] for p in parz], np.float32),
        "prior_sigma": np.asarray([p[1] for p in parz], np.float32),
        "low": np.asarray([p[2] if math.isfinite(p[2]) else 0.0 for p in parz],
                          np.float32),
        "high": np.asarray([p[3] if math.isfinite(p[3]) else 0.0 for p in parz],
                           np.float32),
        "q": np.asarray([p[4] if p[4] is not None else 1.0 for p in parz],
                        np.float32),
        "islog": np.asarray([p[5] for p in parz], bool),
    }


def _prior_probs(dist: Dist) -> np.ndarray:
    """Static prior bucket probabilities for the discrete families."""
    if dist.family == "categorical":
        p = np.asarray(dist.params, np.float32)
        return p / p.sum()
    if dist.family == "randint":
        low, high = dist.params
        K = int(high) - int(low)
        return np.full(K, 1.0 / K, np.float32)
    raise ValueError(f"not a discrete family: {dist.family!r}")


def _gather_last(v, i):
    return torch.gather(v, -1, i[..., None])[..., 0]


def _select_candidate(keys, samples, ei, cfg):
    """Pick one candidate per key from ``samples/ei[..., n]``: the EI
    argmax (first maximum), or with ``ei_select="softmax"`` a Gumbel-max
    draw ``∝ softmax(EI / ei_tau)``."""
    if cfg.get("ei_select", "argmax") == "softmax":
        tau = float(cfg.get("ei_tau", 1.0))
        u = prng.uniform(prng.fold_in(keys, 0x5E1EC7), (ei.shape[-1],),
                         _U_TINY, 1.0 - _U_TINY)
        i = torch.argmax(ei / tau - torch.log(-torch.log(u)), dim=-1)
    else:
        i = torch.argmax(ei, dim=-1)
    return _gather_last(samples, i), _gather_last(ei, i)


def _mix_prior(keys, cfg, val, ei_sel, draw, score):
    """With probability ``cfg['prior_eps']`` replace the selected candidate
    by a fresh prior draw scored under the same models:
    ``fold_in(key, 0x9B10B)`` feeds the draw and ``fold_in(key, 0xE9510)``
    the take-gate, for the grouped and per-label paths alike.
    ``draw(keys) -> [...]``; ``score(x[..., 1]) -> [..., 1]``.  Returns
    ``(value, ei, take)``: the bool take flags feed the health stats
    (None when ``prior_eps`` is 0: nothing is drawn)."""
    eps = float(cfg.get("prior_eps", 0.0))
    if eps <= 0.0:
        return val, ei_sel, None
    xp = draw(prng.fold_in(keys, 0x9B10B))
    ei_p = score(xp[..., None])[..., 0]
    take = prng.uniform(prng.fold_in(keys, 0xE9510), ()) < eps
    return (torch.where(take, xp.to(val.dtype), val), torch.where(take, ei_p, ei_sel),
            take)


def _diag_stats(samples, ei, ei_sel, wb, below_mask, prior_mass, LF, take,
                discrete=False):
    """The per-label :data:`~hyperopt_tpu_torch.obs.health.HEALTH_STATS`
    vectors ``[..., B, 9]`` of one tick: EI quantiles, the selected
    candidate's EI rank, the duplicate-candidate rate, the below model's
    effective component count and prior-mass fraction, the ε-prior take
    flag.  ``samples``/``ei`` ``[..., B, n]``, ``ei_sel``/``take`` ``[...,
    B]`` (``take`` None: no ε-prior), ``wb`` ``[..., m]`` (the below
    model's normalized weights, or the discrete posterior) and
    ``below_mask`` ``[..., cap]``.  Pure post-processing of the
    proposal's arrays: no draw, the proposals stay bit for bit the
    disarmed ones."""
    n = ei.shape[-1]
    s = torch.sort(ei, dim=-1).values
    q = [s[..., min(n - 1, int(round(p * (n - 1))))] for p in (0.10, 0.50, 0.90)]
    sel_rank = (ei > ei_sel[..., None]).sum(-1).to(torch.float32)
    if n > 1:
        sv = torch.sort(samples.to(torch.float32), dim=-1).values
        gaps = sv[..., 1:] - sv[..., :-1]
        if discrete:
            dups = (gaps == 0.0).sum(-1)
        else:
            scale = torch.clamp(sv[..., -1] - sv[..., 0], min=EPS)
            dups = (gaps <= 1e-6 * scale[..., None]).sum(-1)
        # XLA turns the division by the constant n-1 into a product with
        # its float32 reciprocal: so does the port, bit for bit
        dup = dups.to(torch.float32) * float(np.float32(1) / np.float32(n - 1))
    else:
        dup = torch.zeros_like(sel_rank)
    eff = 1.0 / torch.clamp((wb * wb).sum(-1), min=EPS)
    obs_mass = linear_forgetting_weights(below_mask, LF).sum(-1)
    # the float32 prior mass, filled on the device (no copy from the host,
    # which would wait for the tick's queued work) and divided, not
    # multiplied by a reciprocal
    pm = float(np.float32(prior_mass))
    prior_frac = torch.full_like(obs_mass, pm) / torch.clamp(obs_mass + pm, min=EPS)
    per_label = torch.stack([eff, prior_frac], dim=-1)
    per_label = per_label[..., None, :].expand(sel_rank.shape + (2,))
    took = (take.to(torch.float32) if take is not None
            else torch.zeros_like(sel_rank))
    return torch.cat([torch.stack(q + [s[..., -1], sel_rank, dup], dim=-1), per_label,
                      took[..., None]], dim=-1)


def _prior_draw_numeric(keys, prior_mu, prior_sigma, low, high, q, log_space):
    """One draw per key from the search-space prior of a numeric family
    (static Python bounds)."""
    low, high = float(low), float(high)
    if math.isfinite(low) and math.isfinite(high):
        u = prng.uniform(keys, (), 0.0, 1.0 - _U_TINY)
        z = _fma(u, _f32(high - low, u), _f32(low, u))
    else:
        n = prng.normal(keys, ())
        z = _fma(_f32(prior_sigma, n), n, _f32(prior_mu, n))
    x = torch.exp(z) if log_space else z
    if q is not None:
        x = torch.round(x / q) * q
    return x


def _fit_pair(obs, below, above, cfg, prior_mu, prior_sigma):
    fit = lambda mask: adaptive_parzen_normal(  # noqa: E731
        obs, mask, cfg["prior_weight"], prior_mu, prior_sigma, cfg["LF"])
    return fit(below), fit(above)


def _propose_numeric(keys, dist, vals, below_mask, above_mask, cfg, raw=False,
                     diag=False):
    """One numeric label for keys ``[B, 2]``: fit both mixtures, draw
    ``n_EI_candidates`` from the below one, score EI, select; returns
    ``(value[B], ei[B])``, with ``diag=True`` also its health stats
    ``[B, 9]`` (:func:`_diag_stats`), or with ``raw=True`` the candidate
    pool ``(samples[B, n], ei[B, n])``."""
    prior_mu, prior_sigma, low, high, q, log_space = _parzen_from(dist)
    obs = torch.log(torch.clamp(vals, min=EPS)) if log_space else vals
    tb, ta = _fit_pair(obs[None], below_mask[None], above_mask[None], cfg,
                       prior_mu, prior_sigma)
    wb, mb, sb = (t[0] for t in tb)
    wa, ma, sa = (t[0] for t in ta)
    sampler = lgmm1_sample if log_space else gmm1_sample
    samples = sampler(keys, wb, mb, sb, low, high, q, cfg["n_EI_candidates"])
    if q is None:
        p_b = _trunc_masses(wb, mb, sb, low, high)[3][None]
        p_a = _trunc_masses(wa, ma, sa, low, high)[3][None]

        def score(xs):
            x_t = torch.log(torch.clamp(xs, min=EPS)) if log_space else xs
            ei = _ei_kernel(x_t[None], tb, ta, p_b, p_a)[0]
            return ei.masked_fill(~_in_support(xs, low, high, log_space), -math.inf)
    else:
        lpdf = lgmm1_lpdf if log_space else gmm1_lpdf

        def score(xs):
            return (lpdf(xs, wb, mb, sb, low, high, q)
                    - lpdf(xs, wa, ma, sa, low, high, q))

    ei = _nan_to_neg_inf(score(samples))
    if raw:
        return samples, ei
    val, ei_sel = _select_candidate(keys, samples, ei, cfg)
    out, ei_out, take = _mix_prior(
        keys, cfg, val, ei_sel,
        lambda kp: _prior_draw_numeric(kp, prior_mu, prior_sigma, low, high,
                                       q, log_space),
        score)
    if not diag:
        return out, ei_out
    return out, ei_out, _diag_stats(samples, ei, ei_sel, wb, below_mask,
                                    cfg["prior_weight"], cfg["LF"], take)


def _propose_numeric_group(keys, obs, below, above, statics, cfg,
                           quantized, bounded, has_log=True, fused=False, diag=False):
    """The numeric pipeline for a GROUP of labels sharing a (quantized?,
    bounded?) shape: keys ``[G, B, 2]``, history ``[G, cap]``, statics
    ``[G]``; returns ``(value[G, B], ei[G, B])`` (with ``diag=True`` also
    the health stats ``[G, B, 9]``).  Per label it is the math
    of :func:`_propose_numeric`, run in z-space (log space for log labels;
    the log-density's Jacobian cancels inside EI), with quantization in
    value space.  ``fused=True`` (un-quantized groups) draws and scores the
    candidates in one ``megakernel.fused_sample_ei`` launch from the same
    tables and uniforms; the mixtures are fitted once either way."""
    islog, q = statics["islog"], statics["q"]
    lo, hi = statics["low"], statics["high"]

    def to_value(z):
        if not has_log:
            return z
        return torch.where(_lead(islog, z.dim()), torch.exp(z), z)

    obs_z = (torch.where(islog[:, None], torch.log(torch.clamp(obs, min=EPS)), obs)
             if has_log else obs)
    tb, ta = _fit_pair(obs_z, below, above, cfg, statics["prior_mu"],
                       statics["prior_sigma"])
    cdf, alpha, beta = _sample_tables(*tb, lo, hi, bounded)
    uc, u0 = _draw_uniforms(keys, cfg["n_EI_candidates"])
    if not fused:
        z = _draw_from_tables(uc, u0, cdf, tb[1], tb[2], alpha, beta, lo, hi, bounded)

    if quantized:
        sel = torch.round(to_value(z) / _lead(q, 3)) * _lead(q, 3)

        def score(xs):
            return (_q_lpdf_group(xs, *tb, lo, hi, q, islog, bounded, has_log)
                    - _q_lpdf_group(xs, *ta, lo, hi, q, islog, bounded, has_log))
    else:
        p_b = _p_accept_group(*tb, lo, hi, bounded)
        p_a = _p_accept_group(*ta, lo, hi, bounded)

        def score(xs):
            ei = _ei_kernel(xs, tb, ta, p_b, p_a)
            if not bounded:
                return ei
            nd = xs.dim()
            inb = (xs >= _lead(lo, nd)) & (xs < _lead(hi, nd))
            return ei.masked_fill(~inb, -math.inf)

    if fused:
        # every fused candidate lies in [low, nextafter(high, low)], so the
        # support mask of `score` is a no-op here
        G = uc.shape[0]
        x, raw = megakernel.fused_sample_ei(
            uc.reshape(G, -1), u0.reshape(G, -1), cdf, tb[1], tb[2], alpha, beta,
            tb[0], *ta, lo, hi, bounded)
        sel = x.reshape(uc.shape)
        ei = _nan_to_neg_inf(_normalize_ei(raw.reshape(uc.shape), p_b, p_a))
    else:
        if not quantized:
            sel = z
        ei = _nan_to_neg_inf(score(sel))
    val, ei_sel = _select_candidate(keys, sel, ei, cfg)

    def draw(kp):
        if bounded:
            u = prng.uniform(kp, (), 0.0, 1.0 - _U_TINY)
            zp = _fma(u, (hi - lo)[:, None], lo[:, None])
        else:
            zp = _fma(statics["prior_sigma"][:, None], prng.normal(kp, ()),
                      statics["prior_mu"][:, None])
        if quantized:
            return torch.round(to_value(zp) / q[:, None]) * q[:, None]
        return zp

    val, ei_out, take = _mix_prior(keys, cfg, val, ei_sel, draw, score)
    if not quantized:
        val = to_value(val)
    if not diag:
        return val, ei_out
    return val, ei_out, _diag_stats(sel, ei, ei_sel, tb[0], below,
                                    cfg["prior_weight"], cfg["LF"], take)


def _prior_draw_discrete(keys, prior_p):
    """One inverse-CDF bucket draw per key ``[G, B, 2]`` from the discrete
    prior ``[G, K]``."""
    return _pick(_cdf(prior_p), prng.uniform(keys, ()))


def _propose_discrete_group(keys, obs, below, above, prior_ps, offsets, cfg, raw=False,
                            diag=False):
    """The discrete pipeline for a GROUP of labels sharing one bucket count
    ``K``: keys ``[G, B, 2]``, history ``[G, cap]``, priors ``[G, K]``,
    randint offsets ``[G]``; returns ``(value[G, B], ei[G, B])`` (with
    ``diag=True`` also the health stats ``[G, B, 9]``), or with
    ``raw=True`` the candidate pools ``[G, B, n]``."""
    obs_i = obs.to(torch.int64) - offsets[:, None]
    pb = categorical_posterior(obs_i, below, prior_ps, cfg["prior_weight"], cfg["LF"])
    pa = categorical_posterior(obs_i, above, prior_ps, cfg["prior_weight"], cfg["LF"])
    samples = _pick(_cdf(pb), prng.uniform(keys, (cfg["n_EI_candidates"],)))
    # clamped logs: a zero-probability bucket must not turn EI into NaN
    lpb = torch.log(torch.clamp(pb, min=EPS))
    lpa = torch.log(torch.clamp(pa, min=EPS))
    ei = _nan_to_neg_inf(_take(lpb, samples) - _take(lpa, samples))
    if raw:
        return samples + _lead(offsets, 3), ei
    val, ei_sel = _select_candidate(keys, samples, ei, cfg)
    diff = lpb - lpa
    val, ei_out, take = _mix_prior(
        keys, cfg, val, ei_sel,
        lambda kp: _prior_draw_discrete(kp, prior_ps),
        lambda xs: _take(diff, xs))
    if not diag:
        return val + offsets[:, None], ei_out
    return val + offsets[:, None], ei_out, _diag_stats(
        samples, ei, ei_sel, pb, below, prior_ps.shape[-1] * cfg["prior_weight"],
        cfg["LF"], take, discrete=True)


def _propose_discrete(keys, dist, vals, below_mask, above_mask, cfg, raw=False,
                      diag=False):
    """One categorical/randint label for keys ``[B, 2]``: the group
    pipeline at width one.  Returns ``(value[B], ei[B])`` (with
    ``diag=True`` also the health stats ``[B, 9]``), or with ``raw=True``
    the candidate pool ``(samples[B, n], ei[B, n])``."""
    prior_p = device_constant([_prior_probs(dist).tolist()], torch.float32, vals.device)
    offset = int(dist.params[0]) if dist.family == "randint" else 0
    offsets = device_constant([offset], torch.int64, vals.device)
    res = _propose_discrete_group(keys[None], vals[None], below_mask[None],
                                  above_mask[None], prior_p, offsets, cfg, raw=raw, diag=diag)
    return tuple(r[0] for r in res)


def _read_vals(history, label, qparams=None):
    """float32 view of one label's history column, the read boundary of
    compressed history: float storage (f32/bf16) upcasts, int8/fp8 codes
    decode with the label's ``(scale, zero, islog)``."""
    v = history["vals"][label]
    if qparams is not None and quant.quant_dtype_name(v.dtype) is not None:
        return quant.dequantize(v, qparams[label])
    return v.to(torch.float32)


def _quant_qparams(cs, hist_dtype):
    """Per-label qparams for a resolved storage name, or None unless it is
    int8/fp8: a pure function of (space, name)."""
    if hist_dtype is None or not quant.is_quant_name(hist_dtype):
        return None
    return quant.space_qparams(cs, hist_dtype)


# ---------------------------------------------------------------------------
# proposal steps and the tick
# ---------------------------------------------------------------------------


def _tile(v, S):
    """A per-label constant ``[G, ...]`` repeated for ``S`` studies, study
    major, as the flattened ``[S·G]`` group axis of a cohort is."""
    return v.repeat((S,) + (1,) * (v.dim() - 1))


def build_propose_with_scores(cs, cfg, group=True, qparams=None, fused=False,
                              diagnostics=False):
    """One proposal step ``propose(history, keys) -> {label: (value, ei)}``
    for a compiled space.

    History leaves are ``[*S, cap]``, keys ``[*S, B, 2]`` and the values
    come back ``[*S, B]``: ``S`` is empty for one study and one study axis
    for a cohort.  ``group=True`` routes labels through per-GROUP
    pipelines: numeric labels sharing a (quantized?, bounded?) shape,
    discrete labels sharing a bucket count; a family with a single label
    keeps the per-label pipeline (one study only).  ``group="all"`` routes
    every label through a group pipeline, singletons included; a study
    axis folds into the group axis there, so a cohort's Parzen tables are
    ``[S·G, m]``.  ``group=False`` runs every label on its own.  Same math
    and same per-label keys in every layout.  ``qparams`` decodes int8/fp8
    history at the read boundary; ``fused`` draws and scores un-quantized
    numeric groups in ``megakernel.fused_sample_ei``.

    ``diagnostics=True`` builds the health-instrumented step (an armed
    obs run): ``propose(history, keys) -> (out, diag)`` where ``diag`` is
    ``{"stats": {label: [*S, B, 9]}, "n_below": [*S], "n_above": [*S]}``
    (:func:`_diag_stats`).  Its proposals are bit for bit the plain
    step's: the stats only read what the proposal computed.

    ``propose.ei_shapes(B, cap)`` lists the ``(P, n, m)`` of every
    ``ei_diff`` launch one unfused step makes for ``B`` keys over a
    history of capacity ``cap`` (one study): what ``obs/health.py``
    counts the tick's kernel cost from."""
    by_gkey = {}
    if group:
        for l in cs.labels:
            dist = cs.params[l].dist
            if dist.family in ("categorical", "randint"):
                gkey = ("disc", len(_prior_probs(dist)))
            else:
                _, _, low, high, q, _ = _parzen_from(dist)
                gkey = ("num", q is not None,
                        math.isfinite(low) and math.isfinite(high))
            by_gkey.setdefault(gkey, []).append(l)
        if group != "all":
            by_gkey = {k: ls for k, ls in by_gkey.items() if len(ls) >= 2}
    grouped = {l for ls in by_gkey.values() for l in ls}

    numeric_groups = []  # (labels, quantized, bounded, has_log, statics)
    disc_groups = []     # (labels, prior_ps[G, K], offsets[G])
    for gkey, ls in by_gkey.items():
        if gkey[0] == "disc":
            prior_ps = np.stack([_prior_probs(cs.params[l].dist) for l in ls])
            offsets = np.asarray(
                [int(cs.params[l].dist.params[0])
                 if cs.params[l].dist.family == "randint" else 0 for l in ls],
                np.int64)
            disc_groups.append((ls, prior_ps, offsets))
        else:
            parz = [_parzen_from(cs.params[l].dist) for l in ls]
            numeric_groups.append((ls, gkey[1], gkey[2], any(p[5] for p in parz),
                                   _stack_parzen_statics(parz)))
    hashes = {l: label_hash(l) for l in cs.labels}
    on_device = {}  # (device, S) -> group constants as tensors there

    def constants(dev, S):
        c = on_device.get((dev, S))
        if c is None:
            t = lambda a: _tile(torch.as_tensor(a, device=dev), S)  # noqa: E731
            c = on_device[(dev, S)] = {
                "num": [{k: t(v) for k, v in g[4].items()} for g in numeric_groups],
                "disc": [(t(g[1]), t(g[2])) for g in disc_groups],
                "hash": {ls[0]: torch.as_tensor([hashes[l] for l in ls], device=dev)
                         for ls in [g[0] for g in numeric_groups + disc_groups]},
            }
        return c

    def propose(history, keys):
        lead = tuple(keys.shape[:-2])
        B = keys.shape[-2]
        c = constants(keys.device, math.prod(lead))
        below, above = split_below_above(
            history["losses"].to(torch.float32), history["has_loss"],
            cfg["gamma"], cfg["LF"])
        out = {}

        def stacked(ls):
            gkeys = prng.fold_in(keys[..., None, :, :], c["hash"][ls[0]][:, None])
            obs = torch.stack([_read_vals(history, l, qparams) for l in ls], dim=-2)
            act = torch.stack([history["active"][l] for l in ls], dim=-2)
            cap = obs.shape[-1]
            return (gkeys.reshape(-1, B, 2), obs.reshape(-1, cap),
                    (below[..., None, :] & act).reshape(-1, cap),
                    (above[..., None, :] & act).reshape(-1, cap))

        stats = {}

        def unstack(ls, res):
            val = res[0].reshape(lead + (len(ls), B))
            ei = res[1].reshape(lead + (len(ls), B))
            for i, l in enumerate(ls):
                out[l] = (val[..., i, :], ei[..., i, :])
            if diagnostics:
                st = res[2].reshape(lead + (len(ls), B, res[2].shape[-1]))
                for i, l in enumerate(ls):
                    stats[l] = st[..., i, :, :]

        for (ls, quantized, bounded, has_log, _), statics in zip(numeric_groups, c["num"]):
            unstack(ls, _propose_numeric_group(
                *stacked(ls), statics, cfg, quantized, bounded, has_log,
                fused=fused and not quantized, diag=diagnostics))
        for (ls, _, _), (prior_ps, offsets) in zip(disc_groups, c["disc"]):
            unstack(ls, _propose_discrete_group(*stacked(ls), prior_ps, offsets, cfg,
                                                diag=diagnostics))
        for label in cs.labels:
            if label in grouped:
                continue
            if lead:
                raise ValueError("a study axis needs the group='all' layout")
            dist = cs.params[label].dist
            active = history["active"][label]
            k = prng.fold_in(keys, hashes[label])
            fn = (_propose_discrete if dist.family in ("categorical", "randint")
                  else _propose_numeric)
            res = fn(k, dist, _read_vals(history, label, qparams),
                     below & active, above & active, cfg, diag=diagnostics)
            out[label] = res[:2]
            if diagnostics:
                stats[label] = res[2]
        if diagnostics:
            return out, {"stats": stats, "n_below": below.sum(-1), "n_above": above.sum(-1)}
        return out

    eps = float(cfg.get("prior_eps", 0.0)) > 0.0
    numeric_ei = ([len(ls) for ls, quantized, *_ in numeric_groups if not quantized]
                  + [1 for l in cs.labels if l not in grouped
                     and cs.params[l].dist.family not in ("categorical", "randint")
                     and _parzen_from(cs.params[l].dist)[4] is None])

    def ei_shapes(B, cap):
        n = B * int(cfg["n_EI_candidates"])
        shapes = [(G, n, cap + 1) for G in numeric_ei]
        if eps:
            shapes += [(G, B, cap + 1) for G in numeric_ei]
        return shapes

    propose.ei_shapes = ei_shapes
    return propose


def build_propose(cs, cfg, group=True, qparams=None, fused=False):
    """``propose(history, keys) -> {label: value}``; see
    :func:`build_propose_with_scores`."""
    scored = build_propose_with_scores(cs, cfg, group=group, qparams=qparams, fused=fused)

    def propose(history, keys):
        return {l: v for l, (v, _) in scored(history, keys).items()}

    propose.ei_shapes = scored.ei_shapes
    return propose


def build_propose_candidates(cs, cfg, qparams=None):
    """The raw candidate pool ``propose(history, keys[B, 2]) -> {label:
    (samples[B, n], ei[B, n])}`` with ``n = n_EI_candidates``: the
    selection-free step the sharded candidate axis pools across mesh
    entries before its own top-k select.  Labels run one by one (the
    per-label pipelines, each key folded with ``label_hash(label)``); an
    un-quantized numeric label scores through ``megakernel.ei_diff``, one
    launch per label for all keys."""

    def propose(history, keys):
        below, above = split_below_above(history["losses"].to(torch.float32),
                                         history["has_loss"], cfg["gamma"], cfg["LF"])
        out = {}
        for label in cs.labels:
            dist = cs.params[label].dist
            active = history["active"][label]
            fn = (_propose_discrete if dist.family in ("categorical", "randint")
                  else _propose_numeric)
            out[label] = fn(prng.fold_in(keys, label_hash(label)), dist,
                            _read_vals(history, label, qparams), below & active,
                            above & active, cfg, raw=True)
        return out

    return propose


def _apply_rows(labels, history, rows, qparams=None, study=None):
    """Fold packed trial rows (``PaddedHistory._pack_row`` layout) into the
    device history in place, one ``index_put_`` per array; every row
    targets its own slot.  ``study[K]`` indexes the leading study axis of
    a cohort's stacked history.  A code leaf (int8/fp8) takes the affine
    encode of the row's snapped value (``quant.quantize``), a bf16 leaf a
    cast."""
    L = len(labels)
    at = (rows[:, 2 * L + 2].to(torch.int64),)
    if study is not None:
        at = (study,) + at
    for j, l in enumerate(labels):
        leaf = history["vals"][l]
        name = quant.quant_dtype_name(leaf.dtype)
        if name is not None:
            leaf.index_put_(at, quant.quantize(rows[:, j], qparams[l], name))
        else:
            leaf.index_put_(at, rows[:, j].to(leaf.dtype))
        history["active"][l].index_put_(at, rows[:, L + j] > 0.5)
    history["losses"].index_put_(at, rows[:, 2 * L].to(history["losses"].dtype))
    history["has_loss"].index_put_(at, rows[:, 2 * L + 1] > 0.5)
    return history


def _tick(cs, propose, history, rows, seed, ids, qparams=None, diag=False):
    """One ask→tell tick on the history's device: fold ``rows`` in place,
    derive ``fold_in(fold_in(PRNGKey(lo), hi), id)`` per id, propose, and
    pack ``[B, L]``; with ``diag`` (the health-instrumented step) the
    ``[B, 10L+2]`` buffer of :func:`_pack_health`."""
    _apply_rows(cs.labels, history, rows, qparams)
    keys = prng.fold_in(rand.seed_to_key(seed, ids.device), ids)
    if diag:
        return _pack_health(cs, *propose(history, keys))
    return rand.pack_labels(cs, propose(history, keys))


def _pack_health(cs, out, diag):
    """One ``[B, L + 9L + 2]`` float32 buffer of an armed step: the
    proposals in ``rand.pack_labels`` order, the per-label health stats
    ``[B, L, 9]`` flattened, and the below/above split sizes; read back
    in one transfer (:func:`_unpack_health`)."""
    mat = rand.pack_labels(cs, {l: v for l, (v, _) in out.items()})
    B = mat.shape[0]
    stats = torch.stack([diag["stats"][l] for l in cs.labels], dim=-2)
    split = torch.stack([diag["n_below"], diag["n_above"]]).to(torch.float32)
    return torch.cat([mat, stats.reshape(B, -1), split.expand(B, 2)], dim=-1)


def _unpack_health(cs, host, n):
    """Host ``[B, 10L+2]`` → ``(proposals [n, L], stats [n, L, 9],
    splits [n, 2])``."""
    L = len(cs.labels)
    return (host[:n, :L], host[:n, L:L + 9 * L].reshape(n, L, 9),
            host[:n, L + 9 * L:])


# (space signature, cfg, storage) -> proposal step; its host-side group
# tables and per-device constants are built once per space
_propose_cache = LRUCache(32)


def _get_propose(cs, cfg, qparams=None, hist_dtype=None, diag=False):
    key = (cs.signature(), tuple(sorted(cfg.items())))
    if qparams is not None:
        # qparams are a pure function of (space, name): the name keys them
        key = key + ("quant", str(hist_dtype))
    if diag:
        key = key + ("health",)
    fn = _propose_cache.get(key)
    if fn is None:
        fn = (build_propose_with_scores(cs, cfg, qparams=qparams, diagnostics=True)
              if diag else build_propose(cs, cfg, qparams=qparams))
        _propose_cache.put(key, fn)
    return fn


def suggest_async(
    new_ids,
    domain,
    trials,
    seed,
    prior_weight=_default_prior_weight,
    n_startup_jobs=_default_n_startup_jobs,
    n_EI_candidates=_default_n_EI_candidates,
    gamma=_default_gamma,
    linear_forgetting=_default_linear_forgetting,
    ei_select="argmax",
    ei_tau=1.0,
    prior_eps=0.0,
    verbose=False,
):
    """Queue one tick on the trials' device and return an
    :class:`~hyperopt_tpu_torch.algos.rand.AskHandle` whose ``result()``
    reads the packed proposals back and builds the trial docs.  The first
    ``n_startup_jobs`` trials are prior draws (``rand.suggest_async``).

    ``HYPEROPT_TPU_SHARD`` splits the tick's proposals over
    ``sharding.suggest_mesh`` of the trials' local devices: the ids pad to
    a multiple of the mesh, the history is placed by the partition-rule
    table (split along its capacity axis past
    ``HYPEROPT_TPU_HIST_SHARD_MIN``), and every entry proposes its slice.
    Unset, the tick is the one-device tick.

    An armed obs run (``trials.obs_health``, set by ``fmin`` when its
    stream is live) runs the health-instrumented step instead: the same
    proposals, plus the per-label health stats packed into the same one
    readback, recorded by ``obs.health.record_tpe_health``; the tick's
    analytic ``ei_diff`` cost goes to the ``suggest.tpe`` gauges."""
    if not len(new_ids):
        return rand.AskHandle([], lambda: [])
    if len(trials.trials) < n_startup_jobs:
        return rand.suggest_async(new_ids, domain, trials, seed)

    cfg = {
        "prior_weight": float(prior_weight),
        "n_EI_candidates": int(n_EI_candidates),
        "gamma": float(gamma),
        "LF": int(linear_forgetting),
        "ei_select": str(ei_select),
        "ei_tau": float(ei_tau),
        "prior_eps": float(prior_eps),
    }
    cs = domain.cs
    ph = trials.history_object(cs.labels)
    # arm (or degrade) the int8/fp8 code before the mirror is built; a
    # no-op unless HYPEROPT_TPU_HIST_DTYPE names a code
    ph.ensure_qparams(cs)
    n_shard = parse_shard()
    health = getattr(trials, "obs_health", None)
    diag = health is not None
    ids = rand.pad_ids_sticky(domain, new_ids)
    dev, rows = ph.device_state()
    propose = _get_propose(cs, cfg, ph.qparams, ph.hist_dtype, diag=diag)
    try:
        if n_shard is None:
            mat = _tick(cs, propose, dev, rows, seed, torch.from_numpy(ids).to(ph.device),
                        ph.qparams, diag=diag)
        else:
            mat = _sharded_tick(cs, cfg, ph, dev, rows, seed, ids, n_shard, diag=diag)
    except BaseException:
        # a half-applied in-place fold: rebuild the mirror from host next time
        ph.abandon_device()
        raise
    ph.commit_device()

    if not diag:
        def finish():
            flats = rand.unpack_flats(cs, mat, len(new_ids))
            return rand.flat_to_new_trial_docs(domain, trials, new_ids, flats)

        return rand.AskHandle(new_ids, finish)

    from ..obs import health as _health
    from ..obs.devmem import register_owner

    # the packed proposals + stats readback buffer, for the devmem census
    register_owner("candidates", mat)
    _health.record_program_cost(
        "suggest.tpe", *_health.ei_launch_cost(propose.ei_shapes(len(ids), ph.cap)))

    def finish():
        host = mat.cpu().numpy()  # the one readback: proposals and stats
        vals, stats, splits = _unpack_health(cs, host, len(new_ids))
        _health.record_tpe_health(health, cs.labels, stats, splits)
        flats = rand.unpack_flats(cs, vals, len(new_ids))
        return rand.flat_to_new_trial_docs(domain, trials, new_ids, flats)

    return rand.AskHandle(new_ids, finish)


# (space signature, cfg, mesh geometry, history split, storage) ->
# sharded proposal step
_sharded_cache = LRUCache(32)


def _sharded_step(kind, cs, cfg, mesh, qparams, hist_dtype, **kw):
    key = (kind, cs.signature(), tuple(sorted(cfg.items())), mesh.geometry(),
           tuple(sorted(kw.items())), str(hist_dtype) if qparams is not None else None)
    fn = _sharded_cache.get(key)
    if fn is None:
        from ..parallel import sharding as _sh

        build = (_sh.suggest_batch_sharded if kind == "batch"
                 else _sh.propose_sharded_candidates)
        fn = build(cs, cfg, mesh, packed=True, qparams=qparams, **kw)
        _sharded_cache.put(key, fn)
    return fn


def _sharded_tick(cs, cfg, ph, dev, rows, seed, ids, n_shard, diag=False):
    """The tick under ``HYPEROPT_TPU_SHARD``: fold the rows into the
    mirror, place it on the suggest mesh by the rule table and propose
    every entry's slice of the ids (padded to a multiple of the mesh);
    ``diag`` packs the health stats as :func:`_tick` does."""
    from ..parallel import sharding as _sh

    mesh = _sh.suggest_mesh(n_shard, device=ph.device)
    shard_hist = _sh.should_shard_history(ph.cap, mesh)
    _apply_rows(cs.labels, dev, rows, ph.qparams)
    ids = rand.pad_ids_to_multiple(ids, mesh.size)
    keys = prng.fold_in(rand.seed_to_key(seed, ph.device), torch.from_numpy(ids).to(ph.device))
    step = _sharded_step("batch", cs, cfg, mesh, ph.qparams, ph.hist_dtype,
                         shard_history=shard_hist, diag=bool(diag))
    return step(_sh.place_history(dev, mesh, shard_history=shard_hist), keys)


def suggest(new_ids, domain, trials, seed, **kwargs):
    """Propose new trials by TPE (hyperopt/tpe.py sym: suggest):
    ``suggest_async`` plus an immediate ``result()``.  Tune with
    ``functools.partial(tpe.suggest, gamma=..., n_EI_candidates=...)``."""
    return suggest_async(new_ids, domain, trials, seed, **kwargs).result()


def suggest_sharded(mesh=None, n_cand_shards=1, n_startup_jobs=_default_n_startup_jobs,
                    ei_select=None, **tpe_kwargs):
    """An ``algo=`` callable whose TPE proposals run sharded over a mesh
    (``parallel/sharding.py``)::

        fmin(obj, space, algo=tpe.suggest_sharded(n_cand_shards=2),
             max_evals=100, max_queue_len=8)

    A queue batch (``len(new_ids) > 1``) splits its trial axis over the
    mesh (ids pad to a power of two, then to a multiple of the mesh's
    entries); with ``n_cand_shards > 1`` every proposal of the batch also
    scores over the distributed candidate pool
    (``propose_sharded_candidates(batch=B)``).  A single proposal with
    ``n_cand_shards > 1`` splits the candidate axis.  ``mesh=None`` builds
    ``sharding.make_mesh(n_cand_shards=...)`` over the trials' local
    devices at the first TPE ask.  ``ei_select`` defaults to ``"softmax"``
    for batches and ``"argmax"`` for single proposals.  The tuning
    arguments are ``tpe.suggest``'s; an unknown one raises here."""
    state = {"mesh": mesh}
    kw_map = {"prior_weight": "prior_weight", "n_EI_candidates": "n_EI_candidates",
              "gamma": "gamma", "linear_forgetting": "LF", "ei_tau": "ei_tau",
              "prior_eps": "prior_eps"}
    unknown = set(tpe_kwargs) - set(kw_map)
    if unknown:
        raise TypeError(f"suggest_sharded: unknown kwargs {sorted(unknown)} "
                        f"(accepts {sorted(kw_map)})")
    cfg_over = {kw_map[k]: v for k, v in tpe_kwargs.items()}

    def algo(new_ids, domain, trials, seed):
        from ..parallel import sharding as _sh

        if not len(new_ids):
            return []
        if len(trials.trials) < n_startup_jobs:
            return rand.suggest(new_ids, domain, trials, seed)
        if state["mesh"] is None:
            state["mesh"] = _sh.make_mesh(n_cand_shards=n_cand_shards, device=trials.device)
        m = state["mesh"]
        batched = len(new_ids) > 1
        select = ei_select if ei_select is not None else ("softmax" if batched else "argmax")
        cfg = {"prior_weight": _default_prior_weight, "n_EI_candidates": _default_n_EI_candidates,
               "gamma": _default_gamma, "LF": _default_linear_forgetting,
               "ei_select": select, **cfg_over}
        cs = domain.cs
        ph = trials.history_object(cs.labels)
        ph.ensure_qparams(cs)
        qparams = _quant_qparams(cs, ph.hist_dtype)
        base = rand.seed_to_key(seed, ph.device)
        hist = _sh.replicate_history(ph.device_view(), m)
        if batched:
            padded = rand.pad_ids_to_multiple(rand.pad_ids_sticky(domain, new_ids), m.size)
            if int(m.shape[_sh.CAND_AXIS]) > 1:
                fn = _sharded_step("cand", cs, cfg, m, qparams, ph.hist_dtype,
                                   batch=len(padded))
            else:
                fn = _sharded_step("batch", cs, cfg, m, qparams, ph.hist_dtype)
            mat = fn(hist, rand.fold_ids(base, padded))
            flats = rand.unpack_flats(cs, mat, len(new_ids))
        else:
            fn = _sharded_step("cand", cs, cfg, m, qparams, ph.hist_dtype)
            mat = fn(hist, rand.fold_ids(base, new_ids)[0])
            flats = rand.unpack_flats(cs, mat, 1)
        return rand.flat_to_new_trial_docs(domain, trials, new_ids, flats)

    return algo


# ---------------------------------------------------------------------------
# the study-batched cohort: one tick for many studies sharing a space, a
# TPE cfg and a capacity bucket (the scheduler's cohort contract)
# ---------------------------------------------------------------------------


def _seed_words(seed):
    """(low 32 bits, high 32 bits) of an integer seed as ``uint32[2]``: the
    tick's key is ``fold_in(PRNGKey(low), high)``."""
    return np.asarray(prng.seed_words(seed), np.uint32)


# (space signature, cfg, cohort shape, storage, route) -> cohort program
_cohort_cache = LRUCache(16)


def cohort_cache_stats():
    """Hit/miss/size counters of the cohort-program LRU."""
    return _cohort_cache.stats()


def cohort_cache_contains(key):
    """Whether the cohort LRU holds ``key``, counting no hit or miss."""
    return _cohort_cache.contains(key)


def cohort_key(cs, cfg, n_studies, cap, n_ids, donate=True, mesh=None,
               hist_dtype=None, fused=True):
    """The cohort-LRU key :func:`build_suggest_batched` uses: the space,
    cfg and slot shape, plus ``("quant", name)`` for a code storage name,
    ``("megakernel", mode)`` when the fused route is armed and
    ``("mesh", geometry)`` for a sharded cohort."""
    key = (cs.signature(), tuple(sorted(cfg.items())), "cohort",
           int(n_studies), int(cap), int(n_ids), bool(donate))
    if hist_dtype is not None and quant.is_quant_name(hist_dtype):
        key = key + ("quant", str(hist_dtype))
    if fused and megakernel.armed(cs):
        key = key + ("megakernel", megakernel.mode())
    if mesh is not None:
        key = key + ("mesh", mesh.geometry())
    return key


def build_suggest_batched(cs, cfg, n_studies, cap, n_ids, donate=True,
                          mesh=None, hist_dtype=None, fused=True):
    """The STUDY-BATCHED tell+ask program::

        run(hist_stack, rows_stack, seed_words[S, 2], ids[S, B])
            -> (hist_stack', packed[S, B, L])

    Every history leaf carries a leading study axis (``losses[S, cap]``,
    ``vals[l][S, cap]``, ...) on the cohort's device; ``rows_stack`` is a
    host ``[S, K, 2L+3]`` array of per-study tell rows in the
    ``PaddedHistory._pack_row`` layout, padding rows with index ``>= cap``
    (they are dropped on the host, as the reference's ``mode='drop'``
    drops them).  Per study it is the single-study tick: the same row
    fold, keys ``fold_in(fold_in(PRNGKey(seed_words[s, 0]),
    seed_words[s, 1]), id)``, the same group pipelines, with the study
    axis written out as a leading batch dimension.  ``donate=True`` folds
    the rows into ``hist_stack`` in place and returns it; ``donate=False``
    folds into a copy.  ``hist_dtype`` is the cohort's resolved storage
    name (int8/fp8 decode and encode codes).  With the fused route armed
    (``megakernel.armed(cs)``) the build is ``megakernel.build_cohort``;
    ``fused=False`` keeps the grouped ``ei_diff`` route, as a widened
    cohort does.

    ``mesh`` (a ``sharding`` mesh) splits the study axis by the
    partition-rule table (``suggest_batched_shardings``): each entry owns
    ``n_studies / n`` whole studies and runs the cohort program above on
    its slice, on its device, so the fused kernel launches once per shard.
    ``hist_stack`` is then placed by ``sharding.place_history`` on the
    study axis (a plain stack is placed on the first call) and the
    result's history is the placed tree; ``packed`` gathers on the first
    entry's device.  Per-study math is the same, so the proposals are the
    unsharded cohort's.  Programs are cached under :func:`cohort_key`."""
    key = cohort_key(cs, cfg, n_studies, cap, n_ids, donate=donate, mesh=mesh,
                     hist_dtype=hist_dtype, fused=fused)
    fn = _cohort_cache.get(key)
    if fn is None:
        qparams = _quant_qparams(cs, hist_dtype)
        if mesh is not None:
            fn = _build_sharded_cohort(cs, cfg, n_studies, cap, n_ids, donate, mesh,
                                       hist_dtype, fused)
        elif fused and megakernel.armed(cs):
            fn = megakernel.build_cohort(cs, cfg, n_studies, cap, n_ids,
                                         donate=donate, qparams=qparams)
        else:
            fn = _build_cohort(cs, cfg, n_studies, cap, n_ids, donate, qparams,
                               fused=False)
        _cohort_cache.put(key, fn)
    return fn


def _build_sharded_cohort(cs, cfg, n_studies, cap, n_ids, donate, mesh, hist_dtype, fused):
    """The cohort program with the study axis split over ``mesh``: one
    unsharded cohort program of ``n_studies / n`` studies per entry."""
    from ..parallel import sharding as _sh

    n = mesh.size
    S = int(n_studies)
    if S % n:
        raise ValueError(f"a cohort of {S} studies does not split over {n} mesh entries")
    per = S // n
    # the rule table says every cohort leaf splits its study axis
    in_sh, _ = _sh.suggest_batched_shardings(mesh, cs.labels)
    if not all(len(sh.spec) for sh in in_sh[1:]):
        raise ValueError("the cohort's rows, seed words and ids must split with the studies")
    local = build_suggest_batched(cs, cfg, per, cap, n_ids, donate=True,
                                  hist_dtype=hist_dtype, fused=fused)

    def run(hist_stack, rows_stack, seed_words, ids):
        if not isinstance(hist_stack["losses"], _sh.Placed):
            if not donate:
                hist_stack = _clone_tree(hist_stack)
            hist_stack = _sh.place_history(hist_stack, mesh, study_axis=True)
        elif not donate:
            hist_stack = _tree_map(lambda p: _sh.Placed(
                [None if t is None else t.clone() for t in p.parts], p.split, p.gather),
                hist_stack)
        rows, words, idv = (_host(rows_stack, np.float32), _host(seed_words, np.int64),
                            _host(ids, np.int64))
        packed = []
        for i in mesh.local():
            sl = slice(i * per, (i + 1) * per)
            part = _tree_map(lambda p: p.parts[i], hist_stack)
            packed.append(local(part, rows[sl], words[sl], idv[sl])[1])
        home = mesh.devices.flat[mesh.local()[0]]
        return hist_stack, torch.cat([m.to(home) for m in packed])

    return run


def _tree_map(fn, tree):
    """``fn`` of every leaf of a history tree (``vals``/``active`` per
    label, ``losses``, ``has_loss``)."""
    return {"vals": {l: fn(v) for l, v in tree["vals"].items()},
            "active": {l: fn(v) for l, v in tree["active"].items()},
            "losses": fn(tree["losses"]), "has_loss": fn(tree["has_loss"])}


def _clone_tree(tree):
    return _tree_map(lambda t: t.clone(), tree)


def _host(a, dtype):
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.asarray(a).astype(dtype)


def _build_cohort(cs, cfg, n_studies, cap, n_ids, donate, qparams, fused):
    """The cohort program of :func:`build_suggest_batched`, with the
    grouped ``ei_diff`` middle or (``fused``) the fused kernel's."""
    propose = build_propose(cs, cfg, group="all", qparams=qparams, fused=fused)
    labels = cs.labels
    S, cap, B = int(n_studies), int(cap), int(n_ids)

    def run(hist_stack, rows_stack, seed_words, ids):
        dev = hist_stack["losses"].device
        if tuple(hist_stack["losses"].shape) != (S, cap):
            raise ValueError(f"cohort history must be [S={S}, cap={cap}], got "
                             f"{tuple(hist_stack['losses'].shape)}")
        ids = _host(ids, np.int64)
        if ids.shape != (S, B):
            raise ValueError(f"cohort ids must be [S={S}, B={B}], got {ids.shape}")
        if not donate:
            hist_stack = _clone_tree(hist_stack)
        rows = _host(rows_stack, np.float32)
        study, k = np.nonzero(rows[:, :, -1] < cap)
        if study.size:
            _apply_rows(labels, hist_stack, torch.from_numpy(rows[study, k]).to(dev),
                        qparams, torch.from_numpy(study).to(dev))
        words = torch.from_numpy(_host(seed_words, np.int64)).to(dev)
        base = prng.fold_in(prng.PRNGKey(words[:, 0]), words[:, 1])
        keys = prng.fold_in(base[:, None, :], torch.from_numpy(ids).to(dev))
        return hist_stack, rand.pack_labels(cs, propose(hist_stack, keys))

    return run


# ---------------------------------------------------------------------------
# the widened profile.  The JAX package widens a cohort of an unconditional
# space into a positional slot layout so that every space of one PROFILE
# (its label groups, each padded to a power-of-two slot width) shares one
# compiled program.  Torch compiles nothing, and a widened slot proposes
# bit for bit as the grouped step (``group="all"``) does, so the port's
# widened cohort is the grouped cohort with the fused route off; the
# profile only decides which spaces widen.  Conditional spaces do not:
# their activation masks couple labels.
# ---------------------------------------------------------------------------


def _pow2_up(n):
    b = 1
    while b < n:
        b *= 2
    return b


def widened_profile(cs):
    """``(profile, slots)`` of a compiled space, or None when the space has
    conditional parameters.

    ``profile`` is a sorted tuple of group entries ``("num", quantized,
    bounded, W)`` / ``("disc", K, W)``, ``W`` the power-of-two slot width
    of the JAX package's positional layout; ``slots`` lists each group's
    labels in ``cs.labels`` order.  The groups are those of the grouped
    step (:func:`build_propose_with_scores`, ``group="all"``)."""
    if any(info.conditions for info in cs.params.values()):
        return None
    groups = {}
    for l in cs.labels:
        d = cs.params[l].dist
        if d.family in ("categorical", "randint"):
            gkey = ("disc", len(_prior_probs(d)))
        else:
            _, _, low, high, q, _ = _parzen_from(d)
            gkey = ("num", q is not None, math.isfinite(low) and math.isfinite(high))
        groups.setdefault(gkey, []).append(l)
    profile, slots = [], []
    for gkey in sorted(groups):
        ls = groups[gkey]
        profile.append(gkey + (_pow2_up(len(ls)),))
        slots.append(tuple(ls))
    return tuple(profile), tuple(slots)
