"""The TPE proposal in plain float64 torch, and the judge of a proposed
value against it.

One *case* is one label of one proposal: a key, the below/above fits it
reads, and the value the program proposed.  The reference redraws the
case's candidates from the key, scores them, and reports two gaps:

* ``draw``: how far the proposed value lies from the candidate it fits
  best, in the units of the draw's uniform: for a continuous label the
  least ``|Phi((t - mu) / sigma) - u|`` under a candidate's component, for
  a grid or discrete value its distance in grid steps over the prior's
  range (0 when it is a candidate).
* ``select``: by how much the matched candidate's selection score lies
  below the best candidate's (EI for argmax, EI / tau plus the Gumbel
  noise for softmax selection); 0 where the epsilon-prior draw was taken.
  A continuous value matches every candidate it fits within ``TOL`` (or
  the best fitting one), and the best scored of them is judged.

The program draws in float32: its component CDFs, ``0.5 (1 + erf)``, move
a draw's uniform by up to ~1.2e-7, which in a thin tail moves the value by
some 1e-5 in t-space, or hundredths of a grid step; ``U_TOL`` is ten times
that.  Its float32 values (t up to ~9, ulp 1e-6) read up to a few 1e-6 in
the uniform of a narrow component.  So a continuous value is matched in
the candidates' uniforms, within ``TOL``, not by its nearest candidate in
t-space (two candidates can lie closer than the rounding moves one of
them).  Rounding can also move a uniform across
a boundary of the component CDF, or a value across a half step of its
grid; each such candidate also counts in its other reading, and the judge
takes the reading that fits the program.  A candidate is that close where
its uniform lies within ``TOL`` of a boundary of the CDF, or within
``U_TOL`` of the grid's half step mapped into the draw's uniform; or where
its value lies within ``TOL`` grid steps of the half step, on a log grid
within ``LOG_TOL`` of it relative to the value (the float32 ``exp``
rounding).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import prng

EPS = 1e-12
U_TINY = 1e-7
TOL = 1e-5  # a uniform or grid position this close to a boundary reads both ways
LOG_TOL = 2e-6  # and on a log grid, this close relative to the value
U_TOL = 1e-6  # a draw's uniform this close reads as the program's float32 rounding of it
_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


class Label:
    """One label of a configuration's space (``["uniform", lo, hi]``,
    ``["loguniform", lo, hi]`` and ``["qloguniform", lo, hi, q]`` with
    bounds in log space, ``["quniform", lo, hi, q]``, ``["uniformint", lo,
    hi]``, ``["choice", [options]]``), in the search's t-space: log space
    for log labels, value space for the rest.  A quantized label's grid
    lies in value space, between ``vlo`` and ``vhi``."""

    def __init__(self, name, spec):
        self.name = name
        self.hash = prng.label_hash(name)
        fam, *p = spec
        self.family = fam
        self.q = None
        self.log = False
        self.K = None
        if fam == "choice":
            self.K = len(p[0])
            self.lo, self.hi = 0.0, float(self.K)
        elif fam == "uniform":
            self.lo, self.hi = float(p[0]), float(p[1])
        elif fam == "loguniform":
            self.lo, self.hi = float(p[0]), float(p[1])
            self.log = True
        elif fam == "quniform":
            self.lo, self.hi, self.q = float(p[0]), float(p[1]), float(p[2])
        elif fam == "qloguniform":
            self.lo, self.hi, self.q = float(p[0]), float(p[1]), float(p[2])
            self.log = True
        elif fam == "uniformint":
            self.ilo, self.ihi = int(p[0]), int(p[1])
            self.lo, self.hi, self.q = p[0] - 0.5, p[1] + 0.5, 1.0
        else:
            raise ValueError(f"no reference for family {fam!r}")
        self.prior_mu = 0.5 * (self.lo + self.hi)
        self.prior_sigma = self.hi - self.lo
        self.vlo, self.vhi = ((math.exp(self.lo), math.exp(self.hi)) if self.log
                              else (self.lo, self.hi))

    def to_grid(self, v, near=None):
        """Value-space points ``v`` rounded to the grid: ``[..., 2]`` (the
        second reading where the rounding is within tolerance of a half,
        or where ``near`` holds)."""
        tol = TOL + LOG_TOL * (v / self.q).abs() if self.log else TOL
        return _round_pair(v / self.q, tol, near) * self.q

    def half_step(self, v):
        """The grid's half step between the two grid points around ``v``
        (value space)."""
        return (torch.floor(v / self.q) + 0.5) * self.q

    @property
    def discrete(self):
        return self.K is not None

    def to_t(self, v):
        return torch.log(torch.clamp(v, min=EPS)) if self.log else v

    def as_int(self):
        return self.family in ("uniformint", "choice")


def labels_of(space):
    return [Label(n, s) for n, s in space.items()]


# -- the prior ---------------------------------------------------------------


def prior_draw(label, k):
    """The startup draw of ``label`` for label keys ``k[..., 2]``: its
    value(s) as float64, with a second reading where the grid rounding is
    within ``TOL`` of a half step (``[..., 2]``)."""
    if label.family in ("uniform", "loguniform"):
        t = prng.uniform(k, label.lo, label.hi)
        v = torch.exp(t) if label.log else t
        return torch.stack([v, v], -1)
    if label.family in ("quniform", "qloguniform"):
        t = prng.uniform(k, label.lo, label.hi)
        return label.to_grid(torch.exp(t) if label.log else t)
    if label.family == "uniformint":
        v = prng.randint(k, label.ilo, label.ihi + 1).to(torch.float64)
        return torch.stack([v, v], -1)
    v = prng.randint(k, 0, label.K).to(torch.float64)
    return torch.stack([v, v], -1)


def _round_pair(x, tol=TOL, near=None):
    """``round(x)`` (half to even) and, within ``tol`` of a half or where
    ``near`` holds, the other neighbour: ``[..., 2]``."""
    r = torch.round(x)
    frac = x - torch.floor(x)
    near = (frac - 0.5).abs() < tol if near is None else near | ((frac - 0.5).abs() < tol)
    other = torch.where(r == torch.floor(x), torch.floor(x) + 1.0, torch.floor(x))
    return torch.stack([r, torch.where(near, other, r)], -1)


# -- the posterior -----------------------------------------------------------


def split_below(losses, has, gamma, LF):
    """Masks ``[S, cap]`` of the best ``min(ceil(gamma sqrt N), LF)`` trials
    with a loss (ties in slot order) and of the other trials with a loss."""
    cap = losses.shape[-1]
    N = has.sum(-1, keepdim=True).to(torch.float64)
    n_below = torch.clamp(torch.ceil(gamma * torch.sqrt(N)), max=float(LF))
    keyed = torch.where(has, losses, torch.full_like(losses, math.inf))
    order = torch.argsort(keyed, dim=-1, stable=True)
    rank = torch.empty_like(order)
    rank.scatter_(-1, order, torch.arange(cap, device=losses.device).expand_as(order))
    below = (rank < n_below) & has
    return below, has & ~below


def forgetting(mask, LF):
    """Linear-forgetting weights over slots in insertion order: with ``N``
    live slots past ``LF``, the oldest ``N - LF`` ramp from ``1/N`` up,
    the newest ``LF`` weigh 1; dead slots 0."""
    m = mask.to(torch.float64)
    n = m.sum(-1, keepdim=True)
    pos = torch.cumsum(m, -1) - 1.0
    n_ramp = n - LF
    inv_n = 1.0 / torch.clamp(n, min=1.0)
    ramp = inv_n + pos * (1.0 - inv_n) / torch.clamp(n_ramp - 1.0, min=1.0)
    w = torch.where(pos >= n_ramp, torch.ones_like(ramp), ramp)
    w = torch.where(n <= LF, torch.ones_like(ramp), w)
    return w * m


def parzen(obs, mask, prior_mu, prior_sigma, prior_weight, LF):
    """Adaptive Parzen mixture ``(w, mu, sigma)`` ``[S, cap+1]`` of the
    masked observations ``obs[S, cap]`` (t-space) with the prior inserted
    at its place: each observation's sigma is the larger gap to its
    sorted neighbours, clipped to ``[prior_sigma / min(100, m + 1),
    prior_sigma]`` (``m`` components counting the prior); weights by
    linear forgetting, the prior's ``prior_weight``, normalized.  Ties
    sort in slot order, the prior after equal observations."""
    S, cap = obs.shape
    dev = obs.device
    big = torch.full_like(obs, math.inf)
    vals = torch.cat([torch.where(mask, obs, big),
                      torch.full((S, 1), prior_mu, dtype=obs.dtype, device=dev)], -1)
    wts = torch.cat([forgetting(mask, LF),
                     torch.full((S, 1), float(prior_weight), dtype=obs.dtype, device=dev)], -1)
    is_prior = torch.zeros_like(vals, dtype=torch.bool)
    is_prior[:, -1] = True
    order = torch.argsort(vals, dim=-1, stable=True)
    sv = torch.gather(vals, -1, order)
    sw = torch.gather(wts, -1, order)
    sp = torch.gather(is_prior, -1, order)
    m = mask.sum(-1, keepdim=True) + 1
    idx = torch.arange(cap + 1, device=dev)
    live = idx < m
    sv = torch.where(live, sv, torch.full_like(sv, prior_mu))
    prev = sv - torch.cat([sv[:, :1], sv[:, :-1]], -1)
    nxt = torch.cat([sv[:, 1:], sv[:, -1:]], -1) - sv
    neg = torch.full_like(sv, -1.0)
    sig = torch.maximum(torch.where((idx >= 1) & live, prev, neg),
                        torch.where(idx < m - 1, nxt, neg))
    sig = torch.clamp(sig, min=0.0)
    lo = prior_sigma / torch.clamp(1.0 + m.to(torch.float64), max=100.0)
    sig = torch.minimum(torch.maximum(sig, lo), torch.full_like(sig, prior_sigma))
    sig = torch.where(sp | (m == 1) | ~live, torch.full_like(sig, prior_sigma), sig)
    sw = torch.where(live, sw, torch.zeros_like(sw))
    return sw / sw.sum(-1, keepdim=True), sv, sig


def ndtr(z):
    return torch.special.ndtr(z)


def masses(fit, lo, hi):
    """Each component's CDF at the bounds and the mixture's in-bounds mass."""
    w, mu, s = fit
    a = ndtr((lo - mu) / s)
    b = ndtr((hi - mu) / s)
    return a, b, (w * torch.clamp(b - a, 0.0, 1.0)).sum(-1)


def _cdf(weights):
    c = torch.cumsum(weights, -1)
    c = c / torch.clamp(c[..., -1:], min=EPS)
    return torch.cummax(c, -1).values


def _pick(cdf, u):
    """Component indices ``[..., n, 3]``: the first with ``cdf >= u``, and
    those for ``u -+ TOL`` (the readings a rounded CDF could give)."""
    M = cdf.shape[-1]
    cdf = cdf.contiguous()
    out = [torch.searchsorted(cdf, (u + d).contiguous()) for d in (0.0, -TOL, TOL)]
    return torch.clamp(torch.stack(out, -1), max=M - 1)


def _lse(x, w, mu, s):
    """``log sum_i w_i N(x; mu_i, s_i)`` of points ``x[Q]`` under per-point
    tables ``[Q, M]``; dead (w = 0) components left out."""
    comp = (torch.log(torch.clamp(w, min=EPS)) - 0.5 * ((x[:, None] - mu) / s) ** 2
            - torch.log(s) - _LOG_SQRT_2PI)
    comp = torch.where(w > 0, comp, torch.full_like(comp, -math.inf))
    return torch.logsumexp(comp, -1)


def _bin_mass(label, v, w, mu, s):
    """Mass of the mixture ``(w, mu, s)`` (t-space) in the grid bins of the
    value-space points ``v``, each bin cut to the label's bounds."""
    ub = torch.clamp(v + label.q / 2, max=label.vhi)
    lb = torch.clamp(v - label.q / 2, min=label.vlo)
    if label.log:
        ub, lb = torch.log(ub), torch.log(lb)
    return (w * (ndtr((ub[:, None] - mu) / s) - ndtr((lb[:, None] - mu) / s))).sum(-1)


def _score(label, t, fi, below, above, p_b, p_a, block):
    """EI of points ``t[Q]`` (t-space; value-space grid points for quantized labels)
    under the fits ``fi[Q]`` indexes, in blocks of ``block`` points."""
    out = torch.empty_like(t)
    for i in range(0, t.numel(), block):
        x, f = t[i:i + block], fi[i:i + block]
        wb, mb, sb = (a[f] for a in below)
        wa, ma, sa = (a[f] for a in above)
        if label.q is None:
            ei = (_lse(x, wb, mb, sb) - _lse(x, wa, ma, sa)
                  - torch.log(torch.clamp(p_b[f], min=EPS))
                  + torch.log(torch.clamp(p_a[f], min=EPS)))
            ei = torch.where((x >= label.lo) & (x < label.hi), ei,
                             torch.full_like(ei, -math.inf))
        else:
            ei = (torch.log(torch.clamp(_bin_mass(label, x, wb, mb, sb), min=EPS))
                  - torch.log(torch.clamp(_bin_mass(label, x, wa, ma, sa), min=EPS))
                  - torch.log(torch.clamp(p_b[f], min=EPS))
                  + torch.log(torch.clamp(p_a[f], min=EPS)))
        out[i:i + block] = torch.nan_to_num(ei, nan=-math.inf)
    return out


def posterior(label, obs, below, above, cfg):
    """The below/above fits of ``label`` for ``S`` histories: Parzen
    tables ``[S, cap+1]`` for a numeric label, bucket probabilities
    ``[S, K]`` for a discrete one."""
    if label.discrete:
        K = label.K
        onehot = (obs.to(torch.int64)[..., None]
                  == torch.arange(K, device=obs.device)).to(torch.float64)

        def post(mask):
            c = (onehot * forgetting(mask, cfg["LF"])[..., None]).sum(-2)
            c = c + K * cfg["prior_weight"] * (1.0 / K)
            return c / c.sum(-1, keepdim=True)

        return post(below), post(above)
    t = label.to_t(obs)
    args = (label.prior_mu, label.prior_sigma, cfg["prior_weight"], cfg["LF"])
    return parzen(t, below, *args), parzen(t, above, *args)


def candidates(label, below, fi, keys, n):
    """The ``n`` candidates of each case of a numeric label, each in its
    readings: their component's ``mu`` and ``s``, their uniform ``u`` and
    their value ``x`` (t-space; a quantized label's on its value-space
    grid), each ``[C, n, V]``."""
    C = keys.shape[0]
    k0, k1 = prng.split(keys, 0), prng.split(keys, 1)
    lo, hi = prng.f32(label.lo), prng.f32(label.hi)
    a_b, b_b, _ = masses(below, lo, hi)
    cdf = _cdf(below[0] * torch.clamp(b_b - a_b, 0.0, 1.0))[fi]
    uc = prng.unit(k0, n)
    u0 = prng.unit(k1, n)
    comp = _pick(cdf, uc)                                      # [C, n, 3]
    g = lambda tab: torch.gather(tab[fi][:, None, :].expand(C, n, tab.shape[-1]), 2, comp)  # noqa: E731
    mu, s, a, b = g(below[1]), g(below[2]), g(a_b), g(b_b)
    u = torch.clamp(a + u0[..., None] * (b - a), U_TINY, 1.0 - U_TINY)
    top = float(np.nextafter(np.float32(label.hi), np.float32(label.lo)))
    x = torch.clamp(mu + s * torch.special.ndtri(u), min=lo, max=top)
    if label.q is not None:
        v = torch.exp(x) if label.log else x
        u_half = ndtr((label.to_t(label.half_step(v)) - mu) / s)
        x = label.to_grid(v, (u_half - u).abs() < U_TOL).flatten(2)   # [C, n, 6]
        mu, s, u = (t.repeat_interleave(2, -1) for t in (mu, s, u))
    return mu, s, u, x


def judge(label, fits, fi, keys, proposed, cfg, block=1 << 22):
    """Draw gaps and selection gaps ``[C]`` of ``proposed[C]`` (the program's
    values) for cases with label keys ``keys[C, 2]`` reading the fits
    ``fi[C]`` indexes (``posterior`` over the histories)."""
    below, above = fits
    n = int(cfg["n_EI_candidates"])
    C = keys.shape[0]
    if label.discrete:
        return _judge_discrete(label, below, above, fi, keys, proposed, cfg, n)
    lo, hi = prng.f32(label.lo), prng.f32(label.hi)
    p_b = masses(below, lo, hi)[2]
    p_a = masses(above, lo, hi)[2]
    mu, s, u, x = candidates(label, below, fi, keys, n)
    V = x.shape[-1]
    ei = _score(label, x.reshape(-1), fi.repeat_interleave(n * V), below, above,
                p_b, p_a, max(1, block // below[0].shape[-1])).reshape(C, n, V)
    score = ei
    if cfg.get("ei_select", "argmax") == "softmax":
        us = prng.uniform(prng.fold_in(keys, 0x5E1EC7), U_TINY, 1.0 - U_TINY, n)
        score = ei / float(cfg.get("ei_tau", 1.0)) - torch.log(-torch.log(us))[..., None]
    # a quantized label is compared on its value-space grid, the rest in t-space
    t_prog = proposed.to(torch.float64)
    if label.q is None:
        t_prog = label.to_t(t_prog)
    if label.q is None:
        gap = (ndtr((t_prog[:, None, None] - mu) / s) - u).abs().reshape(C, -1)
        tol = TOL
    else:
        gap = (t_prog[:, None, None] - x).abs().reshape(C, -1) / (label.vhi - label.vlo)
        tol = 0.0
    draw = gap.min(-1).values
    matched = gap <= torch.clamp(draw, min=tol)[:, None] + 1e-12
    sc = score.reshape(C, -1)
    chosen = torch.where(matched, sc, torch.full_like(sc, -math.inf)).max(-1).values
    best = score.min(-1).values.max(-1).values
    select = _gap(best, chosen)
    return _mix_prior(label, keys, t_prog, draw, select, cfg)


def _gap(best, chosen):
    gap = best - chosen
    gap = torch.where(torch.isneginf(best) & torch.isneginf(chosen), torch.zeros_like(gap), gap)
    return torch.clamp(torch.nan_to_num(gap, nan=math.inf), min=0.0)


def _mix_prior(label, keys, t_prog, draw, select, cfg):
    """Where the epsilon-prior draw replaced the selection, judge the
    value against that draw instead (either reading within ``TOL`` of the
    take threshold)."""
    eps = float(cfg.get("prior_eps", 0.0))
    if eps <= 0.0:
        return draw, select
    take_u = prng.unit(prng.fold_in(keys, 0xE9510))
    kp = prng.fold_in(keys, 0x9B10B)
    if label.discrete:
        u = prng.unit(kp)
        xp = _pick(_cdf(torch.full((1, label.K), 1.0 / label.K, dtype=torch.float64,
                                   device=keys.device)).expand(u.shape[0], -1),
                   u[:, None])[:, 0, :].to(torch.float64)
        dp = (t_prog[:, None] - xp).abs().min(-1).values.clamp(max=1.0)
    else:
        lo, hi = prng.f32(label.lo), prng.f32(label.hi)
        zp = prng.uniform(kp, 0.0, 1.0 - U_TINY) * (hi - lo) + lo
        if label.q is not None:
            zp = label.to_grid(torch.exp(zp) if label.log else zp)
            dp = (t_prog[:, None] - zp).abs().min(-1).values / (label.vhi - label.vlo)
        else:
            dp = (t_prog - zp).abs() / (hi - lo)
    take = take_u < eps
    near = (take_u - eps).abs() < TOL
    d_take = torch.where(near, torch.minimum(dp, draw), dp)
    s_take = torch.where(near & (draw < dp), select, torch.zeros_like(select))
    return torch.where(take, d_take, draw), torch.where(take, s_take, select)


def _judge_discrete(label, pb, pa, fi, keys, proposed, cfg, n):
    C = keys.shape[0]
    samples = _pick(_cdf(pb)[fi], prng.unit(keys, n))        # [C, n, 3]
    ei = (torch.log(torch.clamp(pb[fi], min=EPS)).gather(1, samples.flatten(1))
          - torch.log(torch.clamp(pa[fi], min=EPS)).gather(1, samples.flatten(1)))
    ei = ei.reshape(C, n, 3)
    score = ei
    if cfg.get("ei_select", "argmax") == "softmax":
        us = prng.uniform(prng.fold_in(keys, 0x5E1EC7), U_TINY, 1.0 - U_TINY, n)
        score = ei / float(cfg.get("ei_tau", 1.0)) - torch.log(-torch.log(us))[..., None]
    v = proposed.to(torch.float64)
    dist = (v[:, None, None] - samples.to(torch.float64)).abs().reshape(C, -1)
    j = dist.argmin(-1)
    draw = dist.gather(1, j[:, None])[:, 0].clamp(max=1.0)
    matched = dist <= dist.gather(1, j[:, None]) + 1e-12
    sc = score.reshape(C, -1)
    chosen = torch.where(matched, sc, torch.full_like(sc, -math.inf)).max(-1).values
    select = _gap(score.min(-1).values.max(-1).values, chosen)
    return _mix_prior(label, keys, v, draw, select, cfg)
