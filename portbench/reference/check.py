"""The comparison that decides ``correct``: the program's searches against
the plain reference, from the same seeds.  An entry's judge
(``entries/<entry>.py``) derives each trial's key as the program's
documented key schedule for that entry gives it, and judges with the
pieces here.

A search is handed over as plain arrays (``Search``): its seed, each
label's proposed values and active flags, and each trial's loss, in
trial order.  The reference recomputes from the seed every key the
search used and judges, for every trial, the loss against the
configuration's objective and the fold (trial count, active flags);
for every startup trial, the prior draw; and for a sample of the TPE
proposals drawn from the run's seed (the last one of every search
among them), the proposal against the posterior of the search's own
earlier trials (``tpe.judge``).  It follows the program step by step:
each proposal is judged on the history the program returned, since one
rounding that flips a selection would send two independent chains
apart.

Numbers (each the largest over what was checked):

* ``loss_gap``: ``|loss - f(x)| / max(1, |f(x)|)``, ``f`` in float64;
* ``draw_gap``: ``tpe.judge``'s draw gap, startup draws included;
* ``select_gap``: ``tpe.judge``'s selection gap;
* ``fold_errors``: searches of the wrong length plus trials whose active
  flag or loss is missing (an exact count).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import prng, tpe


@dataclasses.dataclass
class Search:
    seed: int
    vals: dict      # label -> float array [T]
    active: dict    # label -> bool array [T]
    losses: np.ndarray  # [T]; inf or nan where the trial reported none


def numbers():
    """The compared numbers before anything is judged."""
    return {"loss_gap": 0.0, "draw_gap": 0.0, "select_gap": 0.0, "fold_errors": 0}


def judge_search(out, cfg, objective, labels, s):
    """Judge a search's fold and losses into ``out``."""
    out["fold_errors"] += fold_errors(cfg, labels, s)
    out["loss_gap"] = max(out["loss_gap"], loss_gap(objective, labels, s))


def _t(a, device):
    return torch.as_tensor(np.asarray(a, np.float64), device=device)


def fold_errors(cfg, labels, s):
    """Searches of the wrong length, plus trials whose active flag or loss
    is missing."""
    T = int(cfg["max_evals"])
    errs = 0 if len(s.losses) == T else 1
    for lb in labels:
        errs += int(len(s.active[lb.name]) != len(s.losses))
        errs += int(np.sum(~np.asarray(s.active[lb.name], bool)))
    errs += int(np.sum(~np.isfinite(np.asarray(s.losses, np.float64))))
    return errs


def loss_gap(objective, labels, s):
    """Largest ``|loss - f(x)| / max(1, |f(x)|)`` over a search's trials."""
    vals = {lb.name: np.asarray(s.vals[lb.name], np.float64) for lb in labels}
    for lb in labels:
        if lb.as_int():
            vals[lb.name] = np.round(vals[lb.name])
    ref = np.asarray(objective(vals), np.float64)
    got = np.asarray(s.losses, np.float64)
    gap = np.abs(got - ref) / np.maximum(1.0, np.abs(ref))
    return float(np.nan_to_num(gap, nan=np.inf).max()) if len(gap) else 0.0


def startup_gap(labels, keys, vals, device):
    """Largest gap of startup values ``vals[label][N]`` against the prior
    draws of the trial keys ``keys[N, 2]``, in units of each prior's range."""
    worst = 0.0
    for lb in labels:
        k = prng.fold_in(keys, lb.hash)
        want = tpe.prior_draw(lb, k)
        got = _t(vals[lb.name], device)
        if lb.log:
            d = (torch.log(got)[:, None] - torch.log(want)).abs() / lb.prior_sigma
        else:
            d = (got[:, None] - want).abs() / lb.prior_sigma
        worst = max(worst, float(d.min(-1).values.max()) if d.numel() else 0.0)
    return worst


def judge_steps(cfg, labels, s, steps, keys, device):
    """Judge TPE proposals ``steps[S]`` (trial indices) of one search whose
    histories are its trials before each, with trial keys ``keys[S, 2]``."""
    T = len(s.losses)
    idx = torch.arange(T, device=device)
    steps_t = torch.as_tensor(steps, device=device)
    before = idx[None, :] < steps_t[:, None]
    losses = _t(s.losses, device).expand(len(steps), T)
    has = before & torch.isfinite(losses)
    below, above = tpe.split_below(losses, has, float(cfg["gamma"]), int(cfg["LF"]))
    draw = select = 0.0
    for lb in labels:
        act = torch.as_tensor(np.asarray(s.active[lb.name], bool), device=device)
        obs = _t(s.vals[lb.name], device).expand(len(steps), T)
        fits = tpe.posterior(lb, obs, below & act, above & act, cfg)
        proposed = _t(s.vals[lb.name], device)[steps_t]
        d, g = tpe.judge(lb, fits, torch.arange(len(steps), device=device),
                         prng.fold_in(keys, lb.hash), proposed, cfg)
        draw, select = max(draw, float(d.max())), max(select, float(g.max()))
    return draw, select


def judge_generation(cfg, labels, s, n_done, js, keys, device):
    """Judge proposals ``js`` of the generation after ``n_done`` trials: all
    read one posterior."""
    T = len(s.losses)
    idx = torch.arange(T, device=device)
    losses = _t(s.losses, device)[None]
    has = (idx < n_done)[None] & torch.isfinite(losses)
    below, above = tpe.split_below(losses, has, float(cfg["gamma"]), int(cfg["LF"]))
    fi = torch.zeros(len(js), dtype=torch.int64, device=device)
    draw = select = 0.0
    for lb in labels:
        act = torch.as_tensor(np.asarray(s.active[lb.name], bool), device=device)[None]
        fits = tpe.posterior(lb, _t(s.vals[lb.name], device)[None], below & act,
                             above & act, cfg)
        proposed = _t(s.vals[lb.name], device)[n_done + torch.as_tensor(js, device=device)]
        d, g = tpe.judge(lb, fits, fi, prng.fold_in(keys, lb.hash), proposed, cfg)
        draw, select = max(draw, float(d.max())), max(select, float(g.max()))
    return draw, select


def sampler(seed):
    """The check's sampler, drawn from the run's seed (any integer)."""
    return np.random.default_rng([int(seed) & prng.M32, (int(seed) >> 32) & prng.M32, 0xC4EC])


def sample(rng, population, k, must):
    """``must`` plus up to ``k`` more drawn from ``population`` without
    replacement, sorted."""
    chosen = set(must)
    rest = [p for p in population if p not in chosen]
    extra = rng.choice(len(rest), size=min(k, len(rest)), replace=False) if rest else []
    return sorted(chosen | {rest[i] for i in extra})


def correct(numbers, limits):
    """True when every number with a limit is at or under it (and finite)."""
    return all(math.isfinite(float(numbers[k])) and float(numbers[k]) <= float(v)
               for k, v in limits.items())
