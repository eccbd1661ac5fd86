"""Entry ``fmin_device_loop``: ``fmin(fn, space, algo=partial(tpe.suggest,
...), max_evals, trials=Trials(), rstate=default_rng(seed),
device_loop=True)``, what a hyperopt user with an objective in torch ops
calls; every ask-tell step is one CUDA-graph replay on the card, and the
host reads back once per chunk of ``CHUNK`` steps.

The program's key schedule, which ``judge`` follows: each chunk draws a
seed from the search's ``numpy.random.default_rng(seed)``; step ``i``'s
key is ``fold_in(fold_in(key(lo), hi), i)`` of that seed's words, and a
label's key folds in the label's hash.  A TPE step selects its candidate
by the EI argmax (``tpe.suggest``'s selection)."""

from __future__ import annotations

import functools
import math
import time

import numpy as np
import torch

import drive
from reference import check, prng, tpe

CHUNK = 10  # fmin's device-loop chunk: steps per read-back and per drawn seed


class Entry:
    """The program under test, loaded once per run."""

    def __init__(self, cfg, fn, device):
        from hyperopt_tpu_torch import fmin, hp, tpe as port_tpe
        from hyperopt_tpu_torch.base import Trials

        if int(cfg["batch"]) != 1:
            raise ValueError("the device loop proposes one trial a step (batch 1)")
        self.cfg, self.fn, self.device = cfg, fn, device
        self.space = drive.build_space(hp, cfg["space"])
        self.labels = list(cfg["space"])
        self._fmin, self._trials = fmin, Trials
        self._algo = functools.partial(
            port_tpe.suggest, n_startup_jobs=int(cfg["n_startup"]),
            n_EI_candidates=int(cfg["n_EI_candidates"]), gamma=float(cfg["gamma"]),
            linear_forgetting=int(cfg["LF"]), prior_weight=float(cfg["prior_weight"]))

    def search(self, seed, early_stop_fn=None):
        """One whole search; returns its ``Trials``."""
        trials = self._trials(device=self.device)
        self._fmin(self.fn, self.space, algo=self._algo, max_evals=int(self.cfg["max_evals"]),
                   trials=trials, rstate=np.random.default_rng(seed), device_loop=True,
                   show_progressbar=False, early_stop_fn=early_stop_fn)
        return trials

    def trials(self, handle):
        return len(handle.trials)

    def extract(self, handle, seed):
        """The search as plain arrays, after the window."""
        docs = sorted(handle.trials, key=lambda d: d["tid"])
        vals = {l: np.array([d["misc"]["vals"][l][0] if d["misc"]["vals"][l] else math.nan
                             for d in docs], np.float64) for l in self.labels}
        active = {l: np.array([bool(d["misc"]["vals"][l]) for d in docs]) for l in self.labels}
        losses = np.array([d["result"].get("loss", math.nan) for d in docs], np.float64)
        return check.Search(seed, vals, active, losses)

    def traced(self, seed, spec, session, art, host_marks):
        """The search with the profiler over its chunks ``[skip_chunks,
        skip_chunks + chunks)``, started and stopped at chunk boundaries
        from ``fmin``'s ``early_stop_fn``; ``art["tpe_steps"]`` is the TPE
        graph replays between, as ``device_fmin.loop_stats`` counts them."""
        from hyperopt_tpu_torch import device_fmin

        def replays():
            return sum(s["replays"]["tpe"] for s in device_fmin.loop_stats()
                       if s["kind"] == "chunk")

        first = int(spec["skip_chunks"])
        last = first + int(spec["chunks"])
        state = {"calls": 0}

        def stop():
            session.stop()
            art["tpe_steps"] = replays() - state["r0"]

        def hook(trials, *rest):
            state["calls"] += 1
            if state["calls"] == first:
                session.start()
                state["r0"] = replays()
            elif first < state["calls"] <= last:
                t = time.time()
                # fmin calls the hook between a chunk's read-back and the next
                # chunk: the host's read-back, trial documents and bookkeeping
                host_marks.append(("chunk boundary", t - 5e-3, t + 5e-3))
                if state["calls"] == last:
                    stop()
            return False, []

        handle = self.search(seed, early_stop_fn=hook)
        if session.prof is not None:  # a search shorter than the traced chunks
            stop()
        return handle


def judge(cfg, objective, searches, n_check, seed, device="cpu"):
    """The compared numbers of the window's searches: every trial's loss
    and fold, every startup draw, and ``n_check`` TPE steps drawn from the
    run's ``seed`` (the last step of every search among them)."""
    cfg = {**cfg, "ei_select": "argmax"}
    labels = tpe.labels_of(cfg["space"])
    out = check.numbers()
    n0 = int(cfg["n_startup"])
    pop = [(i, t) for i, s in enumerate(searches) for t in range(n0, len(s.losses))]
    must = [(i, len(s.losses) - 1) for i, s in enumerate(searches) if len(s.losses) > n0]
    picked = check.sample(check.sampler(seed), pop, n_check, must)
    for i, s in enumerate(searches):
        check.judge_search(out, cfg, objective, labels, s)
        T = len(s.losses)
        rs = np.random.default_rng(int(s.seed))
        seeds = [int(rs.integers(2 ** 31 - 1)) for _ in range(-(-T // CHUNK))]
        words = torch.as_tensor([prng.seed_words(x) for x in seeds], device=device)
        base = prng.fold_in(prng.key(words[:, 0], device), words[:, 1])
        steps = torch.arange(T, device=device)
        keys = prng.fold_in(base[steps // CHUNK], steps)
        k = min(n0, T)
        out["draw_gap"] = max(out["draw_gap"], check.startup_gap(
            labels, keys[:k], {n: v[:k] for n, v in s.vals.items()}, device))
        mine = [t for j, t in picked if j == i]
        for b in range(0, len(mine), 64):
            part = mine[b:b + 64]
            d, g = check.judge_steps(cfg, labels, s, part, keys[part], device)
            out["draw_gap"] = max(out["draw_gap"], d)
            out["select_gap"] = max(out["select_gap"], g)
    out["checked_proposals"] = len(picked)
    return out
