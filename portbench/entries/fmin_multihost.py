"""Entry ``fmin_multihost``: ``parallel.fmin_multihost(fn, space,
max_evals, batch, seed, cfg)`` in one process with no process group,
what a user of ``batch`` parallel workers runs; ``fn`` is evaluated on
the host, one trial at a time.

The program's key schedule, which ``judge`` follows: generation ``g`` of
a search with seed ``s`` draws trial ``j``'s key as ``fold_in(key((s +
GOLDEN (g + 1)) mod 2**32), j)``, and a label's key folds in the label's
hash; generations before ``n_startup`` trials are prior draws, the rest
TPE proposals from every trial before them."""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

import drive
from reference import check, prng, tpe

GOLDEN = 0x9E3779B1
#: the TPE settings the configuration hands the driver
SETTINGS = ("prior_weight", "n_EI_candidates", "gamma", "LF", "ei_select", "ei_tau",
            "prior_eps")


class Entry:
    """The program under test, loaded once per run."""

    def __init__(self, cfg, fn, device):
        from hyperopt_tpu_torch import hp
        from hyperopt_tpu_torch.parallel import driver

        self.cfg, self.fn, self.device = cfg, fn, device
        self.space = drive.build_space(hp, cfg["space"])
        self.labels = list(cfg["space"])
        self._fmh = driver.fmin_multihost
        self._settings = {k: cfg[k] for k in SETTINGS if k in cfg}

    def search(self, seed, obs=None):
        """One whole search; returns its ``MultihostResult``."""
        return self._fmh(self.fn, self.space, max_evals=int(self.cfg["max_evals"]),
                         batch=int(self.cfg["batch"]), seed=seed, cfg=dict(self._settings),
                         n_startup=int(self.cfg["n_startup"]), obs=obs, device=self.device)

    def trials(self, handle):
        return int(handle.n_evals)

    def extract(self, handle, seed):
        """The search as plain arrays, after the window."""
        return check.Search(seed, {l: np.asarray(handle.vals[l], np.float64) for l in self.labels},
                            {l: np.asarray(handle.active[l], bool) for l in self.labels},
                            np.asarray(handle.losses, np.float64))

    def tpe_generations(self):
        T, B, n0 = (int(self.cfg[k]) for k in ("max_evals", "batch", "n_startup"))
        return sum(1 for s in range(0, T, B) if s >= n0)

    def traced(self, seed, spec, session, art, host_marks):
        """The whole search under the profiler, with the driver's span JSONL
        (``art["spans"]``) written under the run's cache directory
        ``art["cache"]``; ``art["tpe_steps"]`` is its TPE generations."""
        path = pathlib.Path(art["cache"]) / "spans" / "traced.jsonl"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.unlink(missing_ok=True)
        session.start()
        handle = self.search(seed, obs=str(path))
        session.stop()
        rows = [json.loads(line) for line in path.read_text().splitlines() if line.strip()]
        art["spans"] = [r for r in rows if r.get("kind") == "span"]
        art["tpe_steps"] = self.tpe_generations()
        for r in art["spans"]:
            if r.get("name") in ("propose", "evaluate", "fold"):
                host_marks.append((r["name"], r["ts"], r["ts"] + r["wall_sec"]))
        return handle


def judge(cfg, objective, searches, n_check, seed, device="cpu"):
    """The compared numbers of the window's searches: every trial's loss
    and fold, every prior draw, and ``n_check`` TPE proposals drawn from
    the run's ``seed`` (the last proposal of every search among them)."""
    labels = tpe.labels_of(cfg["space"])
    out = check.numbers()
    B, n0 = int(cfg["batch"]), int(cfg["n_startup"])
    pop, must = [], []
    for i, s in enumerate(searches):
        T = len(s.losses)
        for g, start in enumerate(range(0, T, B)):
            if start >= n0:
                pop += [(i, g, j) for j in range(min(B, T - start))]
        last = (T - 1) // B
        if last * B >= n0:
            must.append((i, last, T - 1 - last * B))
    picked = check.sample(check.sampler(seed), pop, n_check, must)
    for i, s in enumerate(searches):
        check.judge_search(out, cfg, objective, labels, s)
        T = len(s.losses)
        for g, start in enumerate(range(0, T, B)):
            n = min(B, T - start)
            gseed = (int(s.seed) + GOLDEN * (g + 1)) & prng.M32
            keys = prng.fold_in(prng.key(gseed, device),
                                torch.arange(B, dtype=torch.int64, device=device))
            if start < n0:
                d = check.startup_gap(labels, keys[:n],
                                      {k: v[start:start + n] for k, v in s.vals.items()}, device)
                out["draw_gap"] = max(out["draw_gap"], d)
                continue
            js = [j for (a, b, j) in picked if a == i and b == g]
            for c in range(0, len(js), 256):
                part = js[c:c + 256]
                d, gap = check.judge_generation(cfg, labels, s, start, part, keys[part], device)
                out["draw_gap"] = max(out["draw_gap"], d)
                out["select_gap"] = max(out["select_gap"], gap)
    out["checked_proposals"] = len(picked)
    return out
