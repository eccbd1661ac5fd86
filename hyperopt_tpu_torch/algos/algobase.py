"""Shared scaffolding for suggest algorithms (counterpart of
``hyperopt_tpu/algos/algobase.py``).

A suggester subclasses :class:`SuggestAlgo` and implements
``build(cs, cfg)``, returning ``propose(history, keys) -> {label: value}``
over the padded history and a ``[B, 2]`` batch of per-id keys, with the
values ``[B]``.  The JAX package ``vmap``s a per-key function and jits
it; here ``propose`` is written over the id axis in plain torch, so a
history-only step (a sort, a count) runs once and every id shares it.
The base class owns the runtime plumbing: the startup delegation to
random search, the history read (int8/fp8 codes decoded to float32),
per-id keys, a cache of built steps and reference-shaped trial docs.
An armed obs run (``trials.obs_health``) records the cheap proposal
health (duplicate rate and spread across the batch) from the values the
ask reads back anyway; the JAX package's cost capture of the compiled
program has no torch counterpart (no kernel of the port runs here).
"""

from __future__ import annotations

import torch

from .. import prng, quant
from ..utils import LRUCache
from . import rand

__all__ = ["SuggestAlgo"]


class SuggestAlgo:
    """Base class turning a batched proposal step into a
    ``suggest(new_ids, domain, trials, seed)`` plugin."""

    #: observed trials below which the ask is delegated to ``rand.suggest``
    n_startup_jobs = 0

    #: the algo name health records carry (default: the class name)
    obs_name = None

    def __init__(self, **cfg):
        self.cfg = cfg

    def build(self, cs, cfg):
        """Return ``propose(history, keys[B, 2]) -> {label: value[B]}``."""
        raise NotImplementedError

    #: (algo class, space signature, cfg) -> proposal step, for every
    #: subclass; the steps hold only host tables and cached constants
    _cache = LRUCache(32)

    def _get_propose(self, cs, cfg):
        key = (type(self).__name__, cs.signature(), tuple(sorted(cfg.items())))
        fn = SuggestAlgo._cache.get(key)
        if fn is None:
            fn = self.build(cs, cfg)
            SuggestAlgo._cache.put(key, fn)
        return fn

    def __call__(self, new_ids, domain, trials, seed, **overrides):
        cfg = dict(self.cfg, **overrides)
        n_startup = cfg.pop("n_startup_jobs", self.n_startup_jobs)
        if len(trials.trials) < n_startup:
            return rand.suggest(new_ids, domain, trials, seed)
        if not len(new_ids):
            return []
        cs = domain.cs
        view = trials.padded_history(cs.labels)
        history = {"losses": view["losses"], "has_loss": view["has_loss"],
                   "vals": dict(view["vals"]), "active": view["active"]}
        ph = trials.history_object(cs.labels)  # folded already: only its qparams
        if ph.qparams is not None:
            # int8/fp8 codes decode to float32 at this read boundary, so a
            # subclass never sees storage codes; bf16 mirrors pass as they are
            for l, v in history["vals"].items():
                if quant.quant_dtype_name(v.dtype) is not None:
                    history["vals"][l] = quant.dequantize(v, ph.qparams[l])
        propose = self._get_propose(cs, cfg)
        dev = view["losses"].device
        ids = torch.tensor([int(i) & 0xFFFFFFFF for i in new_ids], dtype=torch.int64,
                           device=dev)
        keys = prng.fold_in(rand.seed_to_key(int(seed), dev), ids)
        mat = rand.pack_labels(cs, propose(history, keys))
        flats = rand.unpack_flats(cs, mat, len(new_ids))
        health = getattr(trials, "obs_health", None)
        if health is not None and len(flats) >= 2:
            from ..obs.health import record_proposal_health

            record_proposal_health(health, self.obs_name or type(self).__name__.lower(),
                                   cs.labels, flats)
        return rand.flat_to_new_trial_docs(domain, trials, new_ids, flats)
