"""Random-search suggester (counterpart of ``hyperopt_tpu/algos/rand.py``).

Each new id folds into a threefry key derived from the seed, and the
compiled space's ``sample_flat`` draws every parameter for the whole id
batch at once on the trials' device; one packed ``[B, L]`` matrix comes
back to the host per ask.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import prng

__all__ = ["suggest", "suggest_batch", "suggest_async", "suggest_many", "AskHandle",
           "flat_to_new_trial_docs",
           "seed_to_key", "fold_ids", "pack_labels", "unpack_flats", "pad_ids_pow2",
           "pad_ids_to_multiple", "pad_ids_sticky"]


class AskHandle:
    """One dispatched ask: the device work is queued; :meth:`result`
    performs the (blocking) readback and builds the trial docs."""

    def __init__(self, new_ids, finish):
        self.new_ids = list(new_ids)
        self._finish = finish
        self._docs = None

    def result(self):
        """Block on the packed proposal matrix and return the trial docs
        (idempotent)."""
        if self._finish is not None:
            self._docs = self._finish()
            self._finish = None
        return self._docs


def seed_to_key(seed, device):
    """Full-width key from an integer seed: the low 32 bits seed the key and
    the high word is folded in (the tick's own derivation)."""
    lo, hi = prng.seed_words(seed)
    return prng.fold_in(prng.PRNGKey(lo, device), hi)


def fold_ids(key, new_ids):
    """One derived key ``fold_in(key, id)`` per new id (full 32-bit id
    range): ``[len(new_ids), 2]`` on ``key``'s device."""
    ids = torch.as_tensor([int(i) & 0xFFFFFFFF for i in new_ids], dtype=torch.int64)
    return prng.fold_in(key, ids.to(key.device))


def flat_to_new_trial_docs(domain, trials, new_ids, flats):
    """Reference-shaped trial docs from flat per-label host samples;
    inactive conditional params get empty idxs/vals."""
    rval = []
    for new_id, flat in zip(new_ids, flats):
        active = domain.cs.active_flat(flat)
        idxs = {}
        vals = {}
        for label, info in domain.cs.params.items():
            if active[label]:
                v = flat[label]
                v = int(v) if info.is_int else float(v)
                idxs[label] = [new_id]
                vals[label] = [v]
            else:
                idxs[label] = []
                vals[label] = []
        misc = {"tid": new_id, "cmd": ("domain_attachment", "FMinIter_Domain"),
                "idxs": idxs, "vals": vals}
        if domain.workdir is not None:
            misc["workdir"] = domain.workdir
        rval.extend(
            trials.new_trial_docs([new_id], [None], [domain.new_result()], [misc]))
    return rval


def pack_labels(cs, out):
    """Stack ``{label: value[B]}`` into one ``[B, L]`` float32 matrix in
    ``cs.labels`` order, so every ask reads back one buffer."""
    return torch.stack([out[l].to(torch.float32) for l in cs.labels], dim=-1)


def unpack_flats(cs, mat, n):
    """Invert :func:`pack_labels` on host: ``[n, L]`` matrix → flat dicts."""
    mat = mat.cpu().numpy() if isinstance(mat, torch.Tensor) else np.asarray(mat)
    return [
        {
            l: (int(round(float(mat[i, j]))) if cs.params[l].is_int
                else float(mat[i, j]))
            for j, l in enumerate(cs.labels)
        }
        for i in range(n)
    ]


def pad_ids_pow2(new_ids, min_bucket=1):
    """Pad an id batch to a power of two (at least ``min_bucket``) by
    repeating the last id.  Padding never changes the kept proposals:
    per-id keys derive from the id value, not its position."""
    ids = [int(i) & 0xFFFFFFFF for i in new_ids]
    B = 1
    while B < max(len(ids), int(min_bucket)):
        B *= 2
    return np.asarray(ids + [ids[-1]] * (B - len(ids)), np.int64)


def pad_ids_to_multiple(ids, n):
    """Pad an already-bucketed id array up to a multiple of ``n`` (a mesh's
    entry count) by repeating the last id: a sharded program splits the
    batch axis evenly over the mesh.  Extras are discarded on the host and
    never change the kept proposals (per-id keys derive from the id
    value)."""
    n = int(n)
    if n <= 1 or len(ids) % n == 0:
        return ids
    B = -(-len(ids) // n) * n
    return np.concatenate([ids, np.full(B - len(ids), ids[-1], ids.dtype)])


def pad_ids_sticky(domain, new_ids):
    """``pad_ids_pow2`` with a per-domain floor that never shrinks below the
    widest batch this domain has already asked for."""
    padded = pad_ids_pow2(new_ids, getattr(domain, "_ids_bucket", 1))
    domain._ids_bucket = len(padded)
    return padded


def _draw(cs, asks, device):
    """The packed ``[rows, L]`` prior draw of ``asks`` (``[(ids, seed),
    ...]``) on ``device``, in one batch.  Row ``r``'s key is
    ``fold_in(seed_to_key(seed), id)`` whatever the batch (the seed's key
    is derived on every row), and the draw is per row."""
    words = [(prng.seed_words(seed), len(ids)) for ids, seed in asks]
    lo = np.concatenate([np.full(n, w[0], np.int64) for w, n in words])
    hi = np.concatenate([np.full(n, w[1], np.int64) for w, n in words])
    ids = np.concatenate([np.asarray(ids, np.int64) & 0xFFFFFFFF for ids, _ in asks])
    seed_keys = prng.fold_in(prng.PRNGKey(torch.from_numpy(lo), device), torch.from_numpy(hi))
    keys = prng.fold_in(seed_keys, torch.from_numpy(ids).to(device))
    return pack_labels(cs, cs.sample_flat(keys))


def suggest_async(new_ids, domain, trials, seed):
    """Queue the batched prior draw on the trials' device and return an
    :class:`AskHandle`; its ``result()`` reads back and builds the docs."""
    if not len(new_ids):
        return AskHandle([], lambda: [])
    mat = _draw(domain.cs, [(pad_ids_sticky(domain, new_ids), seed)], trials.device)

    def finish():
        flats = unpack_flats(domain.cs, mat, len(new_ids))
        return flat_to_new_trial_docs(domain, trials, new_ids, flats)

    return AskHandle(new_ids, finish)


def suggest(new_ids, domain, trials, seed):
    """Draw one prior sample per new id (hyperopt/rand.py sym: suggest)."""
    return suggest_async(new_ids, domain, trials, seed).result()


def suggest_many(asks):
    """The docs of many asks over one search space, from one batched draw:
    ``asks`` is ``[(new_ids, domain, trials, seed), ...]`` with every
    domain over the same space (one signature) and every trials on one
    device.  Each ask's docs equal :func:`suggest`'s (:func:`_draw` keys
    a row by its seed and id alone).  The study scheduler serves a wave's
    startup asks this way."""
    if not asks:
        return []
    cs = asks[0][1].cs
    mat = _draw(cs, [(ids, seed) for ids, _, _, seed in asks], asks[0][2].device).cpu().numpy()
    out, row = [], 0
    for new_ids, domain, trials, _ in asks:
        flats = unpack_flats(cs, mat[row:row + len(new_ids)], len(new_ids))
        out.append(flat_to_new_trial_docs(domain, trials, new_ids, flats))
        row += len(new_ids)
    return out


def suggest_batch(new_ids, domain, trials, seed):
    """Alias of :func:`suggest` (hyperopt/rand.py sym: suggest_batch): the
    serial path already draws every id in one batched program."""
    return suggest(new_ids, domain, trials, seed)
