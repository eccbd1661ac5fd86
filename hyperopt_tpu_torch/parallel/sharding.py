"""Mesh sharding for the TPE proposal steps (counterpart of
``hyperopt_tpu/parallel/sharding.py``).

Two axes scale in an HPO workload: the **trial batch** (how many new trials
one step proposes) and the **candidate axis** (``n_EI_candidates`` draws
per proposal).  :func:`suggest_batch_sharded` splits the first over the
entries of a :class:`Mesh` (every entry proposes its contiguous slice of
the keys; the history is replicated, or past :func:`hist_shard_threshold`
split along its capacity axis).  :func:`propose_sharded_candidates` splits
the second: each entry of the ``cand`` axis draws and scores a local
candidate slice, keeps its top-k (EI, value) pairs, and a pooled select
over the shards' top-k, gathered in shard order, resolves each proposal.

The JAX package compiles one program with ``NamedSharding``s and lets XLA
place the shards.  Torch has no such program, so here a sharded step loops
over the mesh entries this process owns and runs the same eager code on
each entry's slice, on the entry's device.  Each proposal depends only on
its key and the history, so the bits do not depend on the mesh.  A mesh
may name one device more than once (the counterpart of XLA's forced host
device count), which is how one card runs every sharded path.

The **partition-rule table** (:func:`suggest_partition_rules`, applied by
:func:`match_partition_rules`: a regex over each leaf's "/"-joined path →
a :class:`PartitionSpec`) stays the single source of which leaf is split
and which is replicated: :func:`place_history` and :func:`build_history_fold`
read it, as the sharded tick and cohort do.  A placed leaf is a
:class:`Placed`: the tensor each mesh entry holds, the whole leaf or its
slice of the leading axis.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch

from .. import prng
from .._env import resolve_device
from ..algos import rand, tpe
from ..spaces import label_hash

__all__ = [
    "TRIALS_AXIS",
    "CAND_AXIS",
    "PartitionSpec",
    "NamedSharding",
    "Mesh",
    "Placed",
    "make_mesh",
    "suggest_mesh",
    "suggest_batch_sharded",
    "propose_sharded_candidates",
    "replicate_history",
    "place_history",
    "build_history_fold",
    "match_partition_rules",
    "suggest_partition_rules",
    "suggest_shardings",
    "suggest_batched_shardings",
    "hist_shard_threshold",
    "should_shard_history",
]

TRIALS_AXIS = "trials"
CAND_AXIS = "cand"


class PartitionSpec(tuple):
    """How a leaf lies on a mesh, as ``jax.sharding.PartitionSpec`` says
    it: ``P()`` replicates it on every entry, ``P(axes)`` splits its
    leading axis over the mesh axes ``axes`` (a name or a tuple of
    names)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


class NamedSharding(tuple):
    """A ``(mesh, spec)`` pair: where one argument of a sharded step lies."""

    def __new__(cls, mesh, spec):
        return super().__new__(cls, (mesh, spec))

    mesh = property(lambda self: self[0])
    spec = property(lambda self: self[1])


class Mesh:
    """A grid of ``torch.device`` entries with named axes, the counterpart
    of ``jax.sharding.Mesh``.  An entry may repeat a device.  ``ranks``
    gives each entry's owning process (all 0 for a one-process mesh); a
    process only ever touches the entries it owns (:meth:`local`)."""

    def __init__(self, devices, axis_names, ranks=None, rank=0):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(f"a {arr.ndim}-d device grid needs {arr.ndim} axis names, "
                             f"got {axis_names}")
        self.devices = np.empty(arr.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            self.devices[idx] = torch.device(arr[idx])
        self.axis_names = tuple(axis_names)
        self.ranks = (np.zeros(arr.shape, np.int64) if ranks is None
                      else np.asarray(ranks, np.int64).reshape(arr.shape))
        self.rank = int(rank)

    @property
    def shape(self):
        """``{axis name: size}`` in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    def local(self):
        """Flat indices of the entries this process owns."""
        return [i for i, r in enumerate(self.ranks.flat) if int(r) == self.rank]

    def geometry(self):
        """A hashable description: axes and sizes, entries and owners."""
        return (tuple(self.shape.items()), tuple(str(d) for d in self.devices.flat),
                tuple(int(r) for r in self.ranks.flat))

    def __repr__(self):
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


class Placed:
    """One leaf on a mesh: ``parts[i]`` is what flat mesh entry ``i``
    holds, the whole leaf (replicated) or with ``split`` its contiguous
    slice of the leading axis; ``None`` for an entry another process owns.
    ``gather`` is the collective that completes a split leaf whose parts
    are not all local (``multihost``), None in one process."""

    __slots__ = ("parts", "split", "gather")

    def __init__(self, parts, split, gather=None):
        self.parts = list(parts)
        self.split = bool(split)
        self.gather = gather

    @property
    def dtype(self):
        return next(p for p in self.parts if p is not None).dtype

    def local(self, i, device):
        """Entry ``i``'s view of the whole leaf on ``device``: its own part
        when replicated, the parts concatenated (gathered first when some
        belong to other processes) when split."""
        if not self.split:
            return self.parts[i].to(device)
        parts = self.parts
        if any(p is None for p in parts):
            if self.gather is None:
                raise ValueError("a split leaf with parts on other processes needs "
                                 "the multihost gather")
            parts = self.gather(parts)
        return torch.cat([p.to(device) for p in parts])


# ---------------------------------------------------------------------------
# the partition-rule table
# ---------------------------------------------------------------------------


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    return fn("/".join(path), tree)


def match_partition_rules(rules, tree):
    """Map every leaf of the dict tree ``tree`` to the spec of the first
    rule whose regex matches its "/"-joined key path.  Only the structure
    and the key names matter.  An unmatched leaf raises: a leaf silently
    replicated is the memory wall this table exists to prevent."""

    def spec_for(name, _leaf):
        for rule, spec in rules:
            if re.search(rule, name) is not None:
                return spec
        raise ValueError(f"no partition rule matches leaf {name!r}")

    return _map_with_path(spec_for, tree)


def suggest_partition_rules(shard_history=False, axes=None, study_axis=False):
    """The rule table of the tell+ask step and the generation fold: leaf
    path regex → :class:`PartitionSpec`.

    * the proposal batch axis (``ids``, ``packed``, diagnostics) always
      splits over the mesh ``axes`` (default :data:`CAND_AXIS`, the 1-D
      suggest mesh; the driver's 2-D global mesh passes both);
    * every history leaf (``vals/*``, ``active/*``, ``losses``,
      ``has_loss``) replicates below :func:`hist_shard_threshold` and
      splits its capacity axis above it;
    * the small side inputs (``rows``, ``seed_words``, the fold's row
      buffers) replicate.

    ``study_axis=True`` is the cohort's layout (``tpe.build_suggest_batched``):
    every leaf carries a leading study axis and that axis splits, so each
    entry owns whole studies."""
    axes = (CAND_AXIS,) if axes is None else tuple(axes)
    batch = P(axes)
    if study_axis:
        return (
            (r"^hist/", batch),
            (r"^(rows|seed_words|ids|packed|stats|splits)$", batch),
        )
    hist = P(axes) if shard_history else P()
    return (
        (r"^hist/(vals|active)/", hist),
        (r"^hist/(losses|has_loss)$", hist),
        (r"^(rows|seed_words)$", P()),
        (r"^(vals_rows|active_rows|fold_losses|fold_has|fold_idx)$", P()),
        (r"^ids$", batch),
        (r"^(packed|stats|splits)$", batch),
    )


def _hist_skeleton(labels):
    """Name-shaped skeleton of the padded-history tree."""
    return {"losses": 0, "has_loss": 0, "vals": {l: 0 for l in labels},
            "active": {l: 0 for l in labels}}


def _shardings(mesh, rules, labels, diag=False):
    hist = _hist_skeleton(labels)
    in_tree = {"hist": hist, "rows": 0, "seed_words": 0, "ids": 0}
    out_tree = {"hist": hist, "packed": 0}
    if diag:
        out_tree.update(stats=0, splits=0)
    ns = lambda tree: _map_with_path(lambda _n, s: NamedSharding(mesh, s), tree)  # noqa: E731
    in_sh = ns(match_partition_rules(rules, in_tree))
    out_sh = ns(match_partition_rules(rules, out_tree))
    outs = [out_sh["hist"], out_sh["packed"]]
    if diag:
        outs += [out_sh["stats"], out_sh["splits"]]
    return (in_sh["hist"], in_sh["rows"], in_sh["seed_words"], in_sh["ids"]), tuple(outs)


def suggest_shardings(mesh, labels, shard_history=False, diag=False):
    """``(in_shardings, out_shardings)`` of the tell+ask step
    ``run(history, rows, seed_words, ids) -> (history', packed[, stats,
    splits])``, from :func:`suggest_partition_rules`."""
    return _shardings(mesh, suggest_partition_rules(shard_history), labels, diag)


def suggest_batched_shardings(mesh, labels):
    """``(in_shardings, out_shardings)`` of the cohort step
    ``run(hist_stack, rows, seed_words, ids) -> (hist_stack', packed)``:
    the leading study axis of every leaf splits over ``mesh``."""
    return _shardings(mesh, suggest_partition_rules(study_axis=True, axes=mesh.axis_names),
                      labels)


def hist_shard_threshold():
    """Capacity at which the history axis starts to split
    (``HYPEROPT_TPU_HIST_SHARD_MIN``)."""
    from .._env import parse_hist_shard_min

    return parse_hist_shard_min()


def should_shard_history(cap, mesh):
    """True when ``cap`` reaches the threshold and divides evenly over a
    mesh of more than one entry."""
    n = mesh.size
    return n > 1 and cap >= hist_shard_threshold() and cap % n == 0


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------


def local_devices(device=None):
    """This process's devices: ``cuda:0 .. cuda:n-1``, or the one CPU when
    ``device`` is a CPU device.  Without a card and no ``device`` this
    raises, as every entry point of the port does."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices=None, n_cand_shards=1, devices=None, device=None):
    """A ``(trials, cand)`` mesh over the first ``n_devices`` local devices
    (or over ``devices``, an explicit list that may repeat a device):
    ``n_cand_shards`` entries along the candidate axis, the rest along the
    trial-batch axis."""
    devs = list(devices) if devices is not None else local_devices(device)
    n = len(devs) if n_devices is None else int(n_devices)
    if n % n_cand_shards:
        raise ValueError(f"{n} devices not divisible by n_cand_shards={n_cand_shards}")
    grid = np.empty((n // n_cand_shards, n_cand_shards), dtype=object)
    for i, d in enumerate(devs[:n]):
        grid.flat[i] = d
    return Mesh(grid, (TRIALS_AXIS, CAND_AXIS))


# geometry -> 1-D suggest mesh, so a sharded step's caches see one object
_suggest_mesh_cache = {}


def suggest_mesh(n_devices=None, devices=None, device=None):
    """A flat 1-D ``(cand,)`` mesh over the first ``n_devices`` local
    devices (``None`` or ``-1``: all of them), or over ``devices``: the
    mesh the single-study tick and the cohorts split their batch axis
    over.  Cached per geometry."""
    devs = list(devices) if devices is not None else local_devices(device)
    n = len(devs) if n_devices in (None, -1) else min(int(n_devices), len(devs))
    key = tuple(str(torch.device(d)) for d in devs[:n])
    m = _suggest_mesh_cache.get(key)
    if m is None:
        grid = np.empty(n, dtype=object)
        for i, d in enumerate(devs[:n]):
            grid[i] = d
        m = _suggest_mesh_cache[key] = Mesh(grid, (CAND_AXIS,))
    return m


# ---------------------------------------------------------------------------
# history placement and the generation fold
# ---------------------------------------------------------------------------


def _compress(x, dtype):
    """``x`` as a tensor, its float leaves cast to ``dtype``.  int8/fp8
    code leaves (one-byte floats included) hold affine codes, not values,
    and keep their storage type."""
    x = torch.tensor(x) if isinstance(x, np.ndarray) else torch.as_tensor(x)
    if dtype is not None and x.dtype.is_floating_point and x.element_size() > 1:
        x = x.to(dtype)
    return x


def _place_leaf(x, spec, mesh, dtype=None, gather=None):
    x = _compress(x, dtype)
    split = len(spec) > 0
    n = mesh.size
    if split and x.shape[0] % n:
        raise ValueError(f"a leading axis of {x.shape[0]} does not split over {n} entries")
    step = x.shape[0] // n if split else None
    parts = [None] * n
    copies = {}  # one replicated copy per device
    for i in mesh.local():
        dev = mesh.devices.flat[i]
        if split:
            parts[i] = x[i * step:(i + 1) * step].to(dev)
        else:
            if str(dev) not in copies:
                copies[str(dev)] = x.to(dev)
            parts[i] = copies[str(dev)]
    return Placed(parts, split, gather)


def place_history(history, mesh, shard_history=False, dtype=None, gather=None,
                  study_axis=False):
    """Place the padded-history tree (``vals``, ``active``, ``losses``,
    ``has_loss``) on ``mesh`` by the rule table: replicated, or with
    ``shard_history=True`` split along the capacity axis (each entry then
    holds ``cap / n`` rows), or with ``study_axis=True`` (a cohort's
    ``[S, cap]`` stack) split along the study axis.  ``dtype`` compresses
    the float leaves; quantized leaves place as they are.  A leaf already
    on the device of an entry is not copied for it."""
    rules = suggest_partition_rules(shard_history, axes=mesh.axis_names,
                                    study_axis=study_axis)
    hist = {k: history[k] for k in ("losses", "has_loss", "vals", "active")}
    specs = match_partition_rules(rules, {"hist": _hist_skeleton(list(hist["vals"]))})["hist"]
    return {
        "losses": _place_leaf(hist["losses"], specs["losses"], mesh, dtype, gather),
        "has_loss": _place_leaf(hist["has_loss"], specs["has_loss"], mesh, dtype, gather),
        "vals": {l: _place_leaf(v, specs["vals"][l], mesh, dtype, gather)
                 for l, v in hist["vals"].items()},
        "active": {l: _place_leaf(v, specs["active"][l], mesh, dtype, gather)
                   for l, v in hist["active"].items()},
    }


def replicate_history(history, mesh):
    """Place the padded-history tree replicated on every entry."""
    return place_history(history, mesh, shard_history=False)


def entry_history(history, i, device):
    """Mesh entry ``i``'s whole view of a history tree on ``device``: a
    placed tree is completed from its parts, a plain tree moves there."""

    def leaf(x):
        if isinstance(x, Placed):
            return x.local(i, device)
        return torch.as_tensor(x).to(device)

    return {"losses": leaf(history["losses"]), "has_loss": leaf(history["has_loss"]),
            "vals": {l: leaf(v) for l, v in history["vals"].items()},
            "active": {l: leaf(v) for l, v in history["active"].items()}}


def _fold_leaf(leaf, values, idx):
    """Scatter ``values[k]`` to row ``idx[k]`` of ``leaf`` in place (a
    tensor or a :class:`Placed`); rows at or past the leaf's length are
    padding and dropped."""
    if isinstance(leaf, Placed):
        n, seen = _part_len(leaf), set()
        for j, part in enumerate(leaf.parts):
            if part is None:
                continue
            if leaf.split:
                _fold_leaf(part, values, idx - j * n)
            elif id(part) not in seen:  # a replicated copy shared by entries
                seen.add(id(part))
                _fold_leaf(part, values, idx)
        return leaf
    keep = (idx >= 0) & (idx < leaf.shape[0])
    if keep.any():
        at = torch.from_numpy(idx[keep]).to(leaf.device)
        leaf.index_put_((at,), torch.from_numpy(np.ascontiguousarray(values[keep]))
                        .to(device=leaf.device, dtype=leaf.dtype))
    return leaf


def _part_len(leaf):
    return next(p for p in leaf.parts if p is not None).shape[0]


def build_history_fold(labels, mesh=None, shard_history=False):
    """The generation fold: scatter a generation's rows into the history
    tree in place::

        fold(hist, vals_rows[W, L], active_rows[W, L], losses[W], has[W],
             idx[W]) -> hist

    The row buffers are host arrays; padding rows carry ``idx = cap`` and
    are dropped, so the call shape stays the batch width.  ``hist`` is a
    plain tree of tensors (``mesh=None``) or a tree placed on ``mesh`` by
    :func:`place_history` with the same ``shard_history``: a split leaf
    takes the rows that fall in each entry's slice, a replicated one
    takes every row once per device copy.  The result is ``hist`` itself,
    updated."""
    labels = tuple(labels)
    split = None
    if mesh is not None:
        rules = suggest_partition_rules(shard_history, axes=mesh.axis_names)
        split = bool(len(match_partition_rules(rules, {"hist": {"losses": 0}})["hist"]["losses"]))

    def fold(hist, vals_rows, active_rows, losses, has, idx):
        if split is not None and (not isinstance(hist["losses"], Placed)
                                  or hist["losses"].split != split):
            raise ValueError("the history is not placed as the rule table says for this fold")
        idx = np.asarray(idx, np.int64)
        vals_rows = np.asarray(vals_rows, np.float32)
        active_rows = np.asarray(active_rows, bool)
        _fold_leaf(hist["losses"], np.asarray(losses, np.float32), idx)
        _fold_leaf(hist["has_loss"], np.asarray(has, bool), idx)
        for j, l in enumerate(labels):
            _fold_leaf(hist["vals"][l], vals_rows[:, j], idx)
            _fold_leaf(hist["active"][l], active_rows[:, j], idx)
        return hist

    return fold


# ---------------------------------------------------------------------------
# the sharded proposal steps
# ---------------------------------------------------------------------------


def _split_rows(n_rows, n_parts, what):
    if n_rows % n_parts:
        raise ValueError(f"{what}={n_rows} does not split over {n_parts} mesh entries "
                         "(pad with rand.pad_ids_to_multiple)")
    return n_rows // n_parts


def suggest_batch_sharded(cs, cfg, mesh, packed=False, shard_history=False, qparams=None,
                          diag=False):
    """Data-parallel batched proposals: ``fn(history, keys[B, 2])``.

    Mesh entry ``i`` (flat order) proposes for keys ``i·B/n .. (i+1)·B/n``
    on its device, from the history replicated there, or with
    ``shard_history=True`` split along the capacity axis and concatenated
    for the Parzen fit.  ``history`` is a plain tree or one placed by
    :func:`place_history`.  Returns ``{label: [B_local]}`` or, with
    ``packed``, one ``[B_local, L]`` buffer (``rand.pack_labels`` order),
    on the first local entry's device: ``B_local`` rows are the entries
    this process owns, all ``B`` in one process.  Each proposal depends on
    its key and the history only, so the result equals the unsharded
    step's (``tpe.build_propose``).  ``diag=True`` (with ``packed``) runs
    the health-instrumented step and returns ``tpe._pack_health``'s
    ``[B_local, 10L+2]`` buffer."""
    if diag and not packed:
        raise ValueError("suggest_batch_sharded: diag needs packed=True")
    propose = (tpe.build_propose_with_scores(cs, cfg, qparams=qparams, diagnostics=True)
               if diag else tpe.build_propose(cs, cfg, qparams=qparams))

    def fn(history, keys):
        per = _split_rows(keys.shape[0], mesh.size, "batch")
        local = mesh.local()
        outs = []
        for i in local:
            dev = mesh.devices.flat[i]
            out = propose(entry_history(history, i, dev), keys[i * per:(i + 1) * per].to(dev))
            outs.append(tpe._pack_health(cs, *out) if diag else rand.pack_labels(cs, out))
        home = mesh.devices.flat[local[0]]
        mat = torch.cat([o.to(home) for o in outs])
        if packed:
            return mat
        return {l: mat[:, j] for j, l in enumerate(cs.labels)}

    return fn


def _stable_topk(ei, k):
    """The ``k`` largest of ``ei[..., n]`` in descending order, ties to the
    lower index first, as ``jax.lax.top_k`` orders them."""
    order = torch.sort(ei, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(ei, -1, order), order


def _prior_draws(cs):
    """Per label, one draw per key from the search-space prior (the
    ε-prior mix of the pooled select)."""
    draws = {}
    for l in cs.labels:
        dist = cs.params[l].dist
        if dist.family in ("categorical", "randint"):
            pp = tpe._prior_probs(dist)
            off = int(dist.params[0]) if dist.family == "randint" else 0

            def draw(kp, pp=pp, off=off):
                p = torch.as_tensor(pp, device=kp.device)[None]
                return (tpe._prior_draw_discrete(kp[None], p)[0] + off).to(torch.float32)
        else:
            parz = tpe._parzen_from(dist)

            def draw(kp, parz=parz):
                return tpe._prior_draw_numeric(kp, *parz)
        draws[l] = draw
    return draws


def propose_sharded_candidates(cs, cfg, mesh, packed=False, batch=None, topk=4,
                               qparams=None):
    """Proposals with the candidate axis split over the mesh's ``cand``
    axis.  ``batch=None`` is the one-proposal form ``fn(history, key[2])
    -> {label: scalar}`` (``[1, L]`` packed); ``batch=B`` gives
    ``fn(history, keys[B, 2]) -> {label: [B]}`` (``[B, L]`` packed), the
    batch split over the ``trials`` axis.

    Cand shard ``s`` draws ``ceil(n_EI_candidates / n_shards)`` candidates
    with ``fold_in(key, s)`` (``tpe.build_propose_candidates``); candidates
    past ``n_EI_candidates`` score ``-inf``, so an indivisible count pads
    and never wins.  Each shard keeps its top-``k`` (EI, value) pairs; the
    shards' pairs concatenate in shard order and the select follows
    ``cfg["ei_select"]`` over that pool, each label's key folded with
    ``label_hash(label)``, then the ε-prior mix (``prior_eps``, draws from
    ``fold_in(k, 0x9B10B)``, gate ``fold_in(k, 0xE9510)``)."""
    return _candidate_pool_step(cs, cfg, mesh, packed, batch, topk, qparams, fuse_shards=False)


def _propose_fused_pool(cs, cfg, mesh, packed=False, batch=None, topk=4, qparams=None):
    """The one-device program :func:`propose_sharded_candidates` is held
    against in the tests: every cand shard's candidates of a trials group
    in one call on its first entry (the same pool, from wider launches)."""
    return _candidate_pool_step(cs, cfg, mesh, packed, batch, topk, qparams, fuse_shards=True)


def _candidate_pool_step(cs, cfg, mesh, packed, batch, topk, qparams, fuse_shards):
    n_shards = mesh.shape[CAND_AXIS]
    n_trial = mesh.shape.get(TRIALS_AXIS, 1)
    n_cand = int(cfg["n_EI_candidates"])
    n_local = -(-n_cand // n_shards)
    k = int(min(topk, n_local))
    scored = tpe.build_propose_candidates(cs, dict(cfg, n_EI_candidates=n_local),
                                          qparams=qparams)
    single = batch is None
    B = 1 if single else int(batch)
    if not single and B % max(n_trial, 1):
        raise ValueError(f"batch={B} not divisible by the mesh's {n_trial} trial shards "
                         "(pad with rand.pad_ids_to_multiple)")
    eps = float(cfg.get("prior_eps", 0.0))
    prior = _prior_draws(cs) if eps > 0.0 else None
    n_groups = mesh.size // n_shards
    local = set(mesh.local())

    def shard_pool(history, keys, shards, dev, i):
        """Top-k (EI, value) of cand shards ``shards`` for ``keys[b, 2]``:
        ``{label: [b, len(shards) * k]}`` pairs, shards in order."""
        hist = entry_history(history, i, dev)
        keys = keys.to(dev)
        s_ids = torch.as_tensor(shards, dtype=torch.int64, device=dev)
        skeys = prng.fold_in(keys[None], s_ids[:, None])  # [S, b, 2]
        S, b = len(shards), keys.shape[0]
        out = scored(hist, skeys.reshape(S * b, 2))
        gidx = s_ids[:, None] * n_local + torch.arange(n_local, device=dev)  # [S, n]
        valid = (gidx < n_cand)[:, None, :]
        ei_k, val_k = {}, {}
        for l, (samples, ei) in out.items():
            ei = torch.where(valid, ei.reshape(S, b, n_local), -math.inf)
            top_ei, top_i = _stable_topk(ei, k)
            top_v = torch.gather(samples.reshape(S, b, n_local).to(torch.float32), -1, top_i)
            ei_k[l] = top_ei.permute(1, 0, 2).reshape(b, S * k)
            val_k[l] = top_v.permute(1, 0, 2).reshape(b, S * k)
        return ei_k, val_k

    def select(keys, ei_g, val_g):
        out = {}
        for l in cs.labels:
            k_l = prng.fold_in(keys, label_hash(l))
            v = tpe._select_candidate(k_l, val_g[l], ei_g[l], cfg)[0]
            if prior is not None:
                xp = prior[l](prng.fold_in(k_l, 0x9B10B))
                take = prng.uniform(prng.fold_in(k_l, 0xE9510), ()) < eps
                v = torch.where(take, xp.to(v.dtype), v)
            out[l] = v
        return out

    def propose(history, keys):
        if single:
            keys = keys[None]
        split = not single and n_trial > 1
        per = B // n_trial if split else B
        # a trials group owns its slice of the batch; unsplit, the first
        # group this process owns computes the whole batch
        owned = [t for t in range(n_groups)
                 if any(t * n_shards + s in local for s in range(n_shards))]
        home, groups = None, []
        for t in (owned if split else owned[:1]):
            lo, hi = (t * per, (t + 1) * per) if split else (0, B)
            entries = [t * n_shards + s for s in range(n_shards)]
            if fuse_shards:
                i = next(e for e in entries if e in local)
                pools = [shard_pool(history, keys[lo:hi], list(range(n_shards)),
                                    mesh.devices.flat[i], i)]
            else:
                if not all(e in local for e in entries):
                    raise ValueError("a trials group's cand shards must share a process")
                pools = [shard_pool(history, keys[lo:hi], [s], mesh.devices.flat[e], e)
                         for s, e in enumerate(entries)]
            home = home or mesh.devices.flat[entries[0]]
            ei_g = {l: torch.cat([p[0][l].to(home) for p in pools], -1) for l in cs.labels}
            val_g = {l: torch.cat([p[1][l].to(home) for p in pools], -1) for l in cs.labels}
            groups.append(select(keys[lo:hi].to(home), ei_g, val_g))
        out = {l: torch.cat([g[l] for g in groups]) for l in cs.labels}
        if single:
            if packed:
                return rand.pack_labels(cs, out)
            return {l: v[0] for l, v in out.items()}
        return rand.pack_labels(cs, out) if packed else out

    return propose
