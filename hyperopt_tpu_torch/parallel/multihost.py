"""Multi-process distribution on ``torch.distributed`` (counterpart of
``hyperopt_tpu/parallel/multihost.py``).

Every controller process runs the same program; :func:`initialize` joins
them into one process group, :func:`global_mesh` lays every process's
devices out as one mesh whose entries carry their owning rank, and
:func:`global_key_batch` gives each process the generation's keys with no
communication.  A process only ever touches its own devices: a sharded
step (``sharding.suggest_batch_sharded``) computes the entries this
process owns, and the driver exchanges the results.

The process group uses the **gloo** backend.  What crosses between
controllers is host data (packed proposals, result rows, checksums), as
in the JAX package, which exchanges host numpy arrays
(``process_allgather``); gloo moves CPU tensors and ships in every
PyTorch build.  It also lets two controllers share one card, which NCCL
refuses (two ranks on one GPU): that is how the multi-controller path runs
on a machine with a single card.  Every collective has the group's
timeout as its deadline.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch

from .. import prng
from ..obs.watchdog import beat as _wd_beat

__all__ = [
    "initialize",
    "is_initialized",
    "global_mesh",
    "global_key_batch",
    "replicate_global",
    "process_index",
    "process_count",
    "allgather",
]

_state = {"initialized": False, "devices": None}


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               local_device_ids=None, device=None, timeout=300.0, **kwargs):
    """Join (or form) the process group.  Idempotent.

    The arguments fall back to the environment variables the JAX package
    reads (``JAX_COORDINATOR_ADDRESS`` as ``host:port``,
    ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``); nothing here detects a
    cluster, so the address, the count and the rank must come from one or
    the other.  ``local_device_ids`` are the CUDA ordinals this process
    owns (default: every card it sees; two processes may name the same
    one); ``device="cpu"`` gives it the one CPU instead.  ``timeout``
    (seconds) bounds every collective of the group."""
    if _state["initialized"]:
        return
    import torch.distributed as dist

    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES") is not None:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID") is not None:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("multihost.initialize needs coordinator_address, num_processes "
                         "and process_id (or JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES "
                         "and JAX_PROCESS_ID)")
    if device is not None and torch.device(device).type == "cpu":
        devices = [torch.device("cpu")]
    else:
        from .._env import resolve_device

        resolve_device(device)  # without a card this raises
        ids = (range(torch.cuda.device_count()) if local_device_ids is None
               else local_device_ids)
        devices = [torch.device("cuda", int(i)) for i in ids]
    if not dist.is_initialized():
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes), rank=int(process_id),
                                timeout=datetime.timedelta(seconds=float(timeout)),
                                **kwargs)
    _state.update(initialized=True, devices=devices)


def is_initialized():
    return _state["initialized"]


def process_index():
    """This controller's rank (0 outside a process group)."""
    return torch.distributed.get_rank() if _state["initialized"] else 0


def process_count():
    """The number of controllers (1 outside a process group)."""
    return torch.distributed.get_world_size() if _state["initialized"] else 1


def allgather(arr):
    """Every process's host array ``arr`` (same shape and dtype on all),
    stacked in rank order: ``[process_count, *arr.shape]``.  One gloo
    all-gather of CPU tensors; an unsigned 64-bit array travels as its
    signed view."""
    import torch.distributed as dist

    arr = np.ascontiguousarray(arr)
    view = arr.view(np.int64) if arr.dtype == np.uint64 else arr
    t = torch.from_numpy(view.copy())
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    got = np.stack([o.numpy() for o in out])
    return got.view(np.uint64) if arr.dtype == np.uint64 else got


def global_mesh(n_cand_shards=1):
    """A ``(trials, cand)`` mesh over every process's devices, rank after
    rank, each entry owned by its process; the same on every process.
    Outside a process group it is the local mesh."""
    from . import sharding

    if not _state["initialized"]:
        return sharding.make_mesh(n_cand_shards=n_cand_shards)
    import torch.distributed as dist

    per_rank = [None] * process_count()
    dist.all_gather_object(per_rank, [str(d) for d in _state["devices"]])
    devs = [d for names in per_rank for d in names]
    ranks = [r for r, names in enumerate(per_rank) for _ in names]
    n = len(devs)
    if n % n_cand_shards:
        raise ValueError(f"{n} devices not divisible by n_cand_shards={n_cand_shards}")
    grid = np.empty((n // n_cand_shards, n_cand_shards), dtype=object)
    for i, d in enumerate(devs):
        grid.flat[i] = d
    return sharding.Mesh(grid, (sharding.TRIALS_AXIS, sharding.CAND_AXIS),
                         ranks=np.asarray(ranks).reshape(grid.shape), rank=process_index())


def _gather_parts(mesh):
    """The collective that completes a split leaf: every process sends its
    own entries' parts, and each gets every entry's part back."""
    local = mesh.local()
    ranks = [int(r) for r in mesh.ranks.flat]

    def gather(parts):
        mine = torch.stack([parts[i].cpu() for i in local])
        got = allgather(mine.numpy())
        full, seen = [], {}
        for r in ranks:
            k = seen.get(r, 0)
            seen[r] = k + 1
            full.append(torch.from_numpy(got[r][k]))
        return full

    return gather


def replicate_global(tree, mesh, spec=None, dtype=None):
    """Place a host-value dict tree on this process's entries of a
    (possibly multi-process) mesh: replicated by default, or split along
    the leading axis per ``spec`` (a ``sharding.PartitionSpec``).  The
    value must be the same on every process, which the driver's
    divergence checksum makes checkable.  ``dtype`` compresses float
    leaves.  Returns :class:`~.sharding.Placed` leaves; a split leaf
    completes itself by an all-gather when an entry needs the whole."""
    from . import sharding

    spec = sharding.P() if spec is None else spec
    gather = _gather_parts(mesh) if len(spec) else None

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        return sharding._place_leaf(np.asarray(x), spec, mesh, dtype, gather)

    # liveness marks: a placement on a multi-process mesh can wait on a peer
    _wd_beat("multihost.replicate", mark="pre")
    out = walk(tree)
    _wd_beat("multihost.replicate", mark="post")
    return out


def global_key_batch(seed, batch, mesh, axis=None):
    """The generation's ``[batch, 2]`` per-trial keys
    ``fold_in(PRNGKey(seed), index)``, on this process's first entry.  The
    key of a trial depends on its global index only, so every process
    builds the same array without communication; a sharded step takes the
    rows of the entries it owns.  ``axis`` is accepted for the JAX
    package's signature (the rows always split over the whole mesh)."""
    dev = mesh.devices.flat[mesh.local()[0]]
    idx = torch.arange(int(batch), dtype=torch.int64, device=dev)
    return prng.fold_in(prng.PRNGKey(int(seed), dev), idx)
