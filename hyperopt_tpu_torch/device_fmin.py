"""The on-device loop for objectives written in torch ops (counterpart of
``hyperopt_tpu/device_fmin.py``).

When the objective is torch math, one ask→tell step (draw from the prior
or fit the TPE posterior, propose, evaluate the objective, fold the trial
into the history) needs nothing from the host, so the whole chain runs on
the device.  The loop state is the padded history the host ``Trials``
keeps (per label ``vals``/``active``, ``losses``, ``has_loss``) at a fixed
capacity of ``max_evals``, so every step has the same shapes.

On a CUDA card each step is a replay of a captured CUDA graph: one graph
for a prior step and one for a TPE step (the JAX package's ``lax.cond``
branch is known on the host).  A graph reads and writes static buffers
(the loop state, a ``[cap, 2L+1]`` row buffer, a step counter and a key),
so a step is one graph launch in place of the ~1,660 launches of the
eager step, and its TPE step launches ``csrc/ei_diff.cu`` from inside the
graph.  The first step of each branch runs eagerly on a side stream (the
warm-up, which makes every cached constant the step reads) and the
branch is captured right after.  A failed capture or replay raises;
nothing falls back to an eager loop.  On the CPU the same step function
runs eagerly.

``fmin_device`` runs a whole run (the JAX package's one ``lax.scan``);
``DeviceLoopRunner`` runs chunks of ``CHUNK`` steps with one readback
each, behind ``fmin(device_loop=True | "auto")``.

Telemetry (the JAX package's compile/execute split): a branch's warm-up
and capture is the counterpart of XLA's compile, recorded as
``chunk.compile_sec`` (and a ``device.compile`` event in the run's
stream when the runner has a run bundle); a chunk's
``chunk.execute_sec`` is the device time of its replayed steps, from
CUDA events around each replay (the wall time on the CPU);
``chunk.flops`` / ``chunk.bytes`` are the analytic ``ei_diff`` cost of a
chunk of TPE steps (``obs/health.py``).  All in the process-global
``"device"`` metrics namespace, beside watchdog beats and, under an
armed capture plane, a ``device.chunk`` timeline annotation.
"""

from __future__ import annotations

import contextlib
import math
import threading
import time

import numpy as np
import torch

from . import megakernel, prng, quant
from ._env import not_ported, parse_hist_dtype, parse_shard, resolve_device
from .algos import tpe
from .base import trials_from_flat_history
from .obs import get_metrics
from .obs.devmem import register_owner
from .obs.watchdog import beat as _wd_beat
from .spaces import compile_space, draw_dist, label_hash
from .utils import LRUCache

__all__ = ["fmin_device", "DeviceLoopRunner", "objective_is_traceable", "loop_stats"]

# (kind, space expr, objective, capacity, n_startup, cfg, storage, device)
# -> a _Loop: its step, and on a card its captured graphs.  Expression
# trees are frozen dataclasses (hashable); objectives hash by identity.
_RUN_CACHE = LRUCache(16)

# the capture/execute split and the loop's kernel costs, process-global
# like the loop programs they describe
_METRICS = get_metrics("device")


def _int_labels(cs):
    """Labels evaluated as int32, by the rule of ``ParamInfo.is_int``, so
    the traced objective sees the types the host loop's docs deliver."""
    return {l for l, info in cs.params.items() if info.is_int}


def _flat_samplers(cs, cfg, with_tpe=True):
    """``(rand_flat, tpe_flat, typed)`` for a key ``[2]``: the prior draw
    of every label through ``draw_dist(dist, fold_in(key, label_hash(l)))``,
    the TPE proposal (``tpe.build_propose`` on keys ``[1, 2]``), both as
    float32 0-d tensors, and the evaluation types (integer labels rounded
    to int32).  ``with_tpe=False`` (a run that is all startup) makes
    ``tpe_flat`` the prior draw."""
    ints = _int_labels(cs)
    hashes = {l: label_hash(l) for l in cs.labels}

    def rand_flat(key):
        return {l: draw_dist(info.dist, prng.fold_in(key, hashes[l])).to(torch.float32)
                for l, info in cs.params.items()}

    if with_tpe:
        propose = tpe.build_propose(cs, cfg)

        def tpe_flat(history, key):
            return {l: v[0].to(torch.float32) for l, v in propose(history, key[None]).items()}
    else:
        def tpe_flat(history, key):
            return rand_flat(key)

    def typed(flat):
        return {l: torch.round(v).to(torch.int32) if l in ints else v
                for l, v in flat.items()}

    return rand_flat, tpe_flat, typed


def objective_is_traceable(domain):
    """True when the domain's objective, given the traced assemble of 0-d
    tensors on the ``meta`` device (int32 for integer labels, float32 for
    the rest), returns a 0-d floating tensor there: the counterpart of
    ``jax.eval_shape``, and the eligibility probe of ``fmin(...,
    device_loop=...)``.  Host math (``math.cos``, ``float()``, numpy, a
    branch on a value) needs the data, which meta tensors do not have, so
    it fails the probe; so does a constant tensor that does not follow the
    inputs' device."""
    if domain.pass_expr_memo_ctrl:
        return False
    cs = domain.cs
    ints = _int_labels(cs)
    flat = {l: torch.zeros((), dtype=torch.int32 if l in ints else torch.float32,
                           device="meta") for l in cs.labels}
    try:
        out = domain.fn(cs.assemble(flat, traced=True))
    except Exception:  # noqa: BLE001 - any failure means "not traceable"
        return False
    return (torch.is_tensor(out) and out.device.type == "meta" and out.dim() == 0
            and out.is_floating_point())


class _Loop:
    """One loop program: the ask→tell step of a (space, objective,
    capacity, startup count, cfg, storage type, device), with its key
    derivation: ``chain=True`` splits a running key each step
    (``fmin_device``), ``chain=False`` folds the step index into a base
    key (``DeviceLoopRunner``).  On a card it owns the static buffers and
    the captured graphs; :meth:`run` is serialized by a lock."""

    def __init__(self, cs, fn, cfg, n_startup, cap, dtype, device, chain):
        self.cs, self.fn = cs, fn
        self.cap, self.n_startup = int(cap), int(n_startup)
        self.dtype, self.device, self.chain = dtype, device, chain
        self.rand_flat, self.tpe_flat, self.typed = _flat_samplers(
            cs, cfg, with_tpe=self.n_startup < self.cap)
        self.graphs = {}        # branch -> torch.cuda.CUDAGraph
        self.kernel_nodes = {}  # branch -> ei_diff kernel nodes in its graph
        self.replays = {"prior": 0, "tpe": 0}
        self.capture_sec = {}   # branch -> warm-up step + capture, seconds
        self._static = None
        self._lock = threading.Lock()

    def new_state(self):
        """A fresh loop state ``(vals, active, losses, has_loss)`` on the
        loop's device: no trial, every loss +inf.  Its tensors count as
        ``history`` in the device-memory census."""
        cap, dev = self.cap, self.device
        state = ({l: torch.zeros(cap, dtype=self.dtype, device=dev) for l in self.cs.labels},
                 {l: torch.zeros(cap, dtype=torch.bool, device=dev) for l in self.cs.labels},
                 torch.full((cap,), math.inf, dtype=self.dtype, device=dev),
                 torch.zeros(cap, dtype=torch.bool, device=dev))
        register_owner("history", *state[0].values(), *state[1].values(), *state[2:])
        return state

    def _buffers(self, state):
        """``(state, rows[cap, 2L+1], counter[1], key[2])`` for steps on
        ``state`` itself (the eager path)."""
        return (state,
                torch.zeros((self.cap, 2 * len(self.cs.labels) + 1), dtype=torch.float32,
                            device=self.device),
                torch.zeros(1, dtype=torch.int64, device=self.device),
                torch.zeros(2, dtype=torch.int64, device=self.device))

    def step(self, bufs, branch):
        """One ask→tell step on ``bufs``: derive the step's key, draw
        (``branch`` "prior") or propose ("tpe"), evaluate the objective on
        the traced assemble, write the trial into slot ``counter`` of the
        state and its ``[2L+1]`` row (flat values, active masks, the raw
        loss) into the row buffer, and advance the counter.  Every value
        stays on the device."""
        (vals, active, losses, has_loss), rows, i, key = bufs
        if self.chain:
            ks = prng.split(key)
            key.copy_(ks[0])
            k = ks[1]
        else:
            k = prng.fold_in(key, i[0])
        if branch == "prior":
            flat = self.rand_flat(k)
        else:
            history = {"losses": losses, "has_loss": has_loss, "vals": vals, "active": active}
            flat = self.tpe_flat(history, k)
        tflat = self.typed(flat)
        act = {l: (a if torch.is_tensor(a) else torch.full((), bool(a), device=self.device))
               for l, a in self.cs.active_flat(tflat).items()}
        loss = self.fn(self.cs.assemble(tflat, traced=True))
        if not torch.is_tensor(loss):
            raise TypeError("the device loop's objective must return a tensor (torch ops "
                            f"on the flat sample's tensors), got {type(loss).__name__}")
        loss = loss.to(torch.float32).reshape(())
        ok = torch.isfinite(loss)
        labels = self.cs.labels
        for l in labels:
            vals[l].index_copy_(0, i, flat[l].reshape(1).to(vals[l].dtype))
            active[l].index_copy_(0, i, act[l].reshape(1))
        losses.index_copy_(0, i, torch.where(ok, loss, math.inf).reshape(1).to(losses.dtype))
        has_loss.index_copy_(0, i, ok.reshape(1))
        row = torch.cat([torch.stack([flat[l] for l in labels]),
                         torch.stack([act[l].to(torch.float32) for l in labels]),
                         loss.reshape(1)])
        rows.index_copy_(0, i, row[None])
        i.add_(1)

    def _capture(self, branch, bufs):
        """The first step of ``branch``: run it eagerly on a side stream
        (the warm-up: every cached constant it reads is made now), then
        capture the same step into a CUDA graph.  Raises if the capture
        fails (a copy from the host, a synchronization, a read-back)."""
        t0 = time.perf_counter()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.step(bufs, branch)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = megakernel.ei_diff.captures
        with torch.cuda.graph(graph):
            self.step(bufs, branch)
        self.kernel_nodes[branch] = megakernel.ei_diff.captures - before
        self.graphs[branch] = graph
        torch.cuda.synchronize(self.device)
        self.capture_sec[branch] = time.perf_counter() - t0

    def _replay(self, branch, events=None):
        if events is None:
            self.graphs[branch].replay()
        else:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            self.graphs[branch].replay()
            t1.record()
            events.append((t0, t1))
        self.replays[branch] += 1
        megakernel.ei_diff.graph_launches += self.kernel_nodes[branch]

    def run(self, state, key, start, limit, capture=True, events=None):
        """Steps ``start .. limit-1`` on ``state`` (updated in place) from
        the ``[2]`` key ``key`` (the base key, or the first key of a chain;
        it is read, not written); returns the ``[limit-start, 2L+1]`` rows
        as one host array.  On a card with ``capture`` the
        steps are graph replays on the loop's static buffers, between
        which ``state`` is copied in and out; ``capture=False`` runs the
        step eagerly (the reference the replays are held to).  ``events``
        (a list) collects a pair of CUDA events around each replay."""
        graphs = capture and self.device.type == "cuda"
        with self._lock, (torch.cuda.device(self.device) if graphs
                          else contextlib.nullcontext()):
            if graphs:
                if self._static is None:
                    self._static = self._buffers(self.new_state())
                    register_owner("history", self._static[1])
                bufs = self._static
                _copy_state(bufs[0], state)
            else:
                bufs = self._buffers(state)
            bufs[2].fill_(start)
            bufs[3].copy_(key)
            for j in range(start, limit):
                branch = "prior" if j < self.n_startup else "tpe"
                if not graphs:
                    self.step(bufs, branch)
                elif branch in self.graphs:
                    self._replay(branch, events)
                else:
                    self._capture(branch, bufs)
            if graphs:
                _copy_state(state, bufs[0])
            return bufs[1][start:limit].cpu().numpy()

    def stats(self):
        return {"kind": "whole_run" if self.chain else "chunk", "cap": self.cap,
                "n_startup": self.n_startup, "device": str(self.device),
                "replays": dict(self.replays), "ei_diff_nodes": dict(self.kernel_nodes),
                "capture_sec": dict(self.capture_sec)}


def _copy_state(dst, src):
    """Copy one loop state into another of the same shapes, in place."""
    for d, s in zip(dst[:2], src[:2]):
        for l in d:
            d[l].copy_(s[l])
    dst[2].copy_(src[2])
    dst[3].copy_(src[3])


def _get_loop(kind, cs, fn, cfg, n_startup, cap, dtype, device):
    key = (kind, cs.expr, fn, int(cap), int(n_startup), tuple(sorted(cfg.items())),
           dtype, device)
    loop = _RUN_CACHE.get(key)
    if loop is None:
        loop = _Loop(cs, fn, cfg, n_startup, cap, dtype, device, chain=kind == "whole_run")
        _RUN_CACHE.put(key, loop)
    return loop


def loop_stats():
    """Per cached loop program: its kind (``whole_run`` or ``chunk``),
    capacity, startup count, device, graph replays per branch, ``ei_diff``
    kernel nodes per graph and capture seconds (warm-up step included)."""
    return [loop.stats() for loop in _RUN_CACHE.values()]


class DeviceLoopRunner:
    """Chunked device stepper: ``CHUNK`` sequential fresh-posterior
    ask→tell steps per call, for the standard interactive ``fmin`` loop.

    Every proposal sees the previous trial's loss, as in the host loop,
    but the host reads back one ``[k, 2L+1]`` array per chunk instead of
    one proposal per trial, and on a card each step is one graph replay.
    Between chunks control returns to the host, so ``fmin``'s timeout,
    early stop, loss threshold and checkpointing work at chunk
    granularity.  The loop state is held in ``HYPEROPT_TPU_HIST_DTYPE``'s
    float type (int8/fp8 degrade to bf16: the state is stored by a plain
    cast).  ``capture=False`` runs the steps eagerly on the card too.

    Under ``HYPEROPT_TPU_SHARD`` the loop runs unsharded unless the
    capacity would split over the suggest mesh
    (``sharding.should_shard_history``: two or more devices and a cap past
    ``HYPEROPT_TPU_HIST_SHARD_MIN``), which is not ported yet (item 12b)."""

    CHUNK = 10

    def __init__(self, domain, cfg, n_startup, cap, device=None, capture=True, obs=None):
        cs = domain.cs
        self._obs = obs
        self.cs = cs
        self.cap = int(cap)
        self.labels = cs.labels
        self.device = resolve_device(device)
        if parse_shard() is not None:
            from .parallel import sharding

            mesh = sharding.suggest_mesh(parse_shard(), device=self.device)
            if sharding.should_shard_history(self.cap, mesh):
                raise not_ported("a capacity-sharded device loop", "12b")
        self.hist_dtype = quant.mirror_float_dtype(parse_hist_dtype())
        self.capture = bool(capture)
        # the loop program is shared by runner instances: a warm rerun of
        # the same (space, objective, cap, cfg) does not recapture
        self._loop = _get_loop("chunk", cs, domain.fn, cfg, n_startup, self.cap,
                               self.hist_dtype, self.device)
        self._n_startup = int(n_startup)
        self._cost_cfg = cfg  # until the chunk cost is recorded, once

    def init_state(self):
        """A fresh ``(vals, active, losses, has_loss)`` loop state."""
        return self._loop.new_state()

    def run_chunk(self, state, start, limit, seed):
        """Run steps ``start .. limit-1`` with step ``i``'s key
        ``fold_in(fold_in(PRNGKey(lo), hi), i)`` (``lo``/``hi`` the words
        of ``seed``); returns ``(state, rows[limit-start, 2L+1])``, the
        state updated in place and the rows on the host (the one
        readback)."""
        lo, hi = prng.seed_words(seed)
        base = prng.fold_in(prng.PRNGKey(lo, self.device), hi)
        obs = self._obs
        loop = self._loop
        if limit > self._n_startup and self._cost_cfg is not None:
            # the analytic cost of a chunk of TPE steps (CHUNK ticks of one
            # key over capacity cap)
            from .obs import health

            shapes = tpe._get_propose(self.cs, self._cost_cfg).ei_shapes(1, self.cap)
            ops, nbytes = health.ei_launch_cost(shapes)
            health.record_program_cost("chunk", ops * self.CHUNK, nbytes * self.CHUNK,
                                       _METRICS)
            self._cost_cfg = None
        captured = set(loop.graphs)
        events = [] if self.device.type == "cuda" and self.capture else None
        # execute-boundary beats: a quiet period after "pre" that never
        # reaches "post" is a hung replay or read-back
        _wd_beat("device.execute", stage="chunk", start=int(start), mark="pre")
        ann = (obs.annotate("device.chunk", step=int(start), start=int(start),
                            limit=int(limit)) if obs is not None else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ann:
            rows = loop.run(state, base, int(start), int(limit), capture=self.capture,
                            events=events)
        wall = time.perf_counter() - t0
        for branch in set(loop.graphs) - captured:
            # a branch's warm-up and capture: the counterpart of XLA's compile
            _METRICS.histogram("chunk.compile_sec").observe(loop.capture_sec[branch])
            if obs is not None:
                obs.event("device.compile", branch=branch, sec=loop.capture_sec[branch])
        if events is None:
            sec = wall
        else:  # the rows' read-back synchronized the card: the events are done
            sec = sum(a.elapsed_time(b) for a, b in events) / 1e3
        _METRICS.histogram("chunk.execute_sec").observe(sec)
        _METRICS.counter("chunk.dispatches").inc()
        _wd_beat("device.execute", stage="chunk", start=int(start), mark="post")
        return state, rows


def fmin_device(
    fn,
    space,
    max_evals,
    seed=0,
    n_startup_jobs=tpe._default_n_startup_jobs,
    n_EI_candidates=tpe._default_n_EI_candidates,
    gamma=tpe._default_gamma,
    linear_forgetting=tpe._default_linear_forgetting,
    prior_weight=tpe._default_prior_weight,
    return_trials=False,
    device=None,
):
    """Minimize ``fn`` over ``space`` entirely on the device.

    ``fn`` receives the traced assemble of the flat sample (0-d tensors;
    choices select on the device) and returns a 0-d loss tensor.  The key
    is ``PRNGKey(seed)`` (or ``seed`` itself, a ``[2]`` key tensor) and
    each step splits it: ``key, k = split(key)``.
    Runs on the CUDA card (one graph replay per step) unless ``device``
    says otherwise.  Returns ``(best_flat, best_loss)``, or with
    ``return_trials=True`` a reference-shaped ``Trials`` on ``device``
    with every trial as a document."""
    dev = resolve_device(device)
    cs = compile_space(space)
    cap = int(max_evals)
    cfg = {
        "prior_weight": float(prior_weight),
        "n_EI_candidates": int(n_EI_candidates),
        "gamma": float(gamma),
        "LF": int(linear_forgetting),
    }
    loop = _get_loop("whole_run", cs, fn, cfg, int(n_startup_jobs), cap, torch.float32, dev)
    state = loop.new_state()
    key = (seed.to(device=dev, dtype=torch.int64) if torch.is_tensor(seed)
           else prng.PRNGKey(int(seed), dev))
    loop.run(state, key, 0, cap)

    vals = {l: v.cpu().numpy() for l, v in state[0].items()}
    active = {l: v.cpu().numpy() for l, v in state[1].items()}
    losses = state[2].cpu().numpy()
    best_i = int(np.argmin(losses))
    best_flat = {
        l: (int(round(float(vals[l][best_i]))) if cs.params[l].is_int
            else float(vals[l][best_i]))
        for l in cs.labels
        if active[l][best_i]
    }
    best_loss = float(losses[best_i])
    if not return_trials:
        return best_flat, best_loss
    return trials_from_flat_history(cs, vals, active, losses, "device_fmin", device=dev)
