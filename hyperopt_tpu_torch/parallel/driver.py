"""End-to-end multi-controller fmin (counterpart of
``hyperopt_tpu/parallel/driver.py``): the whole ask→tell loop run by every
controller process of a ``torch.distributed`` group.

Every controller runs this same driver; there is no coordinator beyond the
process group.  Per generation:

1. **Propose globally**: one batch of ``B`` proposals from the shared TPE
   posterior, each controller proposing the rows of the global mesh's
   entries it owns (``sharding.suggest_batch_sharded``; history
   replicated, or split along its capacity axis past
   ``HYPEROPT_TPU_HIST_SHARD_MIN``), then one all-gather of the packed
   ``[B, L]`` rows.  Proposals are deterministic in ``(seed, global trial
   id, history)``, so every controller holds the same batch.
2. **Shard evaluation**: controller ``p`` evaluates trials ``j`` with
   ``j % P == p``.
3. **Fold deterministically**: the controllers' results (one lean wire
   buffer each, ``payload``) are all-gathered and folded into the padded
   history in global trial-id order, so every controller assembles the
   same history bit for bit.
4. **Divergence checksum**: a digest of the folded rows is all-gathered
   and compared; a mismatch raises :class:`ControllerDivergence` on every
   controller.

The loop is deterministic in ``(seed, batch, max_evals)`` and independent
of the process count: ``fmin_multihost(..., _force_single=True)`` runs the
same algorithm in one process, and a two-process run gives its checksum.
Checkpoints are the JAX package's pickles (numpy arrays and the run
parameters), so either package resumes the other's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
import threading
import time

import numpy as np
import torch

from .. import chaos, prng, quant
from .._env import (parse_allgather_timeout, parse_hist_dtype,
                    resolve_device)
from ..algos import tpe
from ..exceptions import AllTrialsFailed, FleetDegraded
from ..obs import ObsConfig, RunObs
from ..obs.health import controller_stream_path
from ..spaces import compile_space
from . import multihost, sharding
from . import payload as payload_mod

__all__ = ["fmin_multihost", "MultihostResult", "ControllerDivergence", "FleetDegraded"]


class ControllerDivergence(RuntimeError):
    """Controllers assembled different global histories (nondeterministic
    objective or corrupt replication): the optimization state is no longer
    the same across processes."""


@dataclasses.dataclass
class MultihostResult:
    """What every controller returns (the same on all of them)."""

    best: dict            # structured best sample (space_eval form)
    best_loss: float
    n_evals: int
    losses: np.ndarray    # [n_evals] in global trial-id order
    vals: dict            # {label: np.ndarray[n_evals]} flat history
    checksum: str         # digest of the folded history (divergence guard)
    active: dict = dataclasses.field(repr=False)  # {label: bool[n_evals]}
    _cs: object = dataclasses.field(repr=False)   # CompiledSpace of the run
    _device: object = dataclasses.field(default=None, repr=False)

    def to_trials(self, device=None):
        """The run as a reference-shaped ``Trials`` on ``device`` (default:
        the run's): every trial a DONE document with sparse idxs/vals,
        inactive conditional params empty."""
        from ..base import trials_from_flat_history

        return trials_from_flat_history(self._cs, self.vals, self.active, self.losses,
                                        "fmin_multihost",
                                        device=device if device is not None else self._device)


def _controller_port(port, pid):
    """Per-controller scrape port: an explicit base port plus the process
    index; 0 stays 0 (each controller binds its own ephemeral port).
    ``host:port`` keeps the host and offsets the port; a malformed value
    passes through and fails open at bind time (``obs/serve.py``)."""
    if not port:
        return port
    try:
        if isinstance(port, str) and ":" in port:
            host, _, base = port.rpartition(":")
            if int(base) == 0:
                return port
            return f"{host}:{int(base) + int(pid)}"
        return int(port) + int(pid)
    except (TypeError, ValueError):
        return port


def _controller_obs(obs, pid, P):
    """The run bundle of controller ``pid`` of ``P``: with more than one
    controller every stream, flight dump and scrape port is split per
    controller (``run.jsonl`` → ``run.p<i>.jsonl``, the port offset by the
    index, the run id tagged ``-p<i>``); ``obs.report --merge`` renders
    the streams together.  A pre-built ``RunObs`` is rebuilt from its
    config with the split paths after its own hooks are released."""
    if isinstance(obs, RunObs) and P > 1 and (
            obs.config.jsonl_path or obs.config.flight_path
            or obs.config.http_port or obs.config.devmem_period is not None):
        # N controllers appending to one stream would interleave records
        # under one run id, and N crash dumps would clobber one file
        if obs.http is not None:
            obs.http.stop()
        if obs.devmem is not None:
            obs.devmem.stop()
        if obs._flight_target is not None:
            obs.flight.remove_target(obs._flight_target)
        elif obs.config.flight_path:
            obs.flight.remove_target(obs.config.flight_path)
        if obs.watchdog is not None:
            obs.watchdog.detach_sink(obs.sink)
            obs.watchdog.release()
        return RunObs(
            dataclasses.replace(
                obs.config,
                jsonl_path=(controller_stream_path(obs.config.jsonl_path, pid)
                            if obs.config.jsonl_path else None),
                flight_path=(controller_stream_path(obs.config.flight_path, pid)
                             if obs.config.flight_path else None),
                http_port=_controller_port(obs.config.http_port, pid)),
            run_id=f"{obs.run_id}-p{pid}")
    if isinstance(obs, RunObs):
        return obs
    config = ObsConfig.resolve(obs)
    if P > 1:
        config = dataclasses.replace(
            config, http_port=_controller_port(config.http_port, pid),
            jsonl_path=(controller_stream_path(config.jsonl_path, pid)
                        if config.jsonl_path else None),
            flight_path=(controller_stream_path(config.flight_path, pid)
                         if config.flight_path else None))
    run_id = f"{config.run_id or 'mh'}-p{pid}" if P > 1 else None
    return RunObs(config, run_id=run_id)


def _pop_compile_cache(cfg):
    """``cfg`` without its ``"compile_cache"`` entry, which (like
    ``fmin(compile_cache=...)``) names the directory the kernel libraries
    are built and loaded in, for this process; it is no run parameter."""
    cfg = dict(cfg or {})
    cache = cfg.pop("compile_cache", None)
    if cache is not None:
        from .._build import set_build_dir

        set_build_dir(cache)
    return cfg


def _default_cfg(batch):
    cfg = {"prior_weight": 1.0, "n_EI_candidates": 64, "gamma": 1.0, "LF": 100}
    if batch > 1:
        # wide shared-posterior batches need diversity-preserving selection
        # (tpe._select_candidate)
        cfg.update(ei_select="softmax", ei_tau=0.5, prior_eps=0.1)
    return cfg


def _gen_seed(seed, gen):
    """Per-generation base seed, deterministic in (seed, gen)."""
    return (int(seed) + 0x9E3779B1 * (gen + 1)) & 0xFFFFFFFF


def _digest_generation(digest, labels, flats, losses, B):
    """Advance the divergence digest by one generation's rows: per trial,
    the float32 raw loss then each label's float32 value, in global
    trial-id order.  The collective fold, the fleet fold and the
    checkpoint replay all write these bytes (the replay as the row-major
    ``[n, 1+L]`` float32 matrix), so their checksums compare bit for bit."""
    for j in range(B):
        digest.update(np.float32(losses[j]).tobytes())
        digest.update(b"".join(np.float32(flats[l][j]).tobytes() for l in labels))


def _timed_gather(fn, timeout, what, obs, on_timeout):
    """Run one collective under a monotonic deadline; ``timeout=None``
    calls it directly (no thread).

    With a timeout the collective runs on a daemon thread.  Past the
    deadline the peer is presumed dead or partitioned: ``on_timeout()``
    checkpoints the last verified generation (it returns whether it wrote
    one) and :class:`FleetDegraded` tells the operator to restart the
    surviving fleet, which resumes bit for bit at any size.  The blocked
    thread is left behind: only the peer that will not arrive could free
    it, and the process is about to exit on the raise."""
    if timeout is None:
        return fn()
    box = {}
    done = threading.Event()

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # surfaced on the caller's thread
            box["err"] = e
        finally:
            done.set()

    threading.Thread(target=run, name="hyperopt-allgather", daemon=True).start()
    if not done.wait(timeout):
        obs.event("allgather_timeout", point=what, timeout_sec=timeout)
        obs.counter("allgather.timeouts").inc()
        ckpt = False
        try:
            ckpt = bool(on_timeout())
        except Exception:
            pass  # best-effort checkpoint: the raise below must win
        raise FleetDegraded(
            f"collective '{what}' did not complete within {timeout:.0f}s — "
            "a controller is dead or partitioned; "
            + ("the last verified generation is checkpointed: restart the "
               "surviving fleet (any size) with the same checkpoint_file "
               "to resume bitwise" if ckpt else
               "NO checkpoint was written (no checkpoint_file configured, "
               "or the run already resumed from the one on disk) — restart "
               "the fleet from its last durable state"))
    if "err" in box:
        raise box["err"]
    return box["out"]


def _load_checkpoint(checkpoint_file, run_params, batch, max_evals, obs, exact=True):
    """The saved state of ``checkpoint_file`` (None when absent), checked
    against this run's parameters."""
    if checkpoint_file is None or not os.path.exists(checkpoint_file):
        return None
    # trust boundary: a checkpoint is a pickle, as trials_save_file is
    t0 = time.perf_counter()
    with open(checkpoint_file, "rb") as f:
        saved = pickle.load(f)
    obs.histogram("checkpoint.load_sec").observe(time.perf_counter() - t0)
    for k, v in run_params.items():
        have = saved["run_params"][k] if exact else saved["run_params"].get(k)
        if have != v:
            raise ValueError(
                f"checkpoint {checkpoint_file} was written with {k}={have!r}; this run "
                f"has {k}={v!r} — bitwise resume requires identical run parameters")
    if saved["n_done"] % batch and saved["n_done"] < max_evals:
        raise ValueError(
            f"checkpoint ends in a partial final generation (n_done={saved['n_done']}, "
            f"batch={batch}): the original run completed at its own max_evals, and a "
            "completed run cannot be extended bitwise — delete the checkpoint to start "
            "a fresh run")
    return saved


def _new_history(labels, max_evals, saved):
    """The padded numpy history (power-of-two cap, at least 128) and the
    raw-loss column, with ``saved``'s rows restored, plus the digest
    replayed over them and the trials done."""
    cap = 128
    while cap < max(max_evals, saved["n_done"] if saved else 0):
        cap *= 2
    hist = {"losses": np.full(cap, np.inf, np.float32), "has_loss": np.zeros(cap, bool),
            "vals": {l: np.zeros(cap, np.float32) for l in labels},
            "active": {l: np.zeros(cap, bool) for l in labels}}
    # raw losses as evaluated (NaN for raised trials): the digest folds
    # these, and the checkpoint replays them bit for bit
    raw_losses = np.full(cap, np.nan, np.float32)
    digest = hashlib.sha256()
    n_done = 0
    if saved is not None:
        n_done = saved["n_done"]
        hist["losses"][:n_done] = saved["losses"]
        hist["has_loss"][:n_done] = saved["has_loss"]
        raw_losses[:n_done] = saved["raw_losses"]
        for l in labels:
            hist["vals"][l][:n_done] = saved["vals"][l]
            hist["active"][l][:n_done] = saved["active"][l]
        if n_done:
            rows = np.concatenate(
                [np.asarray(saved["raw_losses"], np.float32)[:, None]]
                + [np.asarray(saved["vals"][l], np.float32)[:, None] for l in labels], axis=1)
            digest.update(np.ascontiguousarray(rows, np.float32).tobytes())
    return hist, raw_losses, digest, n_done


def _checkpoint_state(run_params, hist, raw_losses, labels, n):
    return {"run_params": run_params, "n_done": n,
            "losses": hist["losses"][:n].copy(), "has_loss": hist["has_loss"][:n].copy(),
            "raw_losses": raw_losses[:n].copy(),
            "vals": {l: hist["vals"][l][:n].copy() for l in labels},
            "active": {l: hist["active"][l][:n].copy() for l in labels}}


def _evaluate(fn, cs, flats, js, obs, on_trial=None):
    """Evaluate the batch positions ``js``: (raw losses f32, active rows)."""
    labels = cs.labels
    losses = np.full(len(js), np.nan, np.float32)
    active = np.zeros((len(js), len(labels)), bool)
    for k, j in enumerate(js):
        if on_trial is not None:
            on_trial(k)
        flat = {l: (int(round(float(flats[l][j]))) if cs.params[l].is_int
                    else float(flats[l][j])) for l in labels}
        act = cs.active_flat(flat)
        active[k] = [bool(act[l]) for l in labels]
        try:
            losses[k] = float(fn(cs.assemble(flat)))
        except Exception:
            losses[k] = np.nan  # a failed trial: no loss
            obs.counter("trials.failed").inc()
    return losses, active


def _result(cs, hist, digest, n_done, device):
    live = hist["has_loss"][:n_done]
    losses_all = hist["losses"][:n_done]
    if not live.any():
        raise AllTrialsFailed(f"all {n_done} trials failed (objective raised on every call)")
    best_i = int(np.argmin(np.where(live, losses_all, np.inf)))
    best_flat = {l: (int(round(float(hist["vals"][l][best_i]))) if cs.params[l].is_int
                     else float(hist["vals"][l][best_i])) for l in cs.labels}
    return MultihostResult(
        best=cs.assemble(best_flat), best_loss=float(losses_all[best_i]), n_evals=n_done,
        losses=losses_all.copy(), vals={l: hist["vals"][l][:n_done].copy() for l in cs.labels},
        checksum=digest.hexdigest(),
        active={l: hist["active"][l][:n_done].copy() for l in cs.labels},
        _cs=cs, _device=device)


def _host(t):
    return t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def fmin_multihost(fn, space, max_evals, batch=None, seed=0, cfg=None, n_startup=None,
                   checkpoint_file=None, obs=None, _force_single=False, fleet_dir=None,
                   n_shards=None, lease_ttl=15.0, allgather_timeout=None, device=None):
    """Minimize ``fn`` over ``space`` across every controller of the
    process group (``multihost.initialize``).  Call from all controllers
    with the same arguments; each returns the same
    :class:`MultihostResult`.

    ``fn`` takes the structured sample (the reference's objective).
    ``batch`` proposals are issued per generation (default: one per mesh
    entry).  ``_force_single`` runs the same algorithm in this process
    alone: the result a multi-process run must equal.  Without a process
    group the run is single.  ``device`` is where a single run proposes
    (the CUDA card unless ``"cpu"``); a multi-process run proposes on the
    devices each controller gave ``multihost.initialize``.

    ``checkpoint_file``: persist the folded history after every verified
    generation (controller 0 writes, atomically) and resume from it on
    restart; the resumed run continues the trial sequence of an
    uninterrupted one, checksum included.  Checkpoints are pickles: a
    tampered file executes code on load, so keep its directory writable
    by the controllers only.

    ``fleet_dir``: run as one controller of an elastic fleet instead
    (``fleet.fleet_fmin``): generation shards leased from a shared
    directory, controllers joining and leaving at will, ``n_shards`` work
    shards per generation, stale leases reclaimed after ``lease_ttl``
    seconds.

    ``allgather_timeout`` (or ``HYPEROPT_TPU_ALLGATHER_TIMEOUT``): a
    deadline on every collective; past it the driver checkpoints the last
    verified generation and raises :class:`FleetDegraded`.

    ``obs``: the run's telemetry, as ``fmin``'s (None: the environment;
    a path; an ``ObsConfig`` or ``RunObs``).  With more than one
    controller each writes its own ``run.p<i>.jsonl`` and serves its own
    port (the base port plus its index); render them together with
    ``python -m hyperopt_tpu_torch.obs.report --merge run.p0.jsonl
    run.p1.jsonl``.  ``cfg["compile_cache"]`` names the directory the
    kernel libraries are built and loaded in."""
    cfg = _pop_compile_cache(cfg)
    if fleet_dir is not None:
        from .fleet import fleet_fmin

        return fleet_fmin(fn, space, max_evals, fleet_dir, batch=batch, seed=seed, cfg=cfg,
                          n_startup=n_startup, n_shards=n_shards, lease_ttl=lease_ttl,
                          checkpoint_file=checkpoint_file, obs=obs, device=device)
    if allgather_timeout is None:
        allgather_timeout = parse_allgather_timeout()
    single = _force_single or multihost.process_count() == 1
    pid, P = (0, 1) if single else (multihost.process_index(), multihost.process_count())
    if single:
        device = resolve_device(device)  # without a card this raises here
    run = _controller_obs(obs, pid, P)
    try:
        # this thread proposes: it serves the capture plane at generation
        # boundaries
        with run.profiler_ctx(), run.loop():
            out = _collective(fn, space, max_evals, batch, seed, cfg, n_startup,
                              checkpoint_file, single, pid, P, allgather_timeout, device, run)
    finally:
        run.finish()
    return out


def _collective(fn, space, max_evals, batch, seed, cfg, n_startup, checkpoint_file, single,
                pid, P, allgather_timeout, device, obs):
    if P > 1:
        obs.event("controller", pid=pid, n_processes=P)
    cs = compile_space(space)
    labels = cs.labels
    L_n = len(labels)
    if single:
        dev, mesh = device, None
    else:
        mesh = multihost.global_mesh()
        dev = mesh.devices.flat[mesh.local()[0]]
    if batch is None:
        batch = mesh.size if mesh is not None else len(sharding.local_devices(dev))
    cfg = dict(_default_cfg(batch), **dict(cfg or {}))
    if n_startup is None:
        n_startup = max(batch, 20)
    # a bitwise resume needs the same run parameters: generation seeds
    # depend on (seed, gen), boundaries on batch, the startup switch on
    # n_startup, the proposals on cfg
    run_params = {"labels": list(labels), "batch": int(batch), "seed": int(seed),
                  "n_startup": int(n_startup), "cfg": sorted(cfg.items())}
    saved = _load_checkpoint(checkpoint_file, run_params, batch, max_evals, obs)
    hist, raw_losses, digest, n_done = _new_history(labels, max_evals, saved)
    cap = len(raw_losses)
    gen = n_done // batch

    # the device mirror's storage: bf16 halves it; int8/fp8 degrade to
    # bf16 here (the fold stores by a plain cast); the host history, the
    # checkpoint and the digest stay float32
    hist_dtype = quant.mirror_float_dtype(parse_hist_dtype())
    if single:
        shard_hist = False
        propose_fn = tpe.build_propose(cs, cfg)
    else:
        # past the threshold the history's capacity axis splits over the
        # global mesh (each entry then holds cap / n rows)
        shard_hist = sharding.should_shard_history(cap, mesh)
        propose_sharded = sharding.suggest_batch_sharded(cs, cfg, mesh, packed=True,
                                                         shard_history=shard_hist)
        obs.gauge("suggest.shards").set(mesh.size)
        obs.gauge("suggest.hist_sharded").set(int(shard_hist))

    # the device-resident history mirror: uploaded once, then advanced per
    # generation by an in-place fold of that generation's rows
    # (sharding.build_history_fold); the numpy `hist` stays the source of
    # truth the checkpoint is written from
    mirror = {"dev": None, "synced": 0}
    fold = sharding.build_history_fold(labels, mesh=mesh, shard_history=shard_hist)
    wire_fmt = payload_mod.wire_format()

    def device_history(n_now):
        if mirror["dev"] is not None and mirror["synced"] < n_now:
            s, e = mirror["synced"], n_now
            k = e - s  # at most one generation
            vals_rows = np.zeros((batch, L_n), np.float32)
            act_rows = np.zeros((batch, L_n), bool)
            lo = np.zeros(batch, np.float32)
            hl = np.zeros(batch, bool)
            idx = np.full(batch, cap, np.int64)  # padding: dropped
            for j, l in enumerate(labels):
                vals_rows[:k, j] = hist["vals"][l][s:e]
                act_rows[:k, j] = hist["active"][l][s:e]
            lo[:k] = hist["losses"][s:e]
            hl[:k] = hist["has_loss"][s:e]
            idx[:k] = np.arange(s, e)
            mirror["dev"] = fold(mirror["dev"], vals_rows, act_rows, lo, hl, idx)
            mirror["synced"] = e
            obs.counter("mirror.incremental_folds").inc()
        if mirror["dev"] is None:
            if single:
                def up(x):
                    t = torch.tensor(x, device=dev)
                    return t.to(hist_dtype) if t.is_floating_point() else t

                mirror["dev"] = {"losses": up(hist["losses"]), "has_loss": up(hist["has_loss"]),
                                 "vals": {l: up(v) for l, v in hist["vals"].items()},
                                 "active": {l: up(v) for l, v in hist["active"].items()}}
            else:
                spec = (sharding.P((sharding.TRIALS_AXIS, sharding.CAND_AXIS))
                        if shard_hist else None)
                mirror["dev"] = multihost.replicate_global(hist, mesh, spec=spec,
                                                           dtype=hist_dtype)
            mirror["synced"] = n_now
            obs.counter("mirror.full_uploads").inc()
        return mirror["dev"]

    def local_keys(gseed):
        idx = torch.arange(batch, dtype=torch.int64, device=dev)
        return prng.fold_in(prng.PRNGKey(gseed, dev), idx)

    def gather_packed(mat):
        """This controller's packed ``[B_local, L]`` proposal rows → the
        whole batch's per-label host arrays, by one all-gather."""
        obs.heartbeat("driver.allgather", point="proposals", mark="pre")
        chaos.point("allgather", metrics=obs.metrics)
        t0 = time.perf_counter()
        mine = _host(mat).astype(np.float32)
        full = np.asarray(_timed_gather(
            lambda: multihost.allgather(mine), allgather_timeout, "proposals", obs,
            lambda: _save_checkpoint(force=True))).reshape(batch, L_n)
        obs.histogram("allgather.proposals_sec").observe(time.perf_counter() - t0)
        obs.heartbeat("driver.allgather", point="proposals", mark="post")
        return {l: full[:, j] for j, l in enumerate(labels)}

    if not single and checkpoint_file is not None:
        # resume agreement: controller 0 alone writes the checkpoint, so a
        # per-host disk could hand controllers different resume points and
        # mismatched collective schedules; fail loudly instead
        obs.counter("resume_agreement_checks").inc()
        obs.heartbeat("driver.allgather", point="resume", mark="pre")
        chaos.point("allgather", metrics=obs.metrics)
        t0 = time.perf_counter()
        state8 = np.frombuffer(digest.digest()[:8], np.uint64)[0]
        mine = np.asarray([n_done, state8], np.uint64)
        all_s = np.asarray(_timed_gather(lambda: multihost.allgather(mine), allgather_timeout,
                                         "resume", obs, lambda: None)).reshape(P, 2)
        obs.histogram("allgather.resume_sec").observe(time.perf_counter() - t0)
        obs.heartbeat("driver.allgather", point="resume", mark="post")
        if not (all_s == all_s[0]).all():
            obs.event("resume_disagreement", n_done=int(n_done),
                      states=[[int(x) for x in row] for row in all_s])
            raise ValueError(f"controllers disagree on the resume state {all_s.tolist()} — "
                             "checkpoint_file must live on a filesystem shared by every "
                             "controller")

    def _save_checkpoint(force=False, upto=None):
        """Generation-boundary snapshot from the host history, written
        atomically by controller 0 (or by any controller on the degrade
        path, ``force``), capped at ``upto`` trials when the current
        generation was never verified.  Returns whether it wrote one."""
        if checkpoint_file is None or (pid != 0 and not force):
            return False
        from ..filestore import _atomic_write

        chaos.point("checkpoint", metrics=obs.metrics)
        state = _checkpoint_state(run_params, hist, raw_losses, labels,
                                  n_done if upto is None else upto)
        t0 = time.perf_counter()
        _atomic_write(checkpoint_file, pickle.dumps(state))
        obs.histogram("checkpoint.save_sec").observe(time.perf_counter() - t0)
        return True

    while n_done < max_evals:
        obs.heartbeat("driver.gen", gen=gen, n_done=n_done)
        chaos.point("gen", metrics=obs.metrics)
        obs.devmem_sample()
        obs.boundary()
        B = min(batch, max_evals - n_done)
        gseed = _gen_seed(seed, gen)
        with obs.annotate("driver.gen", step=gen, gen=gen, n_done=n_done, pid=pid), \
                obs.span("propose", gen=gen):
            if n_done < n_startup:
                # deterministic in (gseed, index): every controller draws the
                # whole startup batch itself
                out = cs.sample_flat(local_keys(gseed))
                flats = {l: _host(out[l]) for l in labels}
            elif single:
                out = propose_fn(device_history(n_done), local_keys(gseed))
                flats = {l: _host(out[l]) for l in labels}
            else:
                keys = multihost.global_key_batch(gseed, batch, mesh)
                flats = gather_packed(propose_sharded(device_history(n_done), keys))

        my_js = [j for j in range(B) if j % P == pid]
        with obs.span("evaluate", gen=gen, n_local=len(my_js)):
            my_losses, my_active = _evaluate(fn, cs, flats, my_js, obs)
        if single:
            losses, active_rows = my_losses, my_active
        else:
            # pad to the widest shard so the gathered shapes agree, encode
            # one wire buffer per controller, reassemble j = p + k*P
            width = (B + P - 1) // P
            pl = np.full(width, np.nan, np.float32)
            pl[:len(my_js)] = my_losses
            pa = np.zeros((width, L_n), bool)
            pa[:len(my_js)] = my_active
            ev = np.zeros(width, bool)
            ev[:len(my_js)] = True
            wire = payload_mod.to_wire(pl, pa, ev, wire_fmt)
            obs.gauge("payload.bytes_per_controller").set(int(wire.nbytes))
            obs.heartbeat("driver.allgather", point="results", mark="pre", gen=gen)
            chaos.point("allgather", metrics=obs.metrics)
            t0 = time.perf_counter()
            gathered = np.asarray(_timed_gather(
                lambda: multihost.allgather(wire), allgather_timeout, "results", obs,
                lambda: _save_checkpoint(force=True))).reshape(P, width, wire.shape[1])
            obs.histogram("allgather.results_sec").observe(time.perf_counter() - t0)
            obs.heartbeat("driver.allgather", point="results", mark="post", gen=gen)
            losses = np.full(B, np.nan, np.float32)
            active_rows = np.zeros((B, L_n), bool)
            for p in range(P):
                l_p, a_p, ev_p = payload_mod.from_wire(gathered[p], L_n, wire_fmt)
                js = np.arange(p, B, P)
                assert ev_p[:len(js)].all(), "padding row folded as real"
                losses[js] = l_p[:len(js)]
                active_rows[js] = a_p[:len(js)]

        # the one fold, whatever encoding delivered the rows
        with obs.span("fold", gen=gen):
            payload_mod.fold_generation(hist, raw_losses, n_done, labels,
                                        {l: flats[l][:B] for l in labels}, losses, active_rows)
            _digest_generation(digest, labels, flats, losses, B)
        n_done += B
        gen += 1
        obs.counter("generations").inc()
        obs.counter("trials.completed").inc(B)
        done_live = hist["has_loss"][:n_done]
        if done_live.any():
            obs.gauge("best_loss").set(float(hist["losses"][:n_done][done_live].min()))
        if not single:
            # divergence checksum: every controller folded the same bytes
            h = np.asarray([int.from_bytes(digest.digest()[:8], "big")], np.uint64)
            obs.heartbeat("driver.allgather", point="checksum", mark="pre", gen=gen)
            chaos.point("allgather", metrics=obs.metrics)
            t0 = time.perf_counter()
            all_h = np.asarray(_timed_gather(
                lambda: multihost.allgather(h), allgather_timeout, "checksum", obs,
                # folded but not verified: degrade to the last verified one
                lambda: _save_checkpoint(force=True, upto=n_done - B))).reshape(-1)
            obs.histogram("allgather.checksum_sec").observe(time.perf_counter() - t0)
            obs.heartbeat("driver.allgather", point="checksum", mark="post", gen=gen)
            if not np.all(all_h == all_h[0]):
                obs.event("controller_divergence", pid=pid, n_done=int(n_done), gen=int(gen),
                          checksums=[hex(int(x)) for x in all_h],
                          last_gen_losses=[float(x) for x in losses], batch=int(B))
                obs.counter("divergences").inc()
                raise ControllerDivergence(f"history checksums diverged after {n_done} "
                                           f"trials: {[hex(int(x)) for x in all_h]}")
        _save_checkpoint()  # verified generations only

    return _result(cs, hist, digest, n_done, dev)
