"""Elastic fleet driver (counterpart of ``hyperopt_tpu/parallel/fleet.py``):
``fmin_multihost`` over leased work shards instead of collectives.

The collective driver is deterministic but its membership is fixed: its
exchange is an all-gather, so a controller lost mid-generation leaves the
survivors waiting.  This module runs the same algorithm (same proposals,
fold order and digest, the same history bit for bit) with the exchange
moved onto the lease plane of :mod:`~.membership`:

* every controller computes the whole generation's proposals itself
  (deterministic in ``(seed, generation, history)``);
* evaluation is leased per shard (``j % n_shards``): a controller claims,
  heartbeats, evaluates and publishes a shard's results as one atomic blob
  in the store;
* a survivor reclaims a dead controller's stale lease and re-runs the
  shard; the duplicate publish is the same bytes;
* the generation barrier is "every occupied shard has a result", which
  any fleet size, one survivor included, can satisfy;
* the store is the checkpoint: a controller (re)starting on a populated
  store replays finished generations from the published blobs, so a fleet
  resumed at another size reaches the same history (``n_shards`` and the
  other run parameters are pinned write-once in the store).

Each controller publishes its cumulative digest per generation
(``checksum.<owner>``) and checks every other's; a mismatch raises
:class:`~.driver.ControllerDivergence`.  The store's layout and blobs are
the JAX package's, so either package finishes a store the other started.

Chaos sites (``chaos``): ``gen`` at each generation start, ``claim``
before each lease claim, ``trial`` before each objective call, ``publish``
before each shard publish, ``checkpoint`` before each checkpoint write.
"""

from __future__ import annotations

import pickle
import time

import numpy as np
import torch

from .. import chaos, prng, quant
from .._env import parse_hist_dtype, resolve_device
from ..algos import tpe
from ..exceptions import FleetDegraded
from ..spaces import compile_space
from . import payload as payload_mod
from .membership import FleetMembership, n_occupied_shards, shard_trials

__all__ = ["fleet_fmin"]


def fleet_fmin(fn, space, max_evals, fleet_dir, batch=None, seed=0, cfg=None,
               n_startup=None, n_shards=None, lease_ttl=15.0, checkpoint_file=None,
               obs=None, owner=None, poll_interval=0.05, barrier_timeout=600.0,
               device=None):
    """Minimize ``fn`` over ``space`` as one controller of an elastic
    fleet rooted at ``fleet_dir``.  Run any number of these at once, as
    plain processes (no process group); each returns the same
    :class:`~.driver.MultihostResult`, equal to
    ``fmin_multihost(..., _force_single=True)`` at the same ``(seed,
    batch, cfg)``.

    ``n_shards`` (default ``min(batch, 8)``) fixes a generation's work
    shards and is pinned in the store's ``params.json``.  ``lease_ttl``
    is the heartbeat age after which survivors reclaim a shard.
    ``barrier_timeout`` bounds a wait in which nothing moves; past it the
    controller checkpoints what is verified and raises
    :class:`FleetDegraded`.  ``device`` is where proposals run (the card
    unless ``"cpu"``); ``obs`` is the run's telemetry, as ``fmin``'s.
    ``cfg["compile_cache"]`` names the kernel libraries' directory."""
    from ..obs import ObsConfig, RunObs
    from .driver import (ControllerDivergence, _checkpoint_state, _default_cfg,
                         _digest_generation, _evaluate, _gen_seed, _host, _load_checkpoint,
                         _new_history, _pop_compile_cache, _result)

    dev = resolve_device(device)
    cfg = _pop_compile_cache(cfg)
    if not isinstance(obs, RunObs):
        obs = RunObs(ObsConfig.resolve(obs))
    # this thread proposes: it serves the capture plane until the run ends
    if obs.profiler is not None:
        obs.profiler.attach_loop()
    try:
        cs = compile_space(space)
        labels = cs.labels
        if batch is None:
            batch = 1 if dev.type == "cpu" else torch.cuda.device_count()
        cfg = dict(_default_cfg(batch), **dict(cfg or {}))
        if n_startup is None:
            n_startup = max(batch, 20)
        n_shards = max(1, min(int(batch), 8)) if n_shards is None else int(n_shards)
        run_params = {"labels": list(labels), "batch": int(batch), "seed": int(seed),
                      "n_startup": int(n_startup), "cfg": sorted(cfg.items()),
                      "n_shards": n_shards}

        member = FleetMembership(fleet_dir, owner=owner, lease_ttl=lease_ttl,
                                 metrics=obs.metrics)
        member.ensure_params(run_params)
        member.join()
        obs.event("fleet_controller", owner=member.owner, n_shards=n_shards,
                  lease_ttl=lease_ttl)
        saved = _load_checkpoint(checkpoint_file, run_params, batch, max_evals, obs,
                                 exact=False)
        hist, raw_losses, digest, n_done = _new_history(labels, max_evals, saved)
        gen = n_done // batch

        propose_fn = tpe.build_propose(cs, cfg)
        # int8/fp8 degrade to bf16: this path stores the history by a cast
        hist_dt = quant.mirror_float_dtype(parse_hist_dtype())

        def device_history():
            # a full upload per generation, compressed as the collective
            # single run's mirror is (the same proposals): the fleet
            # optimizes survivability, not transfer
            def up(x):
                t = torch.tensor(x, device=dev)
                return t.to(hist_dt) if t.is_floating_point() else t

            return {"losses": up(hist["losses"]), "has_loss": up(hist["has_loss"]),
                    "vals": {l: up(v) for l, v in hist["vals"].items()},
                    "active": {l: up(v) for l, v in hist["active"].items()}}

        def local_keys(gseed):
            idx = torch.arange(batch, dtype=torch.int64, device=dev)
            return prng.fold_in(prng.PRNGKey(gseed, dev), idx)

        def save_checkpoint():
            """Every controller writes (membership is elastic, so there is
            no controller 0); the bytes are the same on all of them."""
            if checkpoint_file is None:
                return
            from ..filestore import _atomic_write

            chaos.point("checkpoint", metrics=obs.metrics)
            t0 = time.perf_counter()
            _atomic_write(checkpoint_file, pickle.dumps(
                _checkpoint_state(run_params, hist, raw_losses, labels, n_done)))
            obs.histogram("checkpoint.save_sec").observe(time.perf_counter() - t0)

        L_n = len(labels)
        while n_done < max_evals:
            obs.heartbeat("driver.gen", gen=gen, n_done=n_done, owner=member.owner)
            obs.devmem_sample()
            obs.boundary()
            chaos.point("gen", metrics=obs.metrics)
            member.heartbeat_member()
            B = min(batch, max_evals - n_done)
            S_gen = n_occupied_shards(B, n_shards)
            gseed = _gen_seed(seed, gen)
            with obs.annotate("driver.gen", step=gen, gen=gen, n_done=n_done), \
                    obs.span("propose", gen=gen):
                if n_done < n_startup:
                    out = cs.sample_flat(local_keys(gseed))
                else:
                    out = propose_fn(device_history(), local_keys(gseed))
                flats = {l: _host(out[l]) for l in labels}

            # evaluate or adopt until every occupied shard has a result:
            # claim missing shards, reclaim stale leases, poll.  The
            # deadline measures liveness: it re-arms on any progress (a
            # publish, a reclaim, a missing shard's lease mtime advancing)
            deadline = time.monotonic() + barrier_timeout
            barrier_view = None
            with obs.span("evaluate", gen=gen):
                while True:
                    missing = member.missing_shards(gen, S_gen)
                    if not missing:
                        break
                    progressed = False
                    for s in member.claim_order(missing):
                        chaos.point("claim", metrics=obs.metrics)
                        if not member.try_claim(gen, s):
                            continue
                        progressed = True
                        js = shard_trials(B, n_shards, s)

                        def beat(_k, s=s):
                            chaos.point("trial", metrics=obs.metrics)
                            if _k:
                                member.heartbeat_shard(gen, s)

                        losses_s, active_s = _evaluate(fn, cs, flats, js, obs, on_trial=beat)
                        member.heartbeat_shard(gen, s)
                        blob = pickle.dumps({"shard": int(s), "js": js, "losses": losses_s,
                                             "active": active_s}, protocol=4)
                        chaos.point("publish", metrics=obs.metrics)
                        member.publish(gen, s, blob)
                    if progressed:
                        deadline = time.monotonic() + barrier_timeout
                        continue
                    if member.reclaim_stale(gen, S_gen):
                        deadline = time.monotonic() + barrier_timeout
                        continue
                    view = (tuple(missing), tuple(member.lease_mtimes(gen, missing)))
                    if view != barrier_view:
                        barrier_view = view
                        deadline = time.monotonic() + barrier_timeout
                    if time.monotonic() >= deadline:
                        save_checkpoint()
                        obs.event("fleet_barrier_timeout", gen=gen, missing=list(missing))
                        raise FleetDegraded(
                            f"generation {gen} incomplete after {barrier_timeout:.0f}s "
                            f"(shards {missing} leased but never published and never went "
                            "stale); verified history checkpointed — restart the fleet "
                            "(any size) on the same store to resume bitwise")
                    member.heartbeat_member()
                    time.sleep(poll_interval)

            # the generation in global trial-id order from the published
            # blobs (this controller's and everyone else's alike)
            losses = np.full(B, np.nan, np.float32)
            active_rows = np.zeros((B, L_n), bool)
            for s in range(S_gen):
                blob = member.read_result(gen, s)
                if blob is None:
                    raise FleetDegraded(
                        f"shard result gen={gen} shard={s} vanished after the barrier — "
                        "the fleet store is being mutated externally")
                rec = pickle.loads(blob)
                js = np.asarray(rec["js"], int)
                losses[js] = rec["losses"]
                active_rows[js] = rec["active"]

            with obs.span("fold", gen=gen):
                payload_mod.fold_generation(hist, raw_losses, n_done, labels,
                                            {l: flats[l][:B] for l in labels}, losses,
                                            active_rows)
                _digest_generation(digest, labels, flats, losses, B)
            n_done += B
            gen += 1
            obs.counter("generations").inc()
            obs.counter("trials.completed").inc(B)
            done_live = hist["has_loss"][:n_done]
            if done_live.any():
                obs.gauge("best_loss").set(float(hist["losses"][:n_done][done_live].min()))

            # divergence audit: publish my cumulative digest and check every
            # controller that folded this generation (a dead one never wrote)
            my_sum = digest.hexdigest()
            member.write_checksum(gen - 1, my_sum)
            bad = {o: c for o, c in member.read_checksums(gen - 1).items() if c != my_sum}
            if bad:
                obs.event("controller_divergence", owner=member.owner, n_done=int(n_done),
                          gen=int(gen - 1), mine=my_sum, others=bad)
                obs.counter("divergences").inc()
                raise ControllerDivergence(f"fleet history checksums diverged after "
                                           f"{n_done} trials: mine={my_sum} theirs={bad}")
            save_checkpoint()

        result = _result(cs, hist, digest, n_done, dev)
        member.leave()
        return result
    finally:
        if obs.profiler is not None:
            obs.profiler.detach_loop()
        obs.finish()
