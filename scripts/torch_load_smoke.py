"""LOAD_GATE for the PyTorch port: the cost-attribution plane over a real
3-replica fleet of ``hyperopt_tpu_torch.service.server --fleet`` processes
with a ~10:1 skewed placement (the port's counterpart of
``scripts/load_smoke.py``, at its sizes).

* phase 1, the skew shows on every surface: ten studies on one hot shard,
  one on each of two others, each driven past startup.  ``GET
  /fleet/load`` on every replica serves the merged heat table with the
  hot shard hottest and ``heat_skew`` ≥ 2; the owner's ``/metrics`` lints
  with the ``service_load_*`` gauges; ``/snapshot`` and ``/healthz`` carry
  the load section; ``/studies`` rows carry the cost column; a raw
  ``/ask`` carries ``wave``; no tell is lost.
* phase 2, heat follows the shard: a third replica joins an overfull
  two-replica fleet and the volunteer handoff releases the HOTTEST held
  shard first, the adopter showing its heat; then the owner is SIGKILLed
  and the shard's new owner has replayed the heat from the durable
  ledger; the study keeps serving with no tell lost.

Every driven study's stream equals the undisturbed in-process
scheduler's bit for bit, across the handoff and the SIGKILL.

    python scripts/torch_load_smoke.py [--device cpu] [--hot-studies 10] ...
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_gate_common as g  # noqa: E402
from fleet_restart import wait_coverage  # noqa: E402

NAME = "torch_load_smoke"
LEASE_TTL = 2.0
N_SHARDS = 6


def _launch(store, rid, device, tmp):
    return g.Server(["--port", "0", "--store", store, "--fleet", "--fleet-shards", N_SHARDS,
                     "--lease-ttl", LEASE_TTL, "--replica-id", rid], device, log_dir=tmp,
                    drop=("HYPEROPT_TPU_LOAD",), label=rid)


def _drive(cl, sid, n, streams):
    for _ in range(n):
        t = cl.ask(sid)[0]
        cl.tell(sid, t["tid"], loss=float(float(t["params"]["x"]) ** 2))
        streams.setdefault(sid, []).append((t["tid"], g.canon(t["params"])))


def _held(url):
    return set(g.get_json(url, "/healthz").get("shards_held", []))


def _owner(urls, shard, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for u in urls:
            try:
                if shard in _held(u):
                    return u
            except (OSError, g.GateFailure):
                pass
        time.sleep(0.25)
    return None


def _check_streams(streams, seeds, specs, device):
    order = sorted(streams)
    studies = [g.Study(seed=seeds[sid], budget=len(streams[sid]), n_startup=2,
                       loss=g.x_loss(0.0), spec=specs[sid]) for sid in order]
    ref = g.reference_streams(studies, device)
    bad = g.compare_streams([streams[sid] for sid in order], ref)
    g.check(not bad, "a study left the undisturbed reference:\n" + "\n".join(bad))


def phase1_skew_surfaces(args, device, tmp, figures):
    from hyperopt_tpu_torch.service import shard_of

    g.log(NAME, "phase 1: 3 replicas, ~10:1 skewed placement; the skew shows and lints on "
                "every surface")
    store = os.path.join(tmp, "store1")
    servers, streams, seeds, specs = [], {}, {}, {}
    try:
        servers = [_launch(store, f"r{i}", device, tmp) for i in range(3)]
        urls = [s.url for s in servers]
        g.check(wait_coverage(urls, timeout=60), "the fleet never covered the keyspace")
        # the first replica claims every shard and volunteers the surplus as
        # the others join; a handoff in the middle of the drive would move a
        # study whose cost row the adopter only rebuilds from later waves
        g.check(g.wait_balanced(urls), "the fleet never settled its shard placement")
        cl = g.client(urls, retries=80)
        # a replica mints a new study's id on a shard it holds: create
        # through each replica in turn so the ids reach every shard
        minters = [g.client(urls[k:] + urls[:k], key=k, retries=80) for k in range(len(urls))]
        hot, hot_sids, cold_sids = None, [], {}
        # the second study minted is driven whether it lands on the hot
        # shard or on the first cold one: it takes the ei_diff route's space
        for k in range(200):
            sid = minters[k % len(minters)].create_study(space=g.spec_of(k), seed=1000 + k,
                                                         n_startup_jobs=2, max_trials=8)
            seeds[sid], specs[sid] = 1000 + k, g.spec_of(k)
            shard = shard_of(sid, N_SHARDS)
            hot = shard if hot is None else hot
            if shard == hot and len(hot_sids) < args.hot_studies:
                hot_sids.append(sid)
            elif shard != hot and shard not in cold_sids:
                cold_sids[shard] = sid
            if len(hot_sids) == args.hot_studies and len(cold_sids) >= 2:
                break
        else:
            raise g.GateFailure(f"could not mint the skewed placement: hot shard {hot} "
                                f"{len(hot_sids)} studies, others {sorted(cold_sids)}")
        cold = list(cold_sids.values())[:2]
        g.log(NAME, f"phase 1: {len(hot_sids)} studies on shard {hot}, one on each of "
                    f"{sorted(cold_sids)[:2]}")
        for sid in hot_sids + cold:
            _drive(cl, sid, 4, streams)
        time.sleep(2.5)  # past the 1 s heat roll

        for u in urls:
            fl = g.get_json(u, "/fleet/load")
            g.check(fl.get("ok") and "fleet" in fl, f"{u}/fleet/load lacks the fleet: {fl}")
        fl = g.get_json(urls[0], "/fleet/load")["fleet"]
        g.check(fl["shards"], "no heat records in the fleet view")
        hottest = max(fl["shards"], key=lambda k: fl["shards"][k]["heat_ms"])
        g.check(hottest == str(hot), f"hottest shard {hottest}, want {hot}: {fl['shards']}")
        g.check(fl["heat_skew"] >= 2.0, f"heat_skew {fl['heat_skew']} does not show the "
                                        "~10:1 placement")
        g.check(not fl["corrupt"], f"{fl['corrupt']} corrupt ledger records on a clean run")
        owner = next(u for u in urls if hot in _held(u))
        errs = g.lint_metrics(g.get_text(owner, "/metrics"),
                              ("service_load_heat_skew", "service_load_busy_frac",
                               f"service_load_shard_{hot}_heat_ms"))
        g.check(not errs, "the owner's /metrics: " + "; ".join(errs[:10]))
        snap = g.get_json(owner, "/snapshot")
        g.check("load" in snap and snap["load"]["heat_skew"] >= 1.0,
                "/snapshot lacks the load section")
        hz = g.get_json(owner, "/healthz")
        g.check("load" in hz and "heat_ms" in hz["shards"][str(hot)],
                "/healthz lacks the heat columns")
        row = g.study_rows(urls).get(hot_sids[0])
        g.check(row and "load" in row and row["load"]["tells"] >= 4
                and row["load"]["device_ms"] > 0, f"/studies row lacks the cost column: {row}")
        r = g.request(owner, "/ask", {"study_id": hot_sids[0]})
        g.check(r.status == 200 and r.payload.get("wave") is not None,
                f"a raw /ask lacks the wave field: {r}")
        t = r.payload["trials"][0]
        cl.tell(hot_sids[0], t["tid"], loss=float(float(t["params"]["x"]) ** 2))
        streams[hot_sids[0]].append((t["tid"], g.canon(t["params"])))
        rows = g.study_rows(urls)
        lost = [(sid, rows.get(sid)) for sid in hot_sids + cold
                if not rows.get(sid) or rows[sid]["n_trials"] != len(streams[sid])
                or rows[sid]["n_pending"]]
        g.check(not lost, f"lost tells: {lost}")
        for s in servers:
            s.drain_ok()
    finally:
        g.stop_all(servers)
    _check_streams(streams, seeds, specs, device)
    figures.update(heat_skew=fl["heat_skew"], hot_shard=hot,
                   hot_heat_ms=fl["shards"][str(hot)]["heat_ms"])
    g.log(NAME, f"phase 1: PASS — skew {fl['heat_skew']:.2f}x on /fleet/load, the gauges "
                f"lint, no tell lost, {len(streams)} streams bit for bit")


def phase2_heat_follows_the_shard(args, device, tmp, figures):
    from hyperopt_tpu_torch.service import shard_of

    g.log(NAME, "phase 2: the volunteer handoff drains the hottest shard; a SIGKILL replays "
                "the ledger")
    store = os.path.join(tmp, "store2")
    servers, streams, seeds, specs = [], {}, {}, {}
    try:
        servers = [_launch(store, f"q{i}", device, tmp) for i in range(2)]
        urls = [s.url for s in servers]
        g.check(wait_coverage(urls, timeout=60), "the fleet never covered the keyspace")
        g.check(g.wait_balanced(urls), "the fleet never settled its shard placement")
        held0 = _held(urls[0])
        g.check(len(held0) >= 2, f"q0 holds {held0}, want >= 2 of {N_SHARDS}")
        cl = g.client(urls, retries=80)
        sid = hot = None
        for k in range(200):
            cand = cl.create_study(space=g.X_SPEC, seed=2000 + k, n_startup_jobs=2,
                                   max_trials=30)
            if shard_of(cand, N_SHARDS) in held0:
                sid, hot = cand, shard_of(cand, N_SHARDS)
                seeds[sid], specs[sid] = 2000 + k, g.X_SPEC
                break
        g.check(sid is not None, "no study landed on q0")
        _drive(cl, sid, 12, streams)
        owner0 = _owner(urls, hot)
        g.check(owner0 is not None, f"shard {hot} unowned after driving")
        heat0 = g.get_json(owner0, "/healthz")["shards"][str(hot)]["heat_ms"]
        g.check(heat0 > 0, "no heat on the hot shard before the handoff")
        held0 = _held(owner0)

        servers.append(_launch(store, "q2", device, tmp))
        urls.append(servers[-1].url)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            now0 = _held(owner0)
            if len(now0) < len(held0):
                break
            time.sleep(0.25)
        else:
            raise g.GateFailure("the hot owner never volunteered a shard")
        g.check(hot not in now0, f"the owner released {held0 - now0} but kept the hottest "
                                 f"shard {hot} (the heat-aware order is broken)")
        owner = _owner(urls, hot)
        g.check(owner is not None, f"shard {hot} was never re-adopted")
        h = g.get_json(owner, "/healthz")["shards"][str(hot)]
        g.check(h["heat_ms"] >= heat0 * 0.99,
                f"the adopter's heat {h['heat_ms']} < {heat0} before the handoff")
        g.log(NAME, f"phase 2: the handoff drained the hottest shard {hot} (heat {heat0:.0f} "
                    "ms) and the adopter inherited it")

        _drive(cl, sid, 4, streams)
        time.sleep(2.5)
        # the steward may have moved the shard again since: kill its owner now
        owner = _owner(urls, hot)
        g.check(owner is not None, f"shard {hot} unowned before the SIGKILL")
        victim = urls.index(owner)
        servers[victim].kill()
        t_kill = time.perf_counter()
        live = [s.url for s in servers if s.alive()]
        new_owner = _owner(live, hot, timeout=90)
        g.check(new_owner is not None, f"shard {hot} was never reclaimed after the SIGKILL")
        reclaim_s = time.perf_counter() - t_kill
        h2 = g.get_json(new_owner, "/healthz")["shards"][str(hot)]
        g.check(h2["heat_ms"] >= heat0 * 0.99,
                f"heat {h2['heat_ms']} after the SIGKILL < {heat0}: the ledger did not replay")
        _drive(g.client(live, key=1, retries=80), sid, 4, streams)
        s = g.study_rows(live).get(sid)
        g.check(s and s["n_trials"] == 20 and not s["n_pending"],
                f"lost tells across the kill: {s}")
        for srv in servers:
            if srv.alive():
                srv.drain_ok()
    finally:
        g.stop_all(servers)
    _check_streams(streams, seeds, specs, device)
    figures.update(handoff_heat_ms=heat0, ledger_heat_ms=h2["heat_ms"], reclaim_s=reclaim_s)
    g.log(NAME, f"phase 2: PASS — heat followed shard {hot} through a handoff and a SIGKILL "
                f"(reclaimed in {reclaim_s:.1f} s), 20/20 tells settled, bit for bit")


def main(argv=None):
    args = g.gate_args(NAME, __doc__, argv, hot_studies=10)
    device = g.prepare_device(args.device)
    figures = {"device": device}
    with tempfile.TemporaryDirectory(prefix="torch_load_smoke_") as tmp:
        phase1_skew_surfaces(args, device, tmp, figures)
        phase2_heat_follows_the_shard(args, device, tmp, figures)
    return figures


if __name__ == "__main__":
    sys.exit(g.run(NAME, main))
