"""SERVICE_CHAOS_GATE for the PyTorch port: a real
``hyperopt_tpu_torch.service.server`` process SIGKILLed mid-wave under
concurrent HTTP traffic and restarted on the same root (the port's
counterpart of ``scripts/service_chaos_smoke.py``, at its sizes, seeds and
fault schedules).

* phase 1, crash and resume bit for bit: the server runs with a store,
  its WAL and ``kill@tick:6`` (SIGKILL inside the 6th cohort tick: after
  the ids and the seed draw, before anything journals or lands).  The
  clients ride through on retry and backoff while the gate restarts the
  server on the same port and root, the first restart armed again, the
  second clean.  Every study's whole ``(tid, proposal)`` sequence must
  equal the undisturbed in-process scheduler's.  The kill is an observed
  event (the tick count), not a timer.
* phase 2, overload sheds and loses no tell: a 4-deep admission queue
  (``HYPEROPT_TPU_SERVICE_QUEUE=4``) under 8 clients at twice that: 429s
  with ``Retry-After`` (counted raw from a probing client too), every
  client finishes on backoff, and ``/studies`` shows every trial told and
  none pending.
* phase 3, the degrade ladder keeps the server up: under ``ioerr@tick:0.5``
  every ask answers 200 (some flagged ``degraded``), the
  ``service_degrade_faults`` counters move, and SIGTERM drains with exit 0.

    python scripts/torch_service_chaos_smoke.py [--device cpu] [--n-studies 8] ...
"""

from __future__ import annotations

import os
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_gate_common as g  # noqa: E402

NAME = "torch_service_chaos_smoke"


def _offset(i, n):
    return -4.0 + 8.0 * i / max(1, n - 1)


def phase1_crash_resume(args, device, tmp, figures):
    g.log(NAME, "phase 1: SIGKILL mid-wave (kill@tick:6), restart, bit for bit with the "
                "reference")
    n = args.n_studies
    studies = [g.Study(seed=3000 + i, budget=args.budget, n_startup=args.n_startup,
                       loss=g.x_loss(_offset(i, n)), spec=g.spec_of(i)) for i in range(n)]
    ref = g.reference_streams(studies, device)
    store = os.path.join(tmp, "store")
    chaos = f"11:kill@tick:{args.kill_tick}"
    servers = [g.Server(["--port", "0", "--store", store], device, log_dir=tmp, chaos=chaos,
                        label="armed")]
    port = servers[0].port
    url = servers[0].url
    seqs, errors, lat = {}, [], []
    lock = threading.Lock()

    def drive(i):
        cl = g.client(url, key=i, retries=60)
        try:
            sid = studies[i].create(cl, max_trials=args.budget)
            seq = []
            for _ in range(args.budget):
                t0 = time.perf_counter()
                t = cl.ask(sid)[0]
                dt = time.perf_counter() - t0
                cl.tell(sid, t["tid"], studies[i].loss(t["params"]))
                seq.append((t["tid"], g.canon(t["params"])))
                with lock:
                    lat.append(dt)
            with lock:
                seqs[i] = seq
        except Exception as e:  # noqa: BLE001
            with lock:
                errors.append(f"study {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=drive, args=(i,)) for i in range(n)]
    kills, restart_s = 0, []
    try:
        for t in threads:
            t.start()
        # restart on the same port and root when the schedule kills the
        # process: the first restart armed again, the second clean
        restarts = [chaos, None]
        while any(t.is_alive() for t in threads):
            if not servers[-1].alive():
                kills += 1
                t0 = time.perf_counter()
                servers.append(g.Server(["--port", port, "--store", store], device,
                                        log_dir=tmp, chaos=restarts.pop(0) if restarts
                                        else None, label=f"restart{kills}"))
                restart_s.append(time.perf_counter() - t0)
            time.sleep(0.1)
        for t in threads:
            t.join()
        g.check(not errors, "client errors:\n  " + "\n  ".join(errors[:10]))
        g.check(kills >= 1, f"the chaos schedule never fired (kills={kills})")
        bad = g.compare_streams([seqs.get(i) for i in range(n)], ref)
        g.check(not bad, f"{len(bad)}/{n} studies left the undisturbed reference:\n"
                + "\n".join(bad))
    finally:
        g.stop_all(servers)
    figures.update(kills=kills, restart_s=restart_s, phase1_ask_ms={
        "p50": 1e3 * g.percentile(lat, 0.5), "p99": 1e3 * g.percentile(lat, 0.99),
        "asks": len(lat)})
    g.log(NAME, f"phase 1: PASS — {n} studies x {args.budget} trials bit for bit across "
                f"{kills} SIGKILL(s) and restarts")


def phase2_overload(args, device, tmp, figures):
    g.log(NAME, "phase 2: twice the capacity sheds 429 with Retry-After; no tell lost")
    srv = g.Server(["--port", "0"], device, log_dir=tmp, label="overload",
                   extra={"HYPEROPT_TPU_SERVICE_QUEUE": str(args.queue)})
    try:
        counts = {"done": 0, "retries": 0}
        errors, lat, sheds = [], [], []
        lock = threading.Lock()
        sids = {}

        def drive(i):
            cl = g.client(srv.url, key=i, retries=60)
            try:
                sid = cl.create_study(space=g.X_SPEC, seed=7000 + i, n_startup_jobs=2)
                with lock:
                    sids[i] = sid
                for _ in range(args.overload_budget):
                    t0 = time.perf_counter()
                    t = cl.ask(sid)[0]
                    dt = time.perf_counter() - t0
                    cl.tell(sid, t["tid"], float(float(t["params"]["x"]) ** 2))
                    with lock:
                        lat.append(dt)
                with lock:
                    counts["done"] += 1
                    counts["retries"] += cl.retries
            except Exception as e:  # noqa: BLE001
                with lock:
                    errors.append(f"client {i}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=drive, args=(i,))
                   for i in range(args.overload_clients)]
        for t in threads:
            t.start()
        # a raw prober asks too, to read a shed's status and header off the
        # wire (its asks are told, so nothing stays pending)
        probe_sid = g.request(srv.url, "/study", {"space": g.X_SPEC, "seed": 1,
                                                  "n_startup_jobs": 1}).payload["study_id"]
        probe_told = 0
        while any(t.is_alive() for t in threads):
            r = g.request(srv.url, "/ask", {"study_id": probe_sid}, timeout=60)
            if r.status == 429:
                sheds.append(r.retry_after)
            elif r.status == 200:
                tid = r.payload["trials"][0]["tid"]
                g.check(g.request(srv.url, "/tell", {"study_id": probe_sid, "tid": tid,
                                                     "loss": 1.0}).status == 200,
                        "the prober's tell failed")
                probe_told += 1
        for t in threads:
            t.join()
        g.check(not errors, "client errors:\n  " + "\n  ".join(errors[:10]))
        g.check(all(sheds), f"a 429 without Retry-After: {sheds[:5]}")
        table = g.study_rows(srv.url)
        pend = sum(s["n_pending"] for s in table.values())
        short = [s["study_id"] for sid, s in table.items()
                 if sid != probe_sid and s["n_trials"] != args.overload_budget]
        g.check(not pend and not short and table[probe_sid]["n_trials"] == probe_told,
                f"{pend} pending, {len(short)} short studies after every tell")
        metrics = g.get_text(srv.url, "/metrics")
        g.check(not g.lint_metrics(metrics), "/metrics lint")
        g.check(counts["retries"] + len(sheds) >= 1,
                "no client backed off and no ask was shed at twice the capacity")
        srv.drain_ok(timeout=60)
    finally:
        g.stop_all([srv])
    figures.update(overload_done=counts["done"], overload_backoffs=counts["retries"],
                   overload_raw_429=len(sheds), overload_ask_ms={
                       "p50": 1e3 * g.percentile(lat, 0.5),
                       "p99": 1e3 * g.percentile(lat, 0.99), "asks": len(lat)})
    g.log(NAME, f"phase 2: PASS — {counts['done']}/{args.overload_clients} clients finished, "
                f"{counts['retries']} backoffs, {len(sheds)} raw 429s with Retry-After")


def phase3_degrade(args, device, tmp, figures):
    g.log(NAME, "phase 3: injected tick faults walk the ladder; the server stays up and "
                "drains clean")
    srv = g.Server(["--port", "0"], device, log_dir=tmp, chaos="5:ioerr@tick:0.5",
                   label="degrade", extra={"HYPEROPT_TPU_SERVICE_DEGRADE": "3"})
    try:
        cl = g.client(srv.url, retries=10)
        sid = cl.create_study(space=g.X_SPEC, seed=42, n_startup_jobs=2)
        degraded = 0
        for _ in range(args.degrade_asks):
            t = cl.ask(sid)[0]
            degraded += bool(t.get("degraded"))
            cl.tell(sid, t["tid"], float((float(t["params"]["x"]) - 1.0) ** 2))
        g.check(srv.alive(), "the server died under tick faults")
        metrics = g.get_text(srv.url, "/metrics")
        g.check("service_degrade_faults_total" in metrics, "no degrade fault counters")
        faults = g.metric(metrics, "hyperopt_tpu_service_degrade_faults_total")
        srv.drain_ok(timeout=60)
    finally:
        g.stop_all([srv])
    figures.update(degrade_asks=args.degrade_asks, degraded=degraded, degrade_faults=faults)
    g.log(NAME, f"phase 3: PASS — {args.degrade_asks}/{args.degrade_asks} asks served under "
                f"50% tick faults ({degraded} flagged degraded), drained with exit 0")


def main(argv=None):
    args = g.gate_args(NAME, __doc__, argv, n_studies=8, budget=12, n_startup=3, kill_tick=6,
                       queue=4, overload_clients=8, overload_budget=8, degrade_asks=14)
    device = g.prepare_device(args.device)
    figures = {"device": device}
    with tempfile.TemporaryDirectory(prefix="torch_service_chaos_") as tmp:
        phase1_crash_resume(args, device, tmp, figures)
        phase2_overload(args, device, tmp, figures)
        phase3_degrade(args, device, tmp, figures)
    return figures


if __name__ == "__main__":
    sys.exit(g.run(NAME, main))
