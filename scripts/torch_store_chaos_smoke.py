"""STORE_GATE for the PyTorch port: a real ``hyperopt_tpu_torch.service.server``
process under concurrent clients with seeded WAL corruption and injected
disk-full faults (the port's counterpart of ``scripts/store_chaos_smoke.py``,
at its sizes, seeds and fault schedules).

* phase 1, corruption quarantines and never crashes: the server runs
  with ``corrupt@wal:<p>`` (a seeded bit flip in a just-written record:
  the write succeeds, the medium lies) while one client per study drives
  every study to its budget; the server drains with exit 0.  ``python -m
  hyperopt_tpu_torch.service.scrub`` must report every injected
  corruption (the chaos counter scraped from ``/metrics`` is the ground
  truth); a restart without chaos on the same root serves, with the
  corrupt studies quarantined (410 on an ask, flagged in ``/studies``, a
  ``quarantine`` event on the timeline) and every healthy study whole:
  no acknowledged tell lost, and its further asks equal the undisturbed
  in-process reference's bit for bit.  ``scrub --repair`` exits 0, and the
  repaired store scans clean and boots with its quarantine kept.
* phase 2, ENOSPC sheds typed and recovers: under ``enospc@wal:<p>`` an
  ask that meets the full disk answers 507 with ``Retry-After`` (read
  raw), the store-full latch sheds and re-probes, and every retrying
  client finishes its budget, its stream equal to the undisturbed
  in-process reference's bit for bit up to its first shed ask (which
  voids its ids and seed draw).

    python scripts/torch_store_chaos_smoke.py [--device cpu] [--n-studies 8] ...

``--phases 1`` or ``--phases 2`` runs one phase (both by default).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_gate_common as g  # noqa: E402

NAME = "torch_store_chaos_smoke"


def _offset(i, n):
    return -4.0 + 8.0 * i / max(1, n - 1)


def _scrub(store, *flags):
    res = g.run_module("hyperopt_tpu_torch.service.scrub", [store, "--json", *flags])
    try:
        return res.returncode, json.loads(res.stdout)
    except ValueError:
        raise g.GateFailure(f"scrub printed no report (rc {res.returncode}): "
                            f"{res.stderr[-800:]}") from None


def phase1_corruption(args, device, tmp, figures):
    n = args.n_studies
    studies = [g.Study(seed=5000 + i, budget=args.budget, n_startup=args.n_startup,
                       loss=g.x_loss(_offset(i, n)), spec=g.spec_of(i)) for i in range(n)]
    ref = g.reference_streams(studies, device, rounds=args.budget + args.extra)
    store = os.path.join(tmp, "store1")
    g.log(NAME, f"phase 1: corrupt@wal:{args.corrupt_p} under {n} clients; quarantine, "
                "scrub finds every flip, healthy studies bit for bit")
    srv = g.Server(["--port", "0", "--store", store], device, log_dir=tmp,
                   chaos=f"23:corrupt@wal:{args.corrupt_p}", label="corrupt")
    servers = [srv]
    try:
        port = srv.port
        seqs, sids, errors, lat = {}, {}, [], []
        lock = threading.Lock()

        def drive(i):
            cl = g.client(srv.url, key=i, retries=20)
            try:
                sid = studies[i].create(cl)
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
                    seqs[i], sids[i] = seq, sid
            except Exception as e:  # noqa: BLE001
                with lock:
                    errors.append(f"study {i}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=drive, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        g.check(not errors, "client errors under corruption (a write must succeed; the "
                            "lie shows at replay):\n  " + "\n  ".join(errors[:10]))
        injected = int(g.metric(g.get_text(srv.url, "/metrics"),
                                "hyperopt_tpu_chaos_corrupt_wal_total"))
        g.check(injected >= 1, f"chaos corrupted no record (injected={injected})")
        srv.drain_ok(timeout=60)
        figures["phase1_ask_ms"] = {"p50": 1e3 * g.percentile(lat, 0.5),
                                    "p99": 1e3 * g.percentile(lat, 0.99), "asks": len(lat)}

        # scrub reports every injection (a flip in the last line reads as a
        # torn tail by design, and is reported as that)
        rc, report = _scrub(store)
        found = sum(w["counts"]["corrupt"] for w in report["wals"])
        torn = sum(w["counts"]["torn"] for w in report["wals"])
        g.check(rc == 2, f"scrub exited {rc} on a corrupt store, want 2")
        g.check(found + torn >= injected and found >= injected - 1,
                f"scrub found {found} corrupt + {torn} torn of {injected} injected")
        figures["injected"], figures["scrub_corrupt"], figures["scrub_torn"] = \
            injected, found, torn
        g.log(NAME, f"phase 1: scrub found {found} corrupt (+{torn} torn) of {injected} "
                    "injected")

        # a restart without chaos quarantines, and never crash-loops
        srv = g.Server(["--port", port, "--store", store], device, log_dir=tmp,
                       label="restart")
        servers.append(srv)
        by_sid = {s["study_id"]: s for s in g.get_json(srv.url, "/studies")["studies"]}
        quarantined = {sid for sid, s in by_sid.items() if s.get("state") == "quarantined"}
        g.check(not found or quarantined, "corrupt records found but no study quarantined")
        for sid in sorted(quarantined)[:1]:
            r = g.request(srv.url, "/ask", {"study_id": sid})
            g.check(r.status == 410, f"a quarantined study's ask answered {r.status}, want 410")
            tl = g.get_json(srv.url, f"/study/{sid}/timeline")
            g.check(any(e.get("event") == "quarantine" for e in tl.get("events", [])),
                    "no quarantine event on the timeline")
        healthy = [i for i in range(n) if sids.get(i) and sids[i] not in quarantined]
        g.check(healthy, "every study was quarantined: lower --corrupt-p")
        bad = []
        for i in healthy:
            s = by_sid[sids[i]]
            g.check(s["n_pending"] == 0 and s["n_trials"] == args.budget,
                    f"healthy study {i} lost state: {s['n_trials']} trials, "
                    f"{s['n_pending']} pending")
            cl = g.client(srv.url, key=100 + i, retries=20)
            cont = []
            for _ in range(args.extra):
                t = cl.ask(sids[i])[0]
                cl.tell(sids[i], t["tid"], studies[i].loss(t["params"]))
                cont.append((t["tid"], g.canon(t["params"])))
            bad += g.compare_streams([seqs[i] + cont], [ref[i]], label=f"healthy study {i}")
        g.check(not bad, f"{len(bad)}/{len(healthy)} healthy studies left the undisturbed "
                         "reference:\n" + "\n".join(bad))
        srv.drain_ok(timeout=60)

        # scrub --repair makes a store that scans clean and boots clean
        rc, rep = _scrub(store, "--repair")
        post = rep.get("post", rep)  # the repair's own scan of what it wrote
        g.check(rc == 0 and post["clean"], f"scrub --repair exited {rc}, the repaired store "
                                           f"scans faulty: {post['faults'][:3]}")
        srv = g.Server(["--port", "0", "--store", store], device, log_dir=tmp, label="repaired")
        servers.append(srv)
        still = [s for s in g.get_json(srv.url, "/studies")["studies"]
                 if s.get("state") == "quarantined"]
        g.check(not found or still, "the repair forgot the quarantine markers")
        srv.drain_ok(timeout=60)
    finally:
        g.stop_all(servers)
    figures["quarantined"], figures["healthy_bitwise"] = len(quarantined), len(healthy)
    # whether the bit-for-bit streams held the ei_diff route's study too
    figures["ei_diff_study_bitwise"] = g.EI_DIFF_STUDY in healthy
    g.log(NAME, f"phase 1: PASS — {injected} injections, {len(quarantined)} studies "
                f"quarantined (410), {len(healthy)} healthy studies bit for bit with no tell "
                "lost, the repaired store boots clean")


def phase2_enospc(args, device, tmp, figures):
    g.log(NAME, f"phase 2: enospc@wal:{args.enospc_p}: 507 with Retry-After, recovery, "
                "every client finishes")
    studies = [g.Study(seed=9000 + i, budget=args.enospc_budget, n_startup=2,
                       loss=g.x_loss(0.0), spec=g.spec_of(i))
               for i in range(args.enospc_clients)]
    store = os.path.join(tmp, "store2")
    srv = g.Server(["--port", "0", "--store", store], device, log_dir=tmp,
                   chaos=f"31:enospc@wal:{args.enospc_p}", label="enospc")
    try:
        done, retries, errors, lat, seqs = [0], [0], [], [], {}
        lock = threading.Lock()

        def drive(i):
            cl = g.client(srv.url, key=i, retries=40)
            try:
                sid = studies[i].create(cl)
                seq = []
                for _ in range(args.enospc_budget):
                    t0 = time.perf_counter()
                    t = cl.ask(sid)[0]
                    dt = time.perf_counter() - t0
                    cl.tell(sid, t["tid"], studies[i].loss(t["params"]))
                    seq.append((t["tid"], g.canon(t["params"])))
                    with lock:
                        lat.append(dt)
                with lock:
                    done[0] += 1
                    retries[0] += cl.retries
                    seqs[i] = seq
            except Exception as e:  # noqa: BLE001
                with lock:
                    errors.append(f"client {i}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=drive, args=(i,))
                   for i in range(args.enospc_clients)]
        for t in threads:
            t.start()
        # probe raw for a 507 while the clients hammer: the typed shed must
        # carry Retry-After on the wire
        saw_507, retry_after, n_probes = False, None, 0
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not saw_507 and any(
                t.is_alive() for t in threads):
            r = g.request(srv.url, "/ask", {"study_id": "study-nonexistent"}, timeout=30)
            n_probes += 1
            if r.status == 507:
                saw_507, retry_after = True, r.retry_after
            time.sleep(0.05)
        for t in threads:
            t.join()
        g.check(not errors, "client errors (recovery broken?):\n  " + "\n  ".join(errors[:10]))
        metrics = g.get_text(srv.url, "/metrics")
        typed = (g.metric(metrics, "hyperopt_tpu_service_shed_store_full_total")
                 + g.metric(metrics, "hyperopt_tpu_chaos_enospc_wal_total"))
        g.check(typed >= 1, "no store-full shed or fault recorded")
        if saw_507:
            g.check(bool(retry_after), "a 507 without Retry-After")
        else:
            g.log(NAME, "phase 2: WARN — the raw probe never met an armed latch (the clients "
                        f"absorbed every window); the typed counters show it fired ({typed:.0f})")
        g.check(srv.alive(), "the server died under ENOSPC")
        srv.drain_ok(timeout=60)
    finally:
        g.stop_all([srv])
    # a shed ask voids its ids and its seed draw (journaled), so a stream
    # is the reference's up to its first voided id
    ref = g.reference_streams(studies, device)
    same = []
    for i, want in enumerate(ref):
        got = seqs[i]
        k = next((j for j, (a, b) in enumerate(zip(got, want)) if a[0] != b[0]), len(got))
        bad = g.compare_streams([got[:k]], [want[:k]], label=f"study {i}")
        g.check(not bad, "a study left the undisturbed reference before its first shed "
                         "ask:\n" + "\n".join(bad))
        same.append(k)
    figures.update(enospc_clients_done=done[0], enospc_backoffs=retries[0],
                   enospc_bitwise_prefix=same,
                   enospc_507_seen=saw_507, enospc_retry_after=retry_after,
                   enospc_typed=typed, enospc_ask_ms={
                       "p50": 1e3 * g.percentile(lat, 0.5),
                       "p99": 1e3 * g.percentile(lat, 0.99), "asks": len(lat)})
    g.log(NAME, f"phase 2: PASS — {done[0]}/{args.enospc_clients} clients finished through "
                f"the full-disk windows ({retries[0]} backoffs, 507 with Retry-After seen: "
                f"{saw_507})")


def main(argv=None):
    args = g.gate_args(NAME, __doc__, argv, n_studies=8, budget=8, extra=4, n_startup=3,
                       corrupt_p=0.02, enospc_p=0.25, enospc_clients=6, enospc_budget=6,
                       phases="1,2")
    device = g.prepare_device(args.device)
    figures = {"device": device, "phases": args.phases}
    with tempfile.TemporaryDirectory(prefix="torch_store_smoke_") as tmp:
        for name, phase in (("1", phase1_corruption), ("2", phase2_enospc)):
            if name in args.phases.split(","):
                phase(args, device, tmp, figures)
    return figures


if __name__ == "__main__":
    sys.exit(g.run(NAME, main))
