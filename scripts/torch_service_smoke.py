"""SERVICE_GATE for the PyTorch port: a real
``hyperopt_tpu_torch.service.server`` process under 100 concurrent HTTP
studies driven to convergence (the port's counterpart of
``scripts/service_smoke.py``, at its sizes and bar).

* 100 studies, each a quadratic with its own offset over x ~ U(-5, 5),
  24 trials, 5 startup, from 12 client threads: the median best loss is
  under 0.25 (random search at the same budget does not clear it);
* ``GET /studies`` answers a table consistent with what the clients did
  (the reference's field-by-field lint); ``/metrics`` lints and carries
  the ``service.*`` family; SIGTERM drains with exit 0;
* every study's stream equals the undisturbed in-process scheduler's bit
  for bit.

    python scripts/torch_service_smoke.py [--device cpu] [--n-studies 100] ...
"""

from __future__ import annotations

import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_gate_common as g  # noqa: E402

NAME = "torch_service_smoke"
CONVERGENCE_BAR = 0.25


def validate_studies_payload(payload, expect):
    """The reference's field-by-field lint of ``GET /studies``."""
    errs = [f"/studies lacks {k!r}" for k in ("ts", "n_studies", "slot_utilization",
                                              "cohorts", "studies", "cohort_cache")
            if k not in payload]
    if errs:
        return errs
    if payload["n_studies"] != len(payload["studies"]):
        errs.append("n_studies != len(studies)")
    if not 0.0 <= payload["slot_utilization"] <= 1.0:
        errs.append(f"slot_utilization out of [0, 1]: {payload['slot_utilization']}")
    by_id = {}
    for s in payload["studies"]:
        errs += [f"a study entry lacks {k!r}" for k in ("study_id", "state", "n_trials",
                                                         "n_pending", "best_loss", "labels")
                 if k not in s]
        by_id[s.get("study_id")] = s
        if s.get("n_pending", 0):
            errs.append(f"{s.get('study_id')}: {s['n_pending']} pending after every tell")
    for sid, n in expect.items():
        s = by_id.get(sid)
        if s is None:
            errs.append(f"{sid} missing from /studies")
        elif s["n_trials"] != n:
            errs.append(f"{sid}: n_trials {s['n_trials']} != {n}")
    errs += [f"cohort overfull: {c}" for c in payload["cohorts"]
             if c.get("n_live", 0) > c.get("n_slots", 0)]
    if payload["cohort_cache"].get("misses", 0) <= 0:
        errs.append("the cohort cache never built a program")
    return errs


def main(argv=None):
    args = g.gate_args(NAME, __doc__, argv, n_studies=100, budget=24, n_startup=5,
                       n_workers=12)
    device = g.prepare_device(args.device)
    n = args.n_studies
    studies = [g.Study(seed=1000 + i, budget=args.budget, n_startup=args.n_startup,
                       loss=g.x_loss(-4.0 + 8.0 * i / max(1, n - 1)), spec=g.spec_of(i))
               for i in range(n)]
    srv = g.Server(["--port", "0", "--max-studies", "256"], device)
    try:
        g.log(NAME, f"server up at {srv.url} (pid {srv.pid})")
        results, streams, errors, lat = {}, {}, [], []
        lock = threading.Lock()
        work = list(range(n))

        def drive():
            cl = g.client(srv.url, key=threading.get_ident() % 2**31, retries=8)
            while True:
                with lock:
                    if not work:
                        return
                    i = work.pop()
                try:
                    sid = studies[i].create(cl, max_trials=args.budget)
                    best, seq = float("inf"), []
                    for _ in range(args.budget):
                        t0 = time.perf_counter()
                        t = cl.ask(sid)[0]
                        dt = time.perf_counter() - t0
                        loss = studies[i].loss(t["params"])
                        best = min(best, loss)
                        cl.tell(sid, t["tid"], loss)
                        seq.append((t["tid"], g.canon(t["params"])))
                        with lock:
                            lat.append(dt)
                    with lock:
                        results[sid], streams[i] = best, seq
                except Exception as e:  # noqa: BLE001
                    with lock:
                        errors.append(f"study {i}: {type(e).__name__}: {e}")

        t0 = time.perf_counter()
        threads = [threading.Thread(target=drive) for _ in range(args.n_workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        g.check(not errors, "client errors:\n  " + "\n  ".join(errors[:10]))
        bests = sorted(results.values())
        median = bests[len(bests) // 2]
        g.log(NAME, f"{n} studies x {args.budget} trials over HTTP in {wall:.1f} s "
                    f"({n * args.budget / wall:.1f} tells/s), median best loss {median:.4f}")
        g.check(median <= CONVERGENCE_BAR, f"median best loss {median} > {CONVERGENCE_BAR} "
                                           "(the optimizer did not converge)")
        payload = g.get_json(srv.url, "/studies")
        errs = validate_studies_payload(payload, {sid: args.budget for sid in results})
        g.check(not errs, "/studies lint: " + "; ".join(errs[:10]))
        errs = g.lint_metrics(g.get_text(srv.url, "/metrics"),
                              ("hyperopt_tpu_service_asks_total",))
        g.check(not errs, "/metrics lint: " + "; ".join(errs[:10]))
        srv.drain_ok(timeout=60)
    finally:
        g.stop_all([srv])
    ref = g.reference_streams(studies, device)
    bad = g.compare_streams([streams.get(i) for i in range(n)], ref)
    g.check(not bad, f"{len(bad)}/{n} studies left the undisturbed reference:\n"
            + "\n".join(bad[:5]))
    g.log(NAME, "PASS: converged, /studies and /metrics lint, every stream bit for bit, clean "
                "drain")
    return {"device": device, "studies": n, "median_best": median,
            "wall_s_drive": wall, "tells_per_s": n * args.budget / wall,
            "ask_ms": {"p50": 1e3 * g.percentile(lat, 0.5),
                       "p99": 1e3 * g.percentile(lat, 0.99), "asks": len(lat)}}


if __name__ == "__main__":
    sys.exit(g.run(NAME, main))
