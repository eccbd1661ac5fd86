"""FLEET_GATE for the PyTorch port: a real 3-replica serving fleet of
``hyperopt_tpu_torch.service.server --fleet`` processes over one store
root (the port's counterpart of ``scripts/fleet_smoke.py``, at its sizes,
seeds, fault schedule and bound).

* phase 1, SIGKILL one of three: replica r1 runs ``kill@tick:8`` (SIGKILL
  inside a cohort tick: after the draw, before the journal).  Nine
  clients, three homed on r1, ride through its death on the client's
  307/503/connection-error ladder while the survivors reclaim its leases
  and adopt its studies by epoch-WAL replay; r1 is never restarted.
  Every study's ``(tid, proposal)`` sequence equals the undisturbed
  in-process scheduler's bit for bit, ends with exactly its budget and
  nothing pending (no tell lost or applied twice; a 409 on a retried tell
  is the dedupe working), and the ask p99 stays under 60 s.
* phase 2, a rolling restart of every replica under traffic, through
  ``scripts/fleet_restart.py``'s ``restart_one`` (SIGTERM, drain exit 0,
  survivors cover the keyspace, relaunch with the port's server command
  on the same port, healthz ok), with the same checks at the end.

    python scripts/torch_fleet_smoke.py [--device cpu] [--kill-studies 9] ...
"""

from __future__ import annotations

import os
import pickle
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_gate_common as g  # noqa: E402
from fleet_restart import fetch_healthz, restart_one, wait_coverage  # noqa: E402

NAME = "torch_fleet_smoke"
N_SHARDS = 6
LEASE_TTL = 2.0
ASK_P99_BOUND_S = 60.0


def _offset(i, n):
    return -4.0 + 8.0 * i / max(1, n - 1)


def replica_args(store, rid, port="0"):
    return ["--port", port, "--store", store, "--fleet", "--fleet-shards", N_SHARDS,
            "--lease-ttl", LEASE_TTL, "--replica-id", rid]


class Driver(threading.Thread):
    """One study's client, homed on replica ``i mod 3``: create, then its
    budget of ask and tell, riding every fleet event on the retry ladder."""

    def __init__(self, i, study, urls):
        super().__init__()
        self.i, self.study = i, study
        k = i % len(urls)
        self.urls = urls[k:] + urls[:k]
        self.seq = self.study_id = self.error = None
        self.ask_s, self.duplicates = [], 0

    def run(self):
        cl = g.client(self.urls, key=self.i, retries=80)
        try:
            sid = self.study.create(cl, max_trials=self.study.budget)
            seq = []
            for _ in range(self.study.budget):
                t0 = time.perf_counter()
                t = cl.ask(sid)[0]
                self.ask_s.append(time.perf_counter() - t0)
                if cl.tell(sid, t["tid"], self.study.loss(t["params"])).get("duplicate"):
                    self.duplicates += 1
                seq.append((t["tid"], g.canon(t["params"])))
            self.seq, self.study_id = seq, sid
        except Exception as e:  # noqa: BLE001
            self.error = f"study {self.i}: {type(e).__name__}: {e}"


def _store_counts(store, study_id):
    """``(n_done, n_total)`` from the study's store: the record a finished
    study keeps once WAL compaction forgot its registry entry."""
    done = total = 0
    root = os.path.join(store, study_id)
    for state in ("new", "running", "done", "error", "cancel"):
        d = os.path.join(root, state)
        if not os.path.isdir(d):
            continue
        for fname in os.listdir(d):
            if fname.endswith(".pkl"):
                total += 1
                if state == "done":
                    with open(os.path.join(d, fname), "rb") as f:
                        if pickle.load(f).get("result", {}).get("status") is not None:
                            done += 1
    return done, total


def check_results(drivers, ref, live_urls, store, label):
    errors = [d.error for d in drivers if d.error]
    g.check(not errors, f"{label}: client errors:\n  " + "\n  ".join(errors[:10]))
    bad = g.compare_streams([d.seq for d in drivers], ref)
    g.check(not bad, f"{label}: {len(bad)}/{len(drivers)} studies left the undisturbed "
                     "reference:\n" + "\n".join(bad))
    table = g.study_rows(live_urls)
    lost = []
    for d in drivers:
        s = table.get(d.study_id)
        if s is not None:
            if s["n_trials"] != d.study.budget or s["n_pending"]:
                lost.append((d.i, s["n_trials"], s["n_pending"]))
        else:
            done, total = _store_counts(store, d.study_id)
            if done != d.study.budget or total != d.study.budget:
                lost.append((d.i, total, total - done))
    g.check(not lost, f"{label}: studies with lost or doubled tells: {lost}")
    lat = [t for d in drivers for t in d.ask_s]
    p50, p99 = g.percentile(lat, 0.5), g.percentile(lat, 0.99)
    g.check(p99 <= ASK_P99_BOUND_S, f"{label}: ask p99 {p99:.1f} s past the bound "
                                    f"{ASK_P99_BOUND_S} s")
    dups = sum(d.duplicates for d in drivers)
    g.log(NAME, f"{label}: ask p50 {p50 * 1e3:.0f} ms, p99 {p99 * 1e3:.0f} ms over "
                f"{len(lat)} asks; {dups} duplicate-tell dedupes")
    return {"ask_ms": {"p50": 1e3 * p50, "p99": 1e3 * p99, "asks": len(lat)},
            "duplicates": dups}


def _studies(n, budget, n_startup, seed0):
    return [g.Study(seed=seed0 + i, budget=budget, n_startup=n_startup,
                    loss=g.x_loss(_offset(i, n)), spec=g.spec_of(i)) for i in range(n)]


def phase1_sigkill(args, device, tmp, figures):
    g.log(NAME, "phase 1: SIGKILL one replica of three under concurrent clients")
    studies = _studies(args.kill_studies, args.kill_budget, 3, 3000)
    ref = g.reference_streams(studies, device)
    store = os.path.join(tmp, "store1")
    servers = []
    try:
        for i, chaos in enumerate([None, f"11:kill@tick:{args.kill_tick}", None]):
            servers.append(g.Server(replica_args(store, f"r{i}"), device, log_dir=tmp,
                                    chaos=chaos, label=f"r{i}"))
        urls = [s.url for s in servers]
        g.check(wait_coverage(urls, timeout=60), "the fleet never covered the keyspace")
        drivers = [Driver(i, st, urls) for i, st in enumerate(studies)]
        t0 = time.perf_counter()
        for d in drivers:
            d.start()
        dead, death_t, adopt_s = set(), None, None
        live = list(urls)
        while any(d.is_alive() for d in drivers):
            for i, s in enumerate(servers):
                if i not in dead and not s.alive():
                    dead.add(i)
                    death_t = time.perf_counter()
                    g.log(NAME, f"phase 1: r{i} died (rc {s.proc.returncode}); the "
                                "survivors reclaim its shards")
                    live = [u for j, u in enumerate(urls) if j not in dead]
            if death_t is not None and adopt_s is None and wait_coverage(live, timeout=0.01):
                adopt_s = time.perf_counter() - death_t
            time.sleep(0.1)
        for d in drivers:
            d.join()
        wall = time.perf_counter() - t0
        g.check(len(dead) == 1, f"expected exactly 1 chaos death, saw {len(dead)}")
        g.check(wait_coverage(live, timeout=60), "the survivors never re-covered the keyspace")
        if adopt_s is None:
            adopt_s = time.perf_counter() - death_t
        figures["phase1"] = check_results(drivers, ref, live, store, "phase 1")
        adopts = sum((fetch_healthz(u) or {}).get("adoptions", 0) for u in live)
        tells = sum(st.budget for st in studies)
        figures["phase1"].update(wall_s=wall, tells_per_s=tells / wall, adoption_s=adopt_s,
                                 adoptions=adopts)
        for s in servers:
            if s.alive():
                s.drain_ok()
    finally:
        g.stop_all(servers)
    g.log(NAME, f"phase 1: PASS — {len(studies)} studies bit for bit through 1 SIGKILL "
                f"({adopts} shard adoptions, keyspace re-covered {adopt_s:.1f} s after the "
                "death)")


def phase2_rolling_restart(args, device, tmp, figures):
    g.log(NAME, "phase 2: a rolling restart of every replica under traffic")
    studies = _studies(args.roll_studies, args.roll_budget, 3, 7000)
    ref = g.reference_streams(studies, device)
    store = os.path.join(tmp, "store2")
    servers, relaunched = [], []
    try:
        for i in range(3):
            servers.append(g.Server(replica_args(store, f"s{i}"), device, log_dir=tmp,
                                    label=f"s{i}"))
        urls = [s.url for s in servers]
        g.check(wait_coverage(urls, timeout=60), "the fleet never covered the keyspace")
        drivers = [Driver(i, st, urls) for i, st in enumerate(studies)]
        t0 = time.perf_counter()
        for d in drivers:
            d.start()
        time.sleep(1.0)  # let traffic build before the first drain
        step_s = []
        env = g.server_env()
        for i, s in enumerate(servers):
            others = [u for j, u in enumerate(urls) if j != i]
            relaunch = ["env", f"PYTHONPATH={env['PYTHONPATH']}",
                        f"HYPEROPT_TPU_WATCHDOG={env['HYPEROPT_TPU_WATCHDOG']}",
                        sys.executable, "-m", "hyperopt_tpu_torch.service.server",
                        "--device", device,
                        *[str(a) for a in replica_args(store, f"s{i}", port=s.port)]]
            t1 = time.perf_counter()
            try:
                proc = restart_one(s.pid, s.url, others, relaunch=relaunch, timeout=120)
            except RuntimeError as e:
                raise g.GateFailure(f"rolling restart of s{i}: {e}") from None
            step_s.append(time.perf_counter() - t1)
            relaunched.append(proc)
            g.log(NAME, f"phase 2: restarted replica s{i} ({i + 1}/3) in {step_s[-1]:.1f} s")
            h = fetch_healthz(s.url)
            g.check(h and h.get("ok"), f"relaunched s{i} healthz not ok")
        for d in drivers:
            d.join()
        wall = time.perf_counter() - t0
        figures["phase2"] = check_results(drivers, ref, urls, store, "phase 2")
        handoffs = sum((fetch_healthz(u) or {}).get("handoffs", 0) for u in urls)
        figures["phase2"].update(wall_s=wall, restart_step_s=step_s, handoffs=handoffs,
                                 tells_per_s=sum(st.budget for st in studies) / wall)
    finally:
        g.stop_all(servers)
        for p in relaunched:
            if p.poll() is None:
                p.kill()
            p.wait()
    g.log(NAME, f"phase 2: PASS — {len(studies)} studies bit for bit through a rolling "
                f"restart ({handoffs} handoffs visible after it)")


def main(argv=None):
    args = g.gate_args(NAME, __doc__, argv, kill_studies=9, kill_budget=12, kill_tick=8,
                       roll_studies=6, roll_budget=10)
    device = g.prepare_device(args.device)
    figures = {"device": device}
    with tempfile.TemporaryDirectory(prefix="torch_fleet_smoke_") as tmp:
        phase1_sigkill(args, device, tmp, figures)
        phase2_rolling_restart(args, device, tmp, figures)
    return figures


if __name__ == "__main__":
    sys.exit(g.run(NAME, main))
