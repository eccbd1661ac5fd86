"""PROBE_GATE for the PyTorch port: two real
``hyperopt_tpu_torch.service.server --probe on`` processes, an outside
auditor prober, tenant traffic throughout, and a proposal-corrupting fault
on one replica (the port's counterpart of ``scripts/probe_smoke.py``, at
its period, cycle bound and fault).

* phase 1, steady state is green and free: each replica's own prober
  goes green; the auditor (``obs.prober.Prober`` over both URLs) sees no
  divergence in 2 cycles and burns no ``probe_golden_match`` budget;
  ``/metrics`` passes the probe-family lint on both; every verdict ledger
  line is sealed; the tenant studies finish their budget with nothing
  pending; both drain with exit 0.
* phase 2, corruption is caught, bounded and evidenced: r1 is drained
  (exit 0) and relaunched with ``corrupt@tick:1.0``; the auditor renders
  ``mismatch`` within 3 cycles, burns ``probe_golden_match`` and not
  ``probe_avail``, writes a readable evidence bundle and seals the red
  verdict; r1's own prober turns red on ``GET /probes``; tenant traffic on
  r0 loses no tell; both drain with exit 0.

The tenant studies' streams equal the undisturbed in-process scheduler's
bit for bit.  The probers judge against the committed golden of their
device (``obs/probe_golden.json``; the card's stream is the CPU's).

    python scripts/torch_probe_smoke.py [--device cpu] [--tenant-budget 8]
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
from validate_scrape import PROBE_FAMILIES, validate_probe_families  # noqa: E402

NAME = "torch_probe_smoke"
PROBE_PERIOD = 2.0


def _launch(store, device, tmp, label, port="0", chaos=None):
    return g.Server(["--port", port, "--store", store, "--probe", "on", "--probe-period",
                     PROBE_PERIOD], device, log_dir=tmp, chaos=chaos,
                    drop=("HYPEROPT_TPU_PROBE",), label=label)


class TenantDriver(threading.Thread):
    def __init__(self, url, study):
        super().__init__()
        self.url, self.study = url, study
        self.study_id = self.error = None
        self.seq = []

    def run(self):
        try:
            cl = g.client([self.url], key=self.study.seed, retries=20)
            sid = self.study.create(cl)
            for _ in range(self.study.budget):
                t = cl.ask(sid)[0]
                cl.tell(sid, t["tid"], self.study.loss(t["params"]))
                self.seq.append((t["tid"], g.canon(t["params"])))
            self.study_id = sid
        except Exception as e:  # noqa: BLE001
            self.error = f"tenant@{self.url}: {type(e).__name__}: {e}"


def _check_tenants(drivers, label):
    errors = [d.error for d in drivers if d.error]
    g.check(not errors, f"{label}: tenant errors: {errors}")
    lost = []
    for d in drivers:
        s = g.study_rows(d.url).get(d.study_id)
        if s is None or s["n_trials"] != d.study.budget or s["n_pending"]:
            lost.append((d.study_id, s and s["n_trials"], s and s["n_pending"]))
    g.check(not lost, f"{label}: lost or doubled tenant tells: {lost}")


def _wait_green(url, label, timeout=120):
    """The replica's own prober goes green (early ``error`` cycles are the
    fail-open contract at a cold start, waited through)."""
    deadline, last = time.monotonic() + timeout, None
    while time.monotonic() < deadline:
        r = g.request(url, "/probes", timeout=20)
        if r.status == 200:
            last = r.payload
            if last.get("armed") and last.get("green") and last.get("cycles", 0) >= 2:
                return last
        time.sleep(0.5)
    raise g.GateFailure(f"{label}: the prober never went green: {json.dumps(last)[:400]}")


def _sealed_ledger(store, label, want="ok"):
    from hyperopt_tpu_torch.obs.prober import probes_path_for, read_probes

    path = probes_path_for(store, "single")
    g.check(os.path.exists(path), f"{label}: no verdict ledger at {path}")
    recs, corrupt, _ = read_probes(path)
    g.check(not corrupt, f"{label}: {corrupt} corrupt ledger lines in {path}")
    g.check(any(r.get("verdict") == want for r in recs),
            f"{label}: no {want!r} verdict in {path}")


def _lint(url, label):
    text = g.get_text(url, "/metrics")
    errs = validate_probe_families(text) + [f for f in PROBE_FAMILIES if f not in text]
    g.check(not errs, f"{label}: probe exposition lint: {errs}")


def _auditor(urls, ledger, device):
    from hyperopt_tpu_torch.obs.prober import Prober
    from hyperopt_tpu_torch.obs.slo import PROBE_TARGETS, SLOPlane

    plane = SLOPlane()
    for name, spec in PROBE_TARGETS.items():
        plane.add_objective(name, spec)
    # a wide period buys a wide cycle deadline for a freshly relaunched
    # replica's first canary
    return Prober(urls, period=30.0, slo=plane, ledger_path=ledger, replica="auditor",
                  request_timeout=30.0, escalation_cooldown=0.0, backend=device), plane


def phase1_steady_green(args, device, tmp, studies, figures):
    g.log(NAME, "phase 1: 2 clean replicas, every prober green, canary traffic free")
    stores = [os.path.join(tmp, "p1r0"), os.path.join(tmp, "p1r1")]
    servers = []
    try:
        servers = [_launch(s, device, tmp, f"p1r{i}") for i, s in enumerate(stores)]
        urls = [s.url for s in servers]
        drivers = [TenantDriver(u, studies[i]) for i, u in enumerate(urls)]
        for d in drivers:
            d.start()
        t0 = time.perf_counter()
        for i, u in enumerate(urls):
            _wait_green(u, f"phase 1 r{i}")
        figures["green_s"] = time.perf_counter() - t0
        aud, plane = _auditor(urls, os.path.join(tmp, "aud1.jsonl"), device)
        for cyc in range(2):
            rec = aud.run_cycle()
            g.check(rec["verdict"] == "ok" and not rec["diverged"],
                    f"phase 1: auditor cycle {cyc + 1}: {rec['verdict']}, "
                    f"diverged={rec['diverged']}")
        g.check(plane.status()["probe_golden_match"]["budget_remaining_frac"] >= 1.0,
                "phase 1: a clean fleet burned golden-match budget")
        for d in drivers:
            d.join()
        _check_tenants(drivers, "phase 1")
        for i, (u, s) in enumerate(zip(urls, stores)):
            _lint(u, f"phase 1 r{i}")
            _sealed_ledger(s, f"phase 1 r{i}")
        for s in servers:
            s.drain_ok()
    finally:
        g.stop_all(servers)
    g.log(NAME, "phase 1: PASS — both replicas green, the auditor saw no divergence, ledgers "
                "sealed, tenants whole, drains exit 0")
    return [d.seq for d in drivers]


def phase2_divergence_caught(args, device, tmp, studies, figures):
    g.log(NAME, "phase 2: corrupt one replica's proposals; the probers catch it within 3 "
                "cycles")
    stores = [os.path.join(tmp, "p2r0"), os.path.join(tmp, "p2r1")]
    servers = []
    try:
        servers = [_launch(s, device, tmp, f"p2r{i}") for i, s in enumerate(stores)]
        for i, s in enumerate(servers):
            _wait_green(s.url, f"phase 2 r{i}")
        servers[1].drain_ok()
        servers[1] = _launch(stores[1], device, tmp, "p2r1-corrupt", port=servers[1].port,
                             chaos="7:corrupt@tick:1.0")
        urls = [s.url for s in servers]
        drivers = [TenantDriver(urls[0], studies[2])]
        drivers[0].start()
        aud, plane = _auditor(urls, os.path.join(tmp, "aud2.jsonl"), device)
        caught = None
        for cyc in range(1, 4):
            if aud.run_cycle()["verdict"] == "mismatch":
                caught = cyc
                break
        g.check(caught is not None, f"3 auditor cycles, no mismatch (last: {aud.last})")
        st = plane.status()
        g.check(st["probe_golden_match"]["budget_remaining_frac"] < 1.0,
                "the mismatch burned no golden-match budget")
        g.check(st["probe_avail"]["budget_remaining_frac"] >= 1.0,
                "the mismatch burned probe_avail (the replica answered; it answered wrong)")
        g.check(aud.evidence_bundles, "no evidence bundle written")
        with open(os.path.join(aud.evidence_bundles[-1], "bundle.json")) as f:
            bundle = json.load(f)
        missing = [k for k in ("verdict", "digest", "golden", "responses", "timeline")
                   if k not in bundle]
        g.check(not missing, f"the evidence bundle lacks {missing}")
        from hyperopt_tpu_torch.obs.prober import read_probes

        recs, corrupt, _ = read_probes(os.path.join(tmp, "aud2.jsonl"))
        g.check(not corrupt and any(r.get("verdict") == "mismatch" for r in recs),
                "the auditor's ledger is unsealed or lacks the red verdict")
        deadline, red = time.monotonic() + 120, None
        while time.monotonic() < deadline and red is None:
            r = g.request(urls[1], "/probes", timeout=20)
            if r.status == 200 and r.payload.get("verdicts", {}).get("mismatch", 0) >= 1:
                red = r.payload
            else:
                time.sleep(0.5)
        g.check(red is not None, "r1's own prober never rendered mismatch")
        g.check(not red.get("green"), "r1's /probes still green after the mismatch")
        drivers[0].join()
        _check_tenants(drivers, "phase 2")
        for s in servers:
            s.drain_ok()
    finally:
        g.stop_all(servers)
    figures["mismatch_cycle"] = caught
    g.log(NAME, f"phase 2: PASS — mismatch at cycle {caught}, golden-match burned, evidence "
                "readable, tenants whole, drains exit 0")
    return [d.seq for d in drivers]


def main(argv=None):
    args = g.gate_args(NAME, __doc__, argv, tenant_budget=8)
    device = g.prepare_device(args.device)
    figures = {"device": device}
    studies = [g.Study(seed=s, budget=args.tenant_budget, n_startup=3, loss=g.x_loss(1.0),
                       spec=g.spec_of(i)) for i, s in enumerate((100, 101, 200))]
    with tempfile.TemporaryDirectory(prefix="torch_probe_smoke_") as tmp:
        got = phase1_steady_green(args, device, tmp, studies, figures)
        got += phase2_divergence_caught(args, device, tmp, studies, figures)
    ref = g.reference_streams(studies, device)
    bad = g.compare_streams(got, ref, label="tenant study")
    g.check(not bad, "a tenant study left the undisturbed reference:\n" + "\n".join(bad))
    return figures


if __name__ == "__main__":
    sys.exit(g.run(NAME, main))
