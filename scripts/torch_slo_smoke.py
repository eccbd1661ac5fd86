"""SLO_GATE for the PyTorch port: request tracing, the audit timeline and
the SLO plane against a real ``hyperopt_tpu_torch.service.server``
process (the port's counterpart of ``scripts/slo_smoke.py``).

* one server with a store, its WAL, an access log, the SLO plane and
  tracing armed, on ``--device`` (the card by default);
* two studies, where the reference has one: the reference's on the
  uniform space (the fused kernel's route) and one with a quantized
  label beside ``x`` (the ``ei_diff`` route), so that the traced asks
  cross both kernels;
* per study one startup ask and tell, then ONE traced ``ServiceClient``
  TPE ask: the trace id the client minted comes back on the response,
  and is the one on the WAL's ask record on disk, on ``GET
  /study/<id>/timeline`` and in ``obs.report --study <id> <store>``;
* every study's two proposals equal the undisturbed in-process
  scheduler's bit for bit (on the card: both kernels launched there);
* ``GET /metrics`` lints with the ``hyperopt_tpu_slo_*`` families; the
  access log holds a record per request, trace ids included;
* SIGTERM drains with exit 0.

    python scripts/torch_slo_smoke.py [--device cpu] [--n-studies 2]
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_gate_common as g  # noqa: E402

NAME = "torch_slo_smoke"
SLO_FAMILIES = ("hyperopt_tpu_slo_availability_budget_remaining_frac",
                "hyperopt_tpu_slo_ask_latency_burn_fast",
                "hyperopt_tpu_slo_shed_rate_burn_slow")


def main(argv=None):
    args = g.gate_args(NAME, __doc__, argv, n_studies=2)
    device = g.prepare_device(args.device)
    from hyperopt_tpu_torch.service.journal import StudyJournal, wal_path_for

    studies = [g.Study(seed=5 + i, budget=2, n_startup=1, loss=lambda p: 0.25,
                       spec=g.spec_of(i)) for i in range(args.n_studies)]
    ref = g.reference_streams(studies, device)

    tmp = tempfile.mkdtemp(prefix="torch_slo_smoke_")
    store, access_log = os.path.join(tmp, "store"), os.path.join(tmp, "access.jsonl")
    srv = g.Server(["--port", "0", "--store", store], device, log_dir=tmp,
                   extra={"HYPEROPT_TPU_SERVICE_ACCESS_LOG": access_log,
                          "HYPEROPT_TPU_SERVICE_SLO": "on", "HYPEROPT_TPU_REQTRACE": "on"})
    try:
        g.log(NAME, f"server up at {srv.url} (pid {srv.pid})")
        client = g.client(srv.url, trace=True)
        got, traces, sids = [], [], []
        for st in studies:
            sid = st.create(client)
            t = client.ask(sid)[0]
            client.tell(sid, t["tid"], loss=st.loss(t["params"]))
            (a,) = client.ask(sid)
            trace = client.last_trace
            g.check(isinstance(trace, str) and len(trace) == 32,
                    f"the client minted no trace id: {trace!r}")
            got.append([(t["tid"], g.canon(t["params"])), (a["tid"], g.canon(a["params"]))])
            traces.append(trace)
            sids.append(sid)
        bad = g.compare_streams(got, ref)
        g.check(not bad, "the server left the undisturbed reference:\n" + "\n".join(bad))
        g.log(NAME, f"{len(sids)} traced TPE asks served, bit for bit with the reference")

        # the WAL's ask records on disk carry the trace ids
        recs = list(StudyJournal(wal_path_for(store)).records())
        for sid, trace in zip(sids, traces):
            asks = [r for r in recs if r.get("kind") == "ask" and r.get("algo") == "tpe"
                    and r.get("sid") == sid]
            g.check(asks and asks[-1].get("trace") == trace,
                    f"the WAL's ask record is not stamped with {trace[:16]}..: "
                    f"{asks[-1] if asks else None}")
            tl = g.get_json(srv.url, f"/study/{sid}/timeline")
            tl_asks = [e for e in tl.get("events", [])
                       if e.get("event") == "ask" and e.get("algo") == "tpe"]
            g.check(tl_asks and tl_asks[-1].get("trace") == trace,
                    f"the timeline endpoint misses the traced ask of {sid}")

        # obs.report --study rebuilds the timeline from the live store
        rep = g.run_module("hyperopt_tpu_torch.obs.report", ["--study", sids[0], store])
        g.check(rep.returncode == 0, f"obs.report --study failed: {rep.stderr[-500:]}")
        g.check(traces[0][:16] in rep.stdout and "algo=tpe" in rep.stdout,
                f"obs.report --study did not render the traced ask:\n{rep.stdout[-800:]}")
        g.log(NAME, "obs.report --study renders the traced timeline")

        errs = g.lint_metrics(g.get_text(srv.url, "/metrics"), SLO_FAMILIES)
        g.check(not errs, "/metrics: " + "; ".join(errs[:5]))

        with open(access_log) as f:
            acc = [json.loads(ln) for ln in f if ln.strip()]
        posts = [a for a in acc if a.get("method") == "POST"]
        g.check(len(posts) >= 1 + 3 * len(sids),
                f"the access log has {len(posts)} POST records, want >= {1 + 3 * len(sids)}")
        g.check(all(len(a.get("trace") or "") == 32 for a in posts),
                "access-log records without a trace id")
        g.check(set(traces) <= {a.get("trace") for a in posts},
                "a traced ask never reached the access log")
        g.log(NAME, f"/metrics lints with the slo_* families; the access log holds "
                    f"{len(acc)} records with trace ids")
        srv.drain_ok(timeout=120)
    finally:
        g.stop_all([srv])
    g.log(NAME, "PASS: trace ids agree across response, WAL, timeline, report and access "
                "log; clean drain")
    return {"device": device, "studies": len(sids)}


if __name__ == "__main__":
    sys.exit(g.run(NAME, main))
