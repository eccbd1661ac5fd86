"""QUALITY_GATE for the PyTorch port: the search-quality plane of a real
``hyperopt_tpu_torch.service.server`` process (the port's counterpart of
``scripts/quality_smoke.py``, at its mix).

* the zoo mix (``make_study_mix(4)``: quadratic1, branin, hartmann6,
  rosenbrock4) under ``tpe`` and under ``rand`` (a startup floor past the
  budget) on one server with a store, the objective evaluated by the
  client: by the server's own telemetry (``/studies``' quality sections)
  the summed trials-to-target of ``tpe`` is no worse than ``rand``'s;
* a budget-starved study (constant losses past the plateau window) is
  flagged ``stagnant`` on ``/studies`` with ``improvement`` and
  ``stagnation`` events on its timeline;
* ``/metrics`` lints with the ``hyperopt_tpu_quality_*`` families and the
  stagnation SLO objective; SIGTERM drains with exit 0;
* every study's stream equals the undisturbed in-process scheduler's bit
  for bit.

The reference gate's last step, ``bench_gate.py --explain``, reads the JAX
package's bench rounds and has no counterpart until the port has a bench.

    python scripts/torch_quality_smoke.py [--device cpu] [--mix-n 4]
"""

from __future__ import annotations

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_gate_common as g  # noqa: E402

NAME = "torch_quality_smoke"
QUALITY_FAMILIES = ("hyperopt_tpu_quality_studies", "hyperopt_tpu_quality_stagnant_frac",
                    "hyperopt_tpu_slo_stagnation_budget_remaining_frac")


def main(argv=None):
    args = g.gate_args(NAME, __doc__, argv, mix_n=4)
    device = g.prepare_device(args.device)
    from hyperopt_tpu_torch.obs.quality import DEFAULT_PLATEAU_WINDOW
    from hyperopt_tpu_torch.zoo import ZOO, make_study_mix

    items = make_study_mix(args.mix_n, 0)

    def objective(name):
        return lambda p: float(ZOO[name].objective(p))

    arms = [(algo, m, g.Study(seed=m.seed, budget=m.budget, zoo=m.domain.name,
                              n_startup=m.n_startup_jobs if algo == "tpe" else m.budget + 1,
                              loss=objective(m.domain.name)))
            for m in items for algo in ("tpe", "rand")]
    # on the ei_diff route's space: the zoo mix is all on the fused route,
    # so this study's ticks are the server's ei_diff route
    stag = g.Study(seed=3, budget=DEFAULT_PLATEAU_WINDOW + 2, n_startup=1,
                   loss=lambda p: 1.0, spec=g.EI_DIFF_SPEC)
    figures = {"device": device}
    with tempfile.TemporaryDirectory(prefix="torch_quality_smoke_") as tmp:
        srv = g.Server(["--port", "0", "--store", os.path.join(tmp, "store")], device,
                       log_dir=tmp, drop=("HYPEROPT_TPU_QUALITY",),
                       extra={"HYPEROPT_TPU_SERVICE_SLO": "on"})
        try:
            g.log(NAME, f"server up at {srv.url} (pid {srv.pid})")
            cl = g.client(srv.url)
            sids = [st.create(cl) for _, _, st in arms]
            got = []
            for sid, (_, _, st) in zip(sids, arms):
                seq = []
                for _ in range(st.budget):
                    t = cl.ask(sid)[0]
                    cl.tell(sid, t["tid"], loss=st.loss(t["params"]))
                    seq.append((t["tid"], g.canon(t["params"])))
                got.append(seq)
            rows = g.study_rows(srv.url)
            t2t = {"tpe": 0, "rand": 0}
            for sid, (algo, m, st) in zip(sids, arms):
                q = (rows.get(sid) or {}).get("quality")
                g.check(q, f"study {sid} ({algo} {m.name}) has no quality section")
                g.check(q.get("best_loss") is not None and q.get("n_told") == m.budget,
                        f"quality bookkeeping off for {algo} {m.name}: {q}")
                t2t[algo] += q["trials_to_target"] if q.get("solved") else m.budget
            g.log(NAME, f"mix of {len(items)} under both algorithms: trials-to-target tpe "
                        f"{t2t['tpe']} against rand {t2t['rand']}")
            g.check(t2t["tpe"] <= t2t["rand"], f"tpe ({t2t['tpe']}) worse than rand "
                                               f"({t2t['rand']}) on summed trials-to-target")

            sid = stag.create(cl)
            seq = []
            for _ in range(stag.budget):
                t = cl.ask(sid)[0]
                cl.tell(sid, t["tid"], loss=1.0)
                seq.append((t["tid"], g.canon(t["params"])))
            got.append(seq)
            q = (g.study_rows(srv.url).get(sid) or {}).get("quality") or {}
            g.check(q.get("stagnant"), f"the budget-starved study was never flagged: {q}")
            ev = [e["event"] for e in g.get_json(srv.url, f"/study/{sid}/timeline")
                  .get("events", [])]
            g.check("stagnation" in ev and "improvement" in ev,
                    f"the timeline lacks the quality events: {ev}")
            errs = g.lint_metrics(g.get_text(srv.url, "/metrics"), QUALITY_FAMILIES)
            g.check(not errs, "/metrics: " + "; ".join(errs[:5]))
            srv.drain_ok(timeout=120)
        finally:
            g.stop_all([srv])
    ref = g.reference_streams([st for _, _, st in arms] + [stag], device)
    bad = g.compare_streams(got, ref)
    g.check(not bad, "a study left the undisturbed reference:\n" + "\n".join(bad))
    figures.update(t2t_tpe=t2t["tpe"], t2t_rand=t2t["rand"], studies=len(got))
    g.log(NAME, "PASS: tpe beat rand by the server's own telemetry; stagnation flagged end to "
                "end; quality_* lint; every stream bit for bit; clean drain")
    return figures


if __name__ == "__main__":
    sys.exit(g.run(NAME, main))
