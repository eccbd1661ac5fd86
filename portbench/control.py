"""The controls of the comparison that decides ``correct``, run on their
own (the benchmark's runs never run them).

    python3 portbench/control.py --workload <cell> --seed <n> --seconds <s>

runs the cell's set-up and window as ``run.py`` does and prints, as one
JSON line, the checks of the lower-precision readings that the
comparison has to fail:

* ``history_bf16``: the program with its own bf16 history path
  (``HYPEROPT_TPU_HIST_DTYPE=bf16``, set here before the program loads):
  every proposal then reads a posterior fitted to bf16 values;
* ``objective_bf16``: the reference objective computed in bfloat16, put
  in the place of the program's losses (the program has no lower-precision
  objective of its own)."""

import json
import os
import sys

import run


def main(argv=None, device=None):
    args = run.parse(argv)
    os.environ["HYPEROPT_TPU_HIST_DTYPE"] = "bf16"
    c = run.load(args.workload)
    device = device or run.card(c.cell["chips"])
    if device is None:
        return 2

    import torch

    import drive
    from reference import check, tpe

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    entry = c.entry.Entry(c.cfg, c.config.fn, device)
    entry.search(drive.search_seed(args.seed, -1))
    handles, _, _ = drive.window(entry, args.seed, args.seconds, sync)
    searches = [entry.extract(h, s) for s, h in handles]
    limits = c.cfg["limits"]
    hist = c.entry.judge(c.cfg, c.config.objective, searches,
                         int(c.traffic["check_proposals"]), args.seed, device=torch.device(device))
    labels = tpe.labels_of(c.cfg["space"])
    for s in searches:
        s.losses = c.config.objective(s.vals, dtype=torch.bfloat16)
    obj = {"loss_gap": max(check.loss_gap(c.config.objective, labels, s) for s in searches)}
    out = {"workload": c.cell["name"], "seed": args.seed, "searches": len(searches),
           "history_bf16": hist, "objective_bf16": obj, "limits": limits,
           "history_bf16_correct": check.correct(hist, limits),
           "objective_bf16_correct": obj["loss_gap"] <= limits["loss_gap"]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
