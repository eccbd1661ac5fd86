"""The port's benchmark: one cell of ``BENCHMARK.json``, one run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything of a cell is found by the names in ``BENCHMARK.json``: its
configuration ``configs/<config>.json`` with its objective beside it
(``configs/<config>.py``: ``fn``, handed to the program, and
``objective``, its plain reference), its traffic mix
``traffic/<mix>.json``, the entry module that mix names
(``entries/<entry>.py``, see ``drive.py``), and the per-layer metrics
listed for it (``metrics/<metric>.py``, each a ``read(artefacts)``).

Set-up (process start to the window's start) loads the program, builds
or loads its kernels and runs one warm-up search of the cell's shapes.
The window then runs whole searches back to back until ``--seconds``
have passed; a ``trials_per_s`` metric (``trials_per_s.<x>``) is every
trial of the window over the time to the end of its last search.  ``--trace 1`` profiles part of the
window (the traffic's ``trace``) and reports the per-layer metrics
instead.  After the window the plain reference judges the searches
(the entry's ``judge``); the numbers it compared, each beside its limit
(the configuration's ``limits``), are the last lines on standard error
and the ``checks`` key, last in the result, which is the last line on
standard output.

Without a CUDA card (or with fewer than the cell's chips) the run exits
2 and prints no result; if ``sys.modules`` holds JAX or the JAX package
once the window has closed it exits 3.  Kernel libraries and the run's
traces live under ``build/portbench/`` in the checkout."""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / "build" / "portbench"
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "hyperopt_tpu"})


def _environment():
    """Fixed cache directories inside the checkout, CUPTI torn down after
    each profiler session, no Flax from ``transformers``, and one thread
    in each host thread pool (the load comes from one process); set
    before numpy and torch are imported."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["TEARDOWN_CUPTI"] = "1"
    os.environ["USE_FLAX"] = "0"
    os.environ["HYPEROPT_TPU_COMPILE_CACHE"] = str(CACHE / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    for p in (str(HERE), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load(workload):
    """The cell ``workload`` and everything it names, found by name."""
    _environment()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = [w for w in bench["workloads"] if w["name"] == workload]
    if not cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[0]
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())

    def mine(m):
        return cell["name"] in m.get("workloads", [cell["name"]])

    return types.SimpleNamespace(
        cell=cell, traffic=traffic,
        cfg=json.loads((HERE / "configs" / f"{cell['config']}.json").read_text()),
        config=_load(HERE / "configs" / f"{cell['config']}.py", f"_config_{cell['config']}"),
        entry=_load(HERE / "entries" / f"{traffic['entry']}.py", f"_entry_{traffic['entry']}"),
        e2e=[m for m in bench["end_to_end"] if mine(m)],
        layer=[m for m in bench["per_layer"] if mine(m)])


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card(chips):
    """``"cuda"`` when the host has ``chips`` CUDA cards, else None."""
    import torch

    if torch.cuda.is_available() and torch.cuda.device_count() >= int(chips):
        return "cuda"
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(f"portbench: the cell needs {chips} CUDA card(s); found {found}", file=sys.stderr)
    return None


def main(argv=None, device=None):
    """One run; ``device`` (tests only) skips the look for a card and runs
    on that device."""
    args = parse(argv)
    c = load(args.workload)
    device = device or card(c.cell["chips"])
    if device is None:
        return 2

    import torch

    import drive
    import profiling
    import roofline
    from reference import check

    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    entry = c.entry.Entry(c.cfg, c.config.fn, device)
    t_loaded = time.perf_counter()
    entry.search(drive.search_seed(args.seed, -1))
    sync()

    traced = args.trace == 1
    art = {"cfg": c.cfg, "roofline": roofline, "cache": str(CACHE), "batch": int(c.cfg["batch"]),
           "n_startup": int(c.cfg["n_startup"])}
    session = profiling.Session() if traced else None
    host_marks = []
    first = None
    if traced:
        def first(s):
            return entry.traced(s, c.traffic["trace"], session, art, host_marks)

    setup_s = time.perf_counter() - _T_START
    handles, t0, ends = drive.window(entry, args.seed, args.seconds, sync, first)
    n_trials = sum(entry.trials(h) for _, h in handles)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    metrics = {}
    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
                   "count": int(c.cell["chips"]) if on_card else 1,
                   "memory_peak_bytes": int(peak)}
    breakdown = None
    if traced:
        art.update(events=session.events, busy_s=session.busy_s(), window_s=session.window_s)
        for m in c.layer:
            v = _load(HERE / "metrics" / f"{m['name']}.py", f"_metric_{m['name']}").read(art)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        device_info.update(busy_s=art["busy_s"], window_s=art["window_s"])
        breakdown = session.breakdown(host_marks)
    else:
        values = {"trials_per_s": n_trials / (ends[-1] - t0), "setup_s": setup_s}
        for m in c.e2e:
            metrics[m["name"]] = {"value": float(values[m["name"].split(".")[0]]),
                                  "unit": m["unit"]}

    searches = [entry.extract(h, s) for s, h in handles]
    del handles
    if on_card:
        torch.cuda.empty_cache()
    t_end = ends[-1]
    numbers = c.entry.judge(c.cfg, c.config.objective, searches,
                            int(c.traffic["check_proposals"]), args.seed, device=dev)
    limits = c.cfg["limits"]
    ok = check.correct(numbers, limits)
    failed = sum(int(sum(1 for x in s.losses if not math.isfinite(x))) for s in searches)
    each = [b - a for a, b in zip([t0] + ends[:-1], ends)]
    print(f"portbench: {c.cell['name']} seed {args.seed}: set-up {setup_s:.3f} s (program "
          f"loaded {t_loaded - _T_START:.3f} s, warm-up search {t0 - t_loaded:.3f} s), window "
          f"{t_end - t0:.3f} s ({len(searches)} searches of {min(each):.3f} / "
          f"{statistics.median(each):.3f} / {max(each):.3f} s), check "
          f"{time.perf_counter() - t_end:.3f} s ({numbers['checked_proposals']} proposals)",
          file=sys.stderr)

    found = sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    checks = {k: {"value": float(numbers[k]), "limit": float(v)} for k, v in limits.items()}
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    out = {"correct": bool(ok), "attempted": int(n_trials), "failed": failed,
           "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
