"""The harness end to end on the CPU at tiny sizes (the look for a card
skipped): both cells come out correct; the bf16-history control and a
fault planted under the timed path come out not correct; a new
configuration, traffic mix, entry module and metric are found by name
without any file edited; and the command itself, with no card, fails and
prints no result."""

import json
import os
import subprocess
import sys

import pytest

from conftest import REPO, make_tiny_copy, run_harness

RATE = {"branin.device_loop": "trials_per_s.loop", "lcbench.batch10240": "trials_per_s.batch"}
CELLS = list(RATE)


def _args(cell, seed=4_000_000_017, trace=0):
    return ["--workload", cell, "--seed", str(seed), "--seconds", "0.5", "--trace", str(trace)]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_and_prints_its_checks_last(tiny, cell):
    rc, out, err = run_harness(tiny, _args(cell))
    assert rc == 0, err[-3000:]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {RATE[cell], "setup_s"}
    assert list(out)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check fold_errors")


@pytest.mark.parametrize("cell", CELLS)
def test_bf16_history_control_is_not_correct(tiny, cell):
    env = {**os.environ, "HYPEROPT_TPU_HIST_DTYPE": "bf16"}
    rc, out, err = run_harness(tiny, _args(cell), env=env)
    assert rc == 0, err[-3000:]
    assert out["correct"] is False
    assert out["checks"]["draw_gap"]["value"] > 10 * out["checks"]["draw_gap"]["limit"]


# each fault alters an answer where it is produced, under the timed path
FAULTS = {
    "proposal": ("from hyperopt_tpu_torch.algos import tpe\n"
                 "_sel = tpe._select_candidate\n"
                 "tpe._select_candidate = lambda k, s, ei, cfg: _sel(k, s, -ei, cfg)"),
    "loss": ("from hyperopt_tpu_torch import device_fmin\n"
             "from hyperopt_tpu_torch.parallel import driver\n"
             "_run = device_fmin.DeviceLoopRunner.run_chunk\n"
             "def _chunk(self, *a):\n"
             "    state, rows = _run(self, *a)\n"
             "    rows[:, -1] *= 1.01\n"
             "    return state, rows\n"
             "device_fmin.DeviceLoopRunner.run_chunk = _chunk\n"
             "_ev = driver._evaluate\n"
             "def _scaled(*a, **k):\n"
             "    losses, act = _ev(*a, **k)\n"
             "    return losses * 1.01, act\n"
             "driver._evaluate = _scaled"),
    "half_batch": ("from hyperopt_tpu_torch.parallel import driver\n"
                   "_ev = driver._evaluate\n"
                   "def _half(*a, **k):\n"
                   "    losses, act = _ev(*a, **k)\n"
                   "    losses[1::2] = float('nan')\n"
                   "    return losses, act\n"
                   "driver._evaluate = _half"),
}


@pytest.mark.parametrize("cell, fault", [(c, f) for c in CELLS for f in ("proposal", "loss")]
                         + [("lcbench.batch10240", "half_batch")])
def test_planted_fault_is_not_correct(tiny, cell, fault):
    rc, out, err = run_harness(tiny, _args(cell), prelude=FAULTS[fault])
    assert rc == 0, err[-3000:]
    assert out["correct"] is False, out["checks"]


# a new entry: the device loop's searches issued through ``fmin_device``,
# judged by their losses and folds
NEW_ENTRY = """
from entries import fmin_device_loop as base
from reference import check


class Entry(base.Entry):
    def search(self, seed, early_stop_fn=None):
        from hyperopt_tpu_torch import device_fmin
        return device_fmin.fmin_device(
            self.fn, self.space, max_evals=int(self.cfg["max_evals"]), seed=seed,
            n_startup_jobs=int(self.cfg["n_startup"]),
            n_EI_candidates=int(self.cfg["n_EI_candidates"]), gamma=float(self.cfg["gamma"]),
            linear_forgetting=int(self.cfg["LF"]), return_trials=True, device=self.device)

    def traced(self, seed, spec, session, art, host_marks):
        session.start()
        handle = self.search(seed)
        session.stop()
        return handle


def judge(cfg, objective, searches, n_check, seed, device="cpu"):
    out = check.numbers()
    for s in searches:
        check.judge_search(out, cfg, objective, check.tpe.labels_of(cfg["space"]), s)
    out["checked_proposals"] = 0
    return out
"""


def test_additions_are_found_by_name(tmp_path):
    root = make_tiny_copy(tmp_path)
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "branin.json").read_text())
    cfg.update(max_evals=30, n_EI_candidates=32, ei_diff_shapes=[[2, 32, 31]])
    (pb / "configs" / "branin_small.json").write_text(json.dumps(cfg))
    (pb / "configs" / "branin_small.py").write_text((pb / "configs" / "branin.py").read_text())
    (pb / "traffic" / "short_loop.json").write_text(json.dumps(
        {"entry": "fmin_device_short", "why": "t", "check_proposals": 8, "trace": {}}))
    (pb / "entries" / "fmin_device_short.py").write_text(NEW_ENTRY)
    (pb / "metrics" / "window_ms.new.py").write_text(
        "def read(art):\n    return 1e3 * art['window_s'] if art.get('window_s') else None\n")
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "branin_small", "source": "https://example.org/x",
                             "file": "portbench/configs/branin_small.json", "reduced": [],
                             "why": "t"})
    bench["workloads"].append({"name": "branin_small.short_loop", "config": "branin_small",
                               "traffic": "short_loop", "chips": 1, "why": "t"})
    rate = next(m for m in bench["end_to_end"] if m["name"] == "trials_per_s.loop")
    rate["workloads"].append("branin_small.short_loop")
    bench["per_layer"].append({"name": "window_ms.new", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "device",
                               "moves": "trials_per_s.loop",
                               "workloads": ["branin_small.short_loop"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, out, err = run_harness(root, _args("branin_small.short_loop", trace=1))
    assert rc == 0, err[-3000:]
    assert out["correct"] is True
    assert "window_ms.new" in out["metrics"]
    assert {p: p.read_bytes() for p in before} == before  # no file edited


def test_command_without_a_card_fails_and_prints_no_result():
    code = "import torch, sys; sys.exit(0 if torch.cuda.is_available() else 1)"
    if subprocess.run([sys.executable, "-c", code]).returncode == 0:
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "portbench/run.py"] + _args(CELLS[0]), cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert not [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card_is_correct(card, cell):
    proc = subprocess.run([sys.executable, "portbench/run.py"] + _args(cell, trace=0)[:-4]
                          + ["--seconds", "3", "--trace", "0"], cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"


@pytest.mark.parametrize("cell", CELLS)
def test_controls_are_not_correct(tiny, cell):
    rc, out, err = run_harness(tiny, _args(cell), module="control")
    assert rc == 0, err[-3000:]
    assert out["history_bf16_correct"] is False and out["objective_bf16_correct"] is False
    assert out["objective_bf16"]["loss_gap"] > 10 * out["limits"]["loss_gap"]
