"""Put the harness's modules (``portbench/``) and the repository root on
the path, and build tiny copies of the benchmark for harness runs."""

import json
import pathlib
import shutil
import subprocess
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
REPO = BENCH.parent
for p in (str(BENCH), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: the cells at sizes a CPU test holds: a 40-trial device-loop search and a
#: batch-64 driver search of 256 evaluations
TINY = {
    "branin": {"max_evals": 40, "n_EI_candidates": 64, "ei_diff_shapes": [[2, 64, 41]]},
    "lcbench": {"max_evals": 256, "batch": 64, "n_startup": 64, "n_EI_candidates": 16},
}


def tiny_config(name):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg.update(TINY[name])
    return cfg


def make_tiny_copy(root):
    """``root/portbench`` and ``root/BENCHMARK.json``: the benchmark with
    every configuration cut to its CPU size and a traced window that fits
    a search of 40 steps."""
    shutil.copytree(BENCH, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    for name in TINY:
        (root / "portbench" / "configs" / f"{name}.json").write_text(
            json.dumps(tiny_config(name)))
    t = root / "portbench" / "traffic" / "device_loop.json"
    mix = json.loads(t.read_text())
    mix.update(check_proposals=24, trace={"skip_chunks": 1, "chunks": 2})
    t.write_text(json.dumps(mix))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def run_harness(root, args, prelude="", env=None, timeout=300, module="run"):
    """Run ``<module>.main(args, device="cpu")`` of the copy under ``root``
    in a fresh process (``prelude`` runs first: a fault to plant); returns
    ``(returncode, last JSON line or None, stderr)``."""
    code = (f"import sys; sys.path.insert(0, {str(root / 'portbench')!r}); "
            f"sys.path.insert(1, {str(REPO)!r})\n{prelude}\n"
            f"import {module}; sys.exit({module}.main({list(args)!r}, device='cpu'))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=timeout, cwd=root, env=env)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    return proc.returncode, (json.loads(lines[-1]) if lines else None), proc.stderr


@pytest.fixture
def tiny(tmp_path):
    return make_tiny_copy(tmp_path)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
