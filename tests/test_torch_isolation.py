"""The port stands alone: importing it loads neither JAX nor the JAX
package, no source file under it imports either, and its entry points
run on CUDA by default, so without a card they raise unless the caller
asks for the CPU."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import hyperopt_tpu_torch as port
from hyperopt_tpu_torch import convert, hp, spaces
from hyperopt_tpu_torch.base import PaddedHistory
from hyperopt_tpu_torch.service import StudyScheduler

PKG = pathlib.Path(port.__file__).resolve().parent
REPO = PKG.parent


def test_import_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, hyperopt_tpu_torch, hyperopt_tpu_torch.convert, "
            "hyperopt_tpu_torch.zoo, hyperopt_tpu_torch.megakernel, "
            "hyperopt_tpu_torch.device_fmin, "
            "hyperopt_tpu_torch.quant, hyperopt_tpu_torch.service.scheduler, "
            "hyperopt_tpu_torch.algos.algobase, hyperopt_tpu_torch.algos.anneal, "
            "hyperopt_tpu_torch.algos.mix, hyperopt_tpu_torch.algos.atpe, "
            "hyperopt_tpu_torch.criteria; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'hyperopt_tpu')]; "
            "assert not bad, bad")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=str(REPO),
                   timeout=120)


def test_no_source_file_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py"))
    assert files
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "hyperopt_tpu"), (path, name)


def test_default_device_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device, so the default device is valid")
    space = {"x": hp.uniform("x", 0, 1)}
    calls = [
        lambda: port.Trials(),
        lambda: PaddedHistory(("x",)),
        lambda: spaces.sample(space, 0),
        lambda: port.fmin(lambda d: d["x"], space, max_evals=2, show_progressbar=False),
        lambda: port.generate_trials_to_calculate([{"x": 0.5}]),
        lambda: StudyScheduler(),
        lambda: StudyScheduler(widen=True),
        lambda: port.fmin(lambda d: d["x"], space, algo=port.anneal.suggest, max_evals=2,
                          show_progressbar=False),
        lambda: port.fmin_device(lambda d: d["x"], space, 2),
        lambda: port.fmin(lambda d: d["x"], space, max_evals=2, show_progressbar=False,
                          device_loop=True),
        lambda: convert.cohort_stack_from_numpy(
            {"vals": {}, "active": {}, "losses": np.zeros((1, 16), np.float32),
             "has_loss": np.zeros((1, 16), bool)}),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert port.Trials(device="cpu").device.type == "cpu"


def test_rand_and_tpe_run_where_the_trials_live():
    space = {"x": hp.uniform("x", 0, 1), "c": hp.choice("c", [0, 1])}
    t = port.Trials(device="cpu")
    port.fmin(lambda d: d["x"] + d["c"], space, algo=port.rand.suggest, max_evals=3,
              trials=t, rstate=0, show_progressbar=False)
    assert t.history_object(("c", "x")).device.type == "cpu"
    assert len(t.trials) == 3


def test_port_tests_leave_the_jax_package_tests_alone():
    """A port test must not change how the JAX package's own tests behave:
    run the reference's megakernel tests after the port's in one process
    (as an xdist worker may), and both files pass."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO)}
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:xdist",
         "-p", "no:randomly", "tests/test_torch_megakernel.py", "tests/test_megakernel.py"],
        env=env, cwd=str(REPO), capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-4000:]
