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
from hyperopt_tpu_torch.obs import prober
from hyperopt_tpu_torch.service import FleetReplica, StudyScheduler, server
from hyperopt_tpu_torch.service.server import ServiceHTTPServer

PKG = pathlib.Path(port.__file__).resolve().parent
REPO = PKG.parent


def test_import_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, hyperopt_tpu_torch, hyperopt_tpu_torch.convert, "
            "hyperopt_tpu_torch.zoo, hyperopt_tpu_torch.megakernel, "
            "hyperopt_tpu_torch.device_fmin, "
            "hyperopt_tpu_torch.quant, hyperopt_tpu_torch.service.scheduler, "
            "hyperopt_tpu_torch.algos.algobase, hyperopt_tpu_torch.algos.anneal, "
            "hyperopt_tpu_torch.algos.mix, hyperopt_tpu_torch.algos.atpe, "
            "hyperopt_tpu_torch.criteria, hyperopt_tpu_torch.retry, hyperopt_tpu_torch.chaos, "
            "hyperopt_tpu_torch.obs, hyperopt_tpu_torch.obs.flight, "
            "hyperopt_tpu_torch.obs.metrics, hyperopt_tpu_torch.obs.events, "
            "hyperopt_tpu_torch.obs.trace, hyperopt_tpu_torch.obs.watchdog, "
            "hyperopt_tpu_torch.filestore, hyperopt_tpu_torch.worker, "
            "hyperopt_tpu_torch.parallel, hyperopt_tpu_torch.parallel.executor, "
            "hyperopt_tpu_torch.parallel.sharding, hyperopt_tpu_torch.parallel.payload, "
            "hyperopt_tpu_torch.parallel.multihost, hyperopt_tpu_torch.parallel.driver, "
            "hyperopt_tpu_torch.parallel.membership, hyperopt_tpu_torch.parallel.fleet, "
            "hyperopt_tpu_torch.graphviz, hyperopt_tpu_torch.graphviz_mod, "
            "hyperopt_tpu_torch.service, hyperopt_tpu_torch.service.server, "
            "hyperopt_tpu_torch.service.client, hyperopt_tpu_torch.service.journal, "
            "hyperopt_tpu_torch.service.integrity, hyperopt_tpu_torch.service.scrub, "
            "hyperopt_tpu_torch.service.overload, hyperopt_tpu_torch.service.spacespec, "
            "hyperopt_tpu_torch.service.compile_plane, hyperopt_tpu_torch.obs.reqtrace, "
            "hyperopt_tpu_torch.obs.slo, hyperopt_tpu_torch.obs.serve, "
            "hyperopt_tpu_torch.obs.tenant, hyperopt_tpu_torch.obs.load, "
            "hyperopt_tpu_torch.obs.quality, hyperopt_tpu_torch.service.fleet, "
            "hyperopt_tpu_torch.obs.profiler, hyperopt_tpu_torch.obs.devmem, "
            "hyperopt_tpu_torch.obs.health, hyperopt_tpu_torch.obs.export, "
            "hyperopt_tpu_torch.obs.report, hyperopt_tpu_torch.obs.trajectory, "
            "hyperopt_tpu_torch.progress, hyperopt_tpu_torch._build, "
            "hyperopt_tpu_torch.obs.prober, hyperopt_tpu_torch.obs.top, "
            "hyperopt_tpu_torch.plotting, hyperopt_tpu_torch.pallas_ei; "
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


def test_default_device_entry_points_raise_without_cuda(tmp_path):
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
        lambda: ServiceHTTPServer(0),
        lambda: server.main(["--port", "0"]),
        lambda: StudyScheduler(store_root=str(tmp_path)),
        lambda: FleetReplica(str(tmp_path / "fleet"), lease_ttl=1.0),
        lambda: server.main(["--port", "0", "--fleet", "--store", str(tmp_path / "fleet")]),
        lambda: prober.local_digest(),
        lambda: prober.main(["--regen-golden"]),
        lambda: convert.cohort_stack_from_numpy(
            {"vals": {}, "active": {}, "losses": np.zeros((1, 16), np.float32),
             "has_loss": np.zeros((1, 16), bool)}),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not (tmp_path / "fleet").exists()  # the fleet raised before touching its store
    assert port.Trials(device="cpu").device.type == "cpu"


def test_backend_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device, so the default device is valid")
    from hyperopt_tpu_torch import filestore, worker, zoo
    from hyperopt_tpu_torch.parallel import ExecutorTrials

    calls = [
        lambda: filestore.FileTrials(tmp_path),
        lambda: ExecutorTrials(),
        lambda: worker.FileWorker(tmp_path),
        # an objective given host numbers fits on the card unless told
        lambda: zoo.ZOO["ml_logreg_cv"].objective({"lr": 0.1, "l2": 0.01, "momentum": 0.5}),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_multi_device_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device, so the default device is valid")
    from hyperopt_tpu_torch.parallel import fmin_multihost, sharding

    space = {"x": hp.uniform("x", 0, 1)}
    calls = [
        lambda: fmin_multihost(lambda d: d["x"], space, 4, batch=2, _force_single=True),
        lambda: fmin_multihost(lambda d: d["x"], space, 4, batch=2, fleet_dir=tmp_path / "f"),
        lambda: sharding.make_mesh(),
        lambda: sharding.suggest_mesh(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not (tmp_path / "f").exists()  # the fleet raised before touching its store
    assert sharding.suggest_mesh(device="cpu").devices.flat[0].type == "cpu"


def test_rand_and_tpe_run_where_the_trials_live():
    space = {"x": hp.uniform("x", 0, 1), "c": hp.choice("c", [0, 1])}
    t = port.Trials(device="cpu")
    port.fmin(lambda d: d["x"] + d["c"], space, algo=port.rand.suggest, max_evals=3,
              trials=t, rstate=0, show_progressbar=False)
    assert t.history_object(("c", "x")).device.type == "cpu"
    assert len(t.trials) == 3


@pytest.mark.parametrize("files", [
    ("tests/test_torch_megakernel.py", "tests/test_megakernel.py"),
    # the backends' process-global flight recorder, watchdog and chaos plan
    ("tests/test_torch_backends.py", "-k", "reserve or timeout or retries or chaos_io",
     "tests/test_flight.py", "tests/test_chaos.py"),
])
def test_port_tests_leave_the_jax_package_tests_alone(files):
    """A port test must not change how the JAX package's own tests behave:
    run the reference's tests after the port's in one process (as an xdist
    worker may), and all of them pass."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO)}
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:xdist",
         "-p", "no:randomly", *files],
        env=env, cwd=str(REPO), capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-4000:]
