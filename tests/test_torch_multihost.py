"""The port's multi-controller driver against the JAX package's.

- ``payload``: the wire bytes of both formats equal the reference's for
  the same rows, and decode back;
- ``fmin_multihost(_force_single=True)`` against the reference's on
  ``hpob_surrogate`` (batch 16, 48 evaluations) at the parity standard;
- two controller processes over gloo (this file's ``__main__`` is the
  controller) give the single run's checksum, with the history replicated
  and with it split along its capacity axis;
- a checkpoint resumes bit for bit, a reference checkpoint resumes in the
  port and a port checkpoint in the reference;
- an all-failed run raises, ``_timed_gather`` degrades to
  ``FleetDegraded``, and the run telemetry (``obs=``, the knobs,
  ``cfg["compile_cache"]``) is honoured: two armed controllers write
  ``run.p0.jsonl`` and ``run.p1.jsonl``, which ``obs.report --merge``
  renders.

Tolerance: the parity standard against the reference (floats rtol 1e-5,
atol 1e-6, ids and discrete values bitwise); port against port is
bitwise, checksums included.  The flight recorder and the watchdog are
process-global: each test swaps in disarmed ones."""

import json
import os
import pickle
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6
HPOB = "hpob_surrogate"


def _child(rank, port, out, max_evals, batch, seed, obs_path=None):
    """One controller of a two-process gloo run on the CPU; with
    ``obs_path`` an armed one (its stream split per controller)."""
    from hyperopt_tpu_torch import zoo
    from hyperopt_tpu_torch.obs import ObsConfig, RunObs
    from hyperopt_tpu_torch.parallel import driver, multihost

    multihost.initialize(f"127.0.0.1:{port}", 2, rank, device="cpu", timeout=120)
    dom = zoo.ZOO[HPOB]
    # a built bundle with no stream passes through unsplit, so its
    # registry can be read after the run released its namespace
    obs = obs_path or RunObs(ObsConfig(), run_id=f"mh-p{rank}")
    res = driver.fmin_multihost(dom.objective, dom.space, max_evals, batch=batch, seed=seed,
                                obs=obs)
    sharded = None if obs_path else obs.metrics.gauge("suggest.hist_sharded").value
    with open(f"{out}.{rank}", "w") as f:
        json.dump({"checksum": res.checksum, "losses": res.losses.tolist(),
                   "hist_sharded": sharded}, f)


if __name__ == "__main__":
    _child(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], *map(int, sys.argv[4:7]),
           *sys.argv[7:8])
    sys.exit(0)


from hyperopt_tpu import zoo as ref_zoo  # noqa: E402
from hyperopt_tpu.parallel import driver as ref_driver, payload as ref_payload  # noqa: E402
from hyperopt_tpu_torch import chaos, zoo  # noqa: E402
from hyperopt_tpu_torch.exceptions import AllTrialsFailed, FleetDegraded  # noqa: E402
from hyperopt_tpu_torch.obs import flight as port_flight, watchdog as port_watchdog  # noqa: E402
from hyperopt_tpu_torch.parallel import driver, multihost, payload  # noqa: E402


@pytest.fixture(autouse=True)
def _disarmed_port_globals(monkeypatch):
    fr = port_flight.FlightRecorder()
    fr.enabled = False
    monkeypatch.setattr(port_flight, "_global", fr)
    monkeypatch.setattr(port_watchdog, "_global", port_watchdog._DISABLED)
    monkeypatch.setattr(chaos, "_plan", None)
    for name in ("HYPEROPT_TPU_CHAOS", "HYPEROPT_TPU_PAYLOAD", "HYPEROPT_TPU_ALLGATHER_TIMEOUT",
                 "HYPEROPT_TPU_HIST_SHARD_MIN", "HYPEROPT_TPU_HIST_DTYPE", "HYPEROPT_TPU_OBS"):
        monkeypatch.delenv(name, raising=False)


def _port_run(n, batch=16, seed=3, **kw):
    dom = zoo.ZOO[HPOB]
    return driver.fmin_multihost(kw.pop("fn", dom.objective), dom.space, n, batch=batch,
                                 seed=seed, _force_single=True, device="cpu", **kw)


def _ref_run(n, batch=16, seed=3, **kw):
    dom = ref_zoo.ZOO[HPOB]
    return ref_driver.fmin_multihost(dom.objective, dom.space, n, batch=batch, seed=seed,
                                     _force_single=True, **kw)


def _assert_close_runs(want, got):
    assert got.n_evals == want.n_evals
    np.testing.assert_allclose(got.losses, want.losses, rtol=RTOL, atol=ATOL)
    for l in want.vals:
        np.testing.assert_allclose(got.vals[l], want.vals[l], rtol=RTOL, atol=ATOL, err_msg=l)
        np.testing.assert_array_equal(got.active[l], want.active[l], err_msg=l)


# ---------------------------------------------------------------------------
# payload
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["u8", "f32"])
@pytest.mark.parametrize("L", [1, 6, 7, 8, 15])
def test_payload_bytes_equal_the_reference(fmt, L):
    rng = np.random.default_rng(L)
    W = 9
    losses = rng.normal(size=W).astype(np.float32)
    losses[2] = np.nan
    losses[5] = np.inf
    active = rng.uniform(size=(W, L)) > 0.4
    evaluated = np.arange(W) < 7
    got = payload.to_wire(losses, active, evaluated, fmt)
    want = ref_payload.to_wire(losses, active, evaluated, fmt)
    assert got.dtype == np.uint8 and got.tobytes() == want.tobytes()
    assert payload.row_nbytes(L, fmt) == ref_payload.row_nbytes(L, fmt) == got.shape[1]
    assert payload.mask_nbytes(L) == ref_payload.mask_nbytes(L)
    l2, a2, e2 = payload.from_wire(got, L, fmt)
    assert l2.tobytes() == losses.tobytes()
    np.testing.assert_array_equal(a2, active)
    np.testing.assert_array_equal(e2, evaluated)


def test_wire_format_honours_the_knob(monkeypatch):
    assert payload.wire_format() == "u8"
    monkeypatch.setenv("HYPEROPT_TPU_PAYLOAD", "F32")
    assert payload.wire_format() == ref_payload.wire_format() == "f32"
    monkeypatch.setenv("HYPEROPT_TPU_PAYLOAD", "bits")
    with pytest.raises(ValueError, match="'u8' or 'f32'"):
        payload.wire_format()


def test_fold_generation_matches_the_reference():
    labels = ("a", "b")
    hists = []
    for mod in (payload, ref_payload):
        hist = {"losses": np.full(8, np.inf, np.float32), "has_loss": np.zeros(8, bool),
                "vals": {l: np.zeros(8, np.float32) for l in labels},
                "active": {l: np.zeros(8, bool) for l in labels}}
        raw = np.full(8, np.nan, np.float32)
        mod.fold_generation(hist, raw, 2, labels, {"a": np.arange(3.0), "b": np.ones(3)},
                            np.asarray([0.5, np.nan, -1.0], np.float32),
                            np.asarray([[True, False], [True, True], [False, True]]))
        hists.append((hist, raw))
    (h1, r1), (h2, r2) = hists
    assert r1.tobytes() == r2.tobytes()
    np.testing.assert_array_equal(h1["losses"], h2["losses"])
    np.testing.assert_array_equal(h1["has_loss"], h2["has_loss"])
    for l in labels:
        np.testing.assert_array_equal(h1["vals"][l], h2["vals"][l])
        np.testing.assert_array_equal(h1["active"][l], h2["active"][l])


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------


def test_force_single_matches_the_reference():
    want = _ref_run(48)
    got = _port_run(48)
    _assert_close_runs(want, got)
    assert got.best_loss == pytest.approx(want.best_loss, rel=RTOL, abs=ATOL)
    assert got.best.keys() == want.best.keys()
    # the generation seeds and the digest's byte order are the reference's
    assert [driver._gen_seed(7, g) for g in range(4)] == [ref_driver._gen_seed(7, g)
                                                          for g in range(4)]
    assert driver._default_cfg(16) == ref_driver._default_cfg(16)
    assert driver._default_cfg(1) == ref_driver._default_cfg(1)
    t = got.to_trials()
    assert len(t.trials) == 48 and t.trials[0]["misc"]["cmd"] == ("fmin_multihost", None)
    assert t.best_trial["result"]["loss"] == got.best_loss
    assert _port_run(48).checksum == got.checksum  # deterministic


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _two_controllers(tmp_path, env_extra=(), obs_path=None, max_evals=48):
    env = {**os.environ, "PYTHONPATH": REPO, "HYPEROPT_TPU_WATCHDOG": "0",
           "JAX_PLATFORMS": "cpu", **dict(env_extra)}
    port, out = _free_port(), str(tmp_path / "out")
    extra = [obs_path] if obs_path else []
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(port),
                               out, str(max_evals), "16", "3", *extra], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        results = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, results):
        assert p.returncode == 0, err[-3000:]
    return out


@pytest.mark.parametrize("hist_shard_min", [None, "64"])
def test_two_controllers_over_gloo_give_the_single_checksum(hist_shard_min, tmp_path):
    want = _port_run(48)
    # cap 128 splits over 2 at a minimum of 64
    out = _two_controllers(tmp_path, {"HYPEROPT_TPU_HIST_SHARD_MIN": hist_shard_min}
                           if hist_shard_min is not None else ())
    for r in range(2):
        with open(f"{out}.{r}") as f:
            got = json.load(f)
        assert got["checksum"] == want.checksum
        np.testing.assert_array_equal(np.asarray(got["losses"], np.float32), want.losses)
        assert got["hist_sharded"] == (hist_shard_min is not None)


def test_checkpoint_resume_is_bitwise(tmp_path):
    ck = str(tmp_path / "ck.pkl")
    want = _port_run(48)
    part = _port_run(32, checkpoint_file=ck)
    assert part.n_evals == 32
    with open(ck, "rb") as f:
        state = pickle.load(f)
    assert state["n_done"] == 32 and set(state) == {
        "run_params", "n_done", "losses", "has_loss", "raw_losses", "vals", "active"}
    got = _port_run(48, checkpoint_file=ck)
    assert got.checksum == want.checksum
    with pytest.raises(ValueError, match="identical run parameters"):
        _port_run(64, seed=4, checkpoint_file=ck)
    _port_run(50, checkpoint_file=str(tmp_path / "odd.pkl"))
    with pytest.raises(ValueError, match="partial final generation"):
        _port_run(64, checkpoint_file=str(tmp_path / "odd.pkl"))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_checkpoint_resumes_in_the_other_package(writer, tmp_path):
    ck = str(tmp_path / "ck.pkl")
    if writer == "reference":
        _ref_run(32, checkpoint_file=ck)
        got = _port_run(48, checkpoint_file=ck)
        want = _ref_run(48)
    else:
        _port_run(32, checkpoint_file=ck)
        got = _ref_run(48, checkpoint_file=ck)
        want = _port_run(48)
    _assert_close_runs(want, got)
    # the resumed run replays the writer's own bytes
    np.testing.assert_array_equal(got.losses[:32], want.losses[:32])


def test_all_failed_raises():
    def boom(_):
        raise RuntimeError("objective down")

    with pytest.raises(AllTrialsFailed, match="all 8 trials failed"):
        _port_run(8, batch=4, fn=boom)


def test_timed_gather_degrades_to_fleet_degraded():
    obs = driver.RunObs()
    assert driver._timed_gather(lambda: 42, None, "x", obs, lambda: None) == 42
    assert driver._timed_gather(lambda: 42, 5.0, "x", obs, lambda: None) == 42
    release = threading.Event()
    saved = []

    def hung():
        release.wait(30)  # the peer never arrives

    def on_timeout():
        saved.append(1)
        return True

    t0 = time.monotonic()
    with pytest.raises(FleetDegraded, match="restart the surviving fleet"):
        driver._timed_gather(hung, 0.2, "results", obs, on_timeout)
    assert time.monotonic() - t0 < 5.0 and saved == [1]
    assert obs.counter("allgather.timeouts").value == 1
    with pytest.raises(FleetDegraded, match="NO checkpoint was written"):
        driver._timed_gather(hung, 0.2, "results", obs, lambda: False)
    release.set()
    obs.finish()


def test_allgather_timeout_knob_is_read(monkeypatch):
    from hyperopt_tpu_torch import _env
    from hyperopt_tpu import _env as ref_env

    for raw in ("", "off", "2.5"):
        monkeypatch.setenv("HYPEROPT_TPU_ALLGATHER_TIMEOUT", raw)
        assert _env.parse_allgather_timeout() == ref_env.parse_allgather_timeout()
    monkeypatch.setenv("HYPEROPT_TPU_ALLGATHER_TIMEOUT", "-1")
    with pytest.raises(ValueError, match="positive timeout"):
        _env.parse_allgather_timeout()


def test_unported_telemetry_options_raise(monkeypatch, tmp_path):
    """The telemetry options this test once found refused are honoured:
    ``obs=`` and ``HYPEROPT_TPU_OBS`` stream the run, and
    ``cfg["compile_cache"]`` names the kernel build directory without
    changing the run."""
    from hyperopt_tpu_torch import _build
    from hyperopt_tpu_torch.obs import read_jsonl

    want = _port_run(8)
    got = _port_run(8, obs=str(tmp_path / "a.jsonl"))
    assert got.checksum == want.checksum
    kinds = {r["kind"] for r in read_jsonl(str(tmp_path / "a.jsonl"))}
    assert {"span", "metrics"} <= kinds
    try:
        assert _port_run(8, cfg={"compile_cache": str(tmp_path / "cc")}).checksum == want.checksum
        assert _build.build_dir() == (tmp_path / "cc").resolve()
    finally:
        _build.set_build_dir(None)
    monkeypatch.setenv("HYPEROPT_TPU_OBS", str(tmp_path / "b.jsonl"))
    assert _port_run(8).checksum == want.checksum
    assert (tmp_path / "b.jsonl").stat().st_size > 0


def test_two_armed_controllers_write_their_own_streams_and_merge(tmp_path):
    """``fmin_multihost(obs=run.jsonl)`` on two gloo controllers: each
    writes ``run.p<i>.jsonl`` under run id ``mh-p<i>``, and the port's
    ``obs.report --merge`` renders the pair as the reference's does."""
    from hyperopt_tpu.obs import report as ref_report
    from hyperopt_tpu_torch.obs import read_jsonl, report

    path = str(tmp_path / "run.jsonl")
    out = _two_controllers(tmp_path, obs_path=path, max_evals=32)
    with open(f"{out}.0") as f0, open(f"{out}.1") as f1:
        assert json.load(f0)["checksum"] == json.load(f1)["checksum"]
    streams = []
    for r in range(2):
        p = str(tmp_path / f"run.p{r}.jsonl")
        recs = read_jsonl(p)
        assert {rec.get("run_id") for rec in recs if rec.get("run_id")} == {f"mh-p{r}"}
        streams.append((p, recs))
    text = report.render_merged(streams)
    assert "run.p0.jsonl" in text and "run.p1.jsonl" in text
    assert text == ref_report.render_merged(streams)
    assert report.main(["--merge", *(p for p, _ in streams)]) == 0


def test_multihost_helpers_outside_a_process_group():
    import jax

    assert not multihost.is_initialized()
    assert multihost.process_index() == 0 and multihost.process_count() == 1
    from hyperopt_tpu_torch.parallel import sharding

    cpu = sharding.make_mesh(devices=["cpu", "cpu"])
    keys = multihost.global_key_batch(9, 6, cpu)
    want = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(9), i))(
        jax.numpy.arange(6, dtype=jax.numpy.uint32))
    np.testing.assert_array_equal(keys.numpy(), np.asarray(want))
    placed = multihost.replicate_global({"a": np.arange(4.0)}, cpu,
                                        spec=sharding.P(("trials", "cand")))
    assert [p.tolist() for p in placed["a"].parts] == [[0.0, 1.0], [2.0, 3.0]]
    with pytest.raises(ValueError, match="coordinator_address"):
        multihost.initialize(device="cpu")
