"""The port's elastic fleet (``fmin_multihost(fleet_dir=...)``) and its
lease plane against the JAX package's.

- leases: claim, heartbeat, and reclaim of a stale lease, with ``os.utime``
  as the fake clock, in the reference's on-disk layout; epoch leases;
- a single-controller fleet equals the collective single run bit for bit,
  a partial final generation included, and a store replays and extends;
- a divergent checksum is detected;
- a store that reference controllers started is finished by port
  controllers (within the parity standard of the reference's own run);
- a controller SIGKILLed mid-generation, resumed by a fleet of another
  size (this file's ``__main__`` is the controller process).

The flight recorder and the watchdog are process-global: each test swaps
in disarmed ones."""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6


def _controller(fleet_dir, max_evals, echo):
    """One fleet controller on branin, on the CPU."""
    from hyperopt_tpu_torch import zoo
    from hyperopt_tpu_torch.parallel import driver

    dom = zoo.ZOO["branin"]
    calls = [0]

    def obj(d):
        calls[0] += 1
        if echo:
            print(f"EVAL {calls[0]}", flush=True)
            time.sleep(0.05)
        return float(dom.objective(d))

    res = driver.fmin_multihost(obj, dom.space, max_evals, batch=8, seed=0,
                                fleet_dir=fleet_dir, n_shards=4, lease_ttl=1.0, device="cpu")
    print("FLEET_OK " + json.dumps({"checksum": res.checksum, "evals": calls[0]}), flush=True)


if __name__ == "__main__":
    _controller(sys.argv[1], int(sys.argv[2]), sys.argv[3:] == ["--echo"])
    sys.exit(0)


from hyperopt_tpu import zoo as ref_zoo  # noqa: E402
from hyperopt_tpu.parallel import driver as ref_driver  # noqa: E402
from hyperopt_tpu.parallel import membership as ref_membership  # noqa: E402
from hyperopt_tpu_torch import chaos, zoo  # noqa: E402
from hyperopt_tpu_torch.exceptions import FleetDegraded  # noqa: E402
from hyperopt_tpu_torch.obs import flight as port_flight, watchdog as port_watchdog  # noqa: E402
from hyperopt_tpu_torch.parallel import driver, fleet, membership  # noqa: E402

DOM = zoo.ZOO["branin"]


@pytest.fixture(autouse=True)
def _disarmed_port_globals(monkeypatch):
    fr = port_flight.FlightRecorder()
    fr.enabled = False
    monkeypatch.setattr(port_flight, "_global", fr)
    monkeypatch.setattr(port_watchdog, "_global", port_watchdog._DISABLED)
    monkeypatch.setattr(chaos, "_plan", None)
    for name in ("HYPEROPT_TPU_CHAOS", "HYPEROPT_TPU_HIST_DTYPE"):
        monkeypatch.delenv(name, raising=False)


def _single(n, seed=3, batch=8, fn=None):
    return driver.fmin_multihost(fn or DOM.objective, DOM.space, n, batch=batch, seed=seed,
                                 _force_single=True, device="cpu")


def _fleet(fdir, n, seed=3, batch=8, fn=None, **kw):
    return driver.fmin_multihost(fn or DOM.objective, DOM.space, n, batch=batch, seed=seed,
                                 fleet_dir=str(fdir), n_shards=kw.pop("n_shards", 4),
                                 device="cpu", **kw)


# ---------------------------------------------------------------------------
# the lease plane
# ---------------------------------------------------------------------------


def _age(path, sec):
    t = time.time() - sec
    os.utime(path, (t, t))


@pytest.mark.parametrize("claimer", ["port", "reference"])
def test_leases_claim_heartbeat_and_reclaim_in_the_reference_layout(claimer, tmp_path):
    mods = {"port": membership, "reference": ref_membership}
    other = "reference" if claimer == "port" else "port"
    a = mods[claimer].FleetMembership(str(tmp_path), owner="a", lease_ttl=5.0)
    b = mods[other].FleetMembership(str(tmp_path), owner="b", lease_ttl=5.0)
    assert a.try_claim(0, 1)
    assert not b.try_claim(0, 1)  # exactly one O_EXCL creator wins
    lease = tmp_path / "fleet" / "gen00000" / "shard1.lease"
    assert lease.read_text().startswith("a\n")
    _age(lease, 4.0)
    a.heartbeat_shard(0, 1)
    assert time.time() - lease.stat().st_mtime < 1.0
    assert b.reclaim_stale(0, 4) == 0  # fresh: not reclaimed
    _age(lease, 6.0)
    assert b.reclaim_stale(0, 4) == 1 and not lease.exists()
    assert b.try_claim(0, 1)
    b.publish(0, 1, b"blob")
    assert (tmp_path / "fleet" / "gen00000" / "shard1.result.pkl").read_bytes() == b"blob"
    assert not lease.exists() and a.read_result(0, 1) == b"blob"
    assert not a.try_claim(0, 1)  # a published shard is never claimed again
    assert a.missing_shards(0, 3) == [0, 2]
    a.write_checksum(0, "abc")
    assert b.read_checksums(0) == {"a": "abc"}
    assert (tmp_path / "fleet" / "gen00000" / "checksum.a").read_text() == "abc"
    a.join()
    b.join()
    assert sorted(a.live_members()) == ["a", "b"]
    _age(tmp_path / "fleet" / "members" / "b", 100.0)
    assert a.live_members() == ["a"]
    assert membership.shard_trials(10, 4, 1) == ref_membership.shard_trials(10, 4, 1)
    assert membership.n_occupied_shards(3, 8) == 3
    assert membership.rotate_for_owner(range(5), "b") == ref_membership.rotate_for_owner(
        range(5), "b")


def test_params_are_write_once(tmp_path):
    path = str(tmp_path / "params.json")
    assert membership.publish_params_once(path, {"b": 1, "a": [1, 2]})
    assert not ref_membership.publish_params_once(path, {"a": [1, 2], "b": 1})
    with pytest.raises(ValueError, match="identical params"):
        membership.publish_params_once(path, {"a": [1, 2], "b": 2})


def test_epoch_leases_fence_a_reclaimed_holder(tmp_path):
    a = membership.EpochLeases(str(tmp_path), "a", lease_ttl=5.0)
    b = membership.EpochLeases(str(tmp_path), "b", lease_ttl=5.0)
    assert a.try_claim("s0") == 1 and b.try_claim("s0") is None
    assert a.heartbeat("s0") and a.verify_held("s0")
    _age(tmp_path / "s0.lease", 6.0)
    assert b.reclaim(["s0"]) == ["s0"]
    assert b.try_claim("s0") == 2
    assert not a.heartbeat("s0") and not a.release("s0")  # fenced off
    assert ref_membership.EpochLeases(str(tmp_path), "c").read_epoch("s0") == 2
    assert b.release("s0") and b.unleased(["s0"]) == ["s0"]


# ---------------------------------------------------------------------------
# the fleet driver
# ---------------------------------------------------------------------------


def test_single_controller_fleet_equals_the_collective_run(tmp_path):
    want = _single(40)
    got = _fleet(tmp_path / "f", 40)
    assert got.checksum == want.checksum
    np.testing.assert_array_equal(got.losses, want.losses)
    params = json.loads((tmp_path / "f" / "fleet" / "params.json").read_text())
    assert params["n_shards"] == 4 and params["batch"] == 8


def test_partial_final_generation(tmp_path):
    want = _single(18)
    got = _fleet(tmp_path / "f", 18)
    assert got.n_evals == 18 and got.checksum == want.checksum
    # the last generation's 2 trials occupy 2 of the 4 shards
    gen2 = tmp_path / "f" / "fleet" / "gen00002"
    assert sorted(f for f in os.listdir(gen2) if f.endswith(".result.pkl")) == [
        "shard0.result.pkl", "shard1.result.pkl"]


def test_store_replays_and_extends(tmp_path):
    _fleet(tmp_path / "f", 24)
    calls = []

    def counted(d):
        calls.append(1)
        return DOM.objective(d)

    got = _fleet(tmp_path / "f", 40, fn=counted)
    assert len(calls) == 16  # the first three generations replay from the store
    assert got.checksum == _single(40).checksum
    with pytest.raises(ValueError, match="identical params"):
        _fleet(tmp_path / "f", 40, seed=4)


def test_divergent_checksum_is_detected(tmp_path):
    evil = membership.FleetMembership(str(tmp_path / "f"), owner="evil")
    evil.write_checksum(0, "deadbeef")  # a controller that folded other bytes
    with pytest.raises(driver.ControllerDivergence, match="diverged after 8 trials"):
        _fleet(tmp_path / "f", 16)


def test_barrier_timeout_degrades(tmp_path):
    holder = membership.FleetMembership(str(tmp_path / "f"), owner="holder", lease_ttl=1000.0)
    assert holder.try_claim(0, 0)  # never published, never stale
    ck = str(tmp_path / "ck.pkl")
    with pytest.raises(FleetDegraded, match="incomplete after"):
        fleet.fleet_fmin(DOM.objective, DOM.space, 8, str(tmp_path / "f"), batch=8, seed=3,
                         n_shards=4, lease_ttl=1000.0, checkpoint_file=ck, poll_interval=0.02,
                         barrier_timeout=0.3, device="cpu")


def test_reference_started_store_is_finished_by_the_port(tmp_path):
    rdom = ref_zoo.ZOO["branin"]
    fdir = str(tmp_path / "f")
    ref_driver.fmin_multihost(rdom.objective, rdom.space, 24, batch=8, seed=3,
                              fleet_dir=fdir, n_shards=4)
    calls = []

    def counted(d):
        calls.append(1)
        return DOM.objective(d)

    got = _fleet(fdir, 40, fn=counted)
    assert len(calls) == 16  # the reference's three generations are replayed
    want = ref_driver.fmin_multihost(rdom.objective, rdom.space, 40, batch=8, seed=3,
                                     _force_single=True)
    np.testing.assert_allclose(got.losses, want.losses, rtol=RTOL, atol=ATOL)
    for l in want.vals:
        np.testing.assert_allclose(got.vals[l], want.vals[l], rtol=RTOL, atol=ATOL)
    # the replayed losses are the reference controllers' own bytes
    np.testing.assert_array_equal(got.losses[:24], want.losses[:24])


def _spawn(fdir, n, echo=False):
    env = {**os.environ, "PYTHONPATH": REPO, "HYPEROPT_TPU_WATCHDOG": "0",
           "JAX_PLATFORMS": "cpu"}
    args = [sys.executable, os.path.abspath(__file__), str(fdir), str(n)]
    return subprocess.Popen(args + (["--echo"] if echo else []), env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_sigkill_mid_generation_then_resume_at_another_size(tmp_path):
    want = driver.fmin_multihost(DOM.objective, DOM.space, 40, batch=8, seed=0,
                                 _force_single=True, device="cpu")
    fdir = tmp_path / "f"
    p = _spawn(fdir, 40, echo=True)
    evals = 0
    deadline = time.monotonic() + 120
    try:
        while evals < 12 and time.monotonic() < deadline:
            line = p.stdout.readline()
            if not line:
                break
            evals += line.startswith("EVAL")
    finally:
        os.kill(p.pid, signal.SIGKILL)
        p.wait(timeout=60)
    assert evals >= 12 and p.returncode == -signal.SIGKILL
    # a fleet of two adopts the store: it replays the published shards,
    # reclaims the dead controller's lease after its TTL, evaluates the rest
    procs = [_spawn(fdir, 40) for _ in range(2)]
    try:
        outs = [q.communicate(timeout=180) for q in procs]
    finally:
        for q in procs:
            q.kill()
    done = []
    for q, (out, err) in zip(procs, outs):
        assert q.returncode == 0, err[-3000:]
        line = next(x for x in out.splitlines() if x.startswith("FLEET_OK"))
        done.append(json.loads(line[len("FLEET_OK "):]))
    assert [d["checksum"] for d in done] == [want.checksum] * 2
    assert sum(d["evals"] for d in done) < 40  # the killed controller's work was kept
