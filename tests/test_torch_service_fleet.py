"""The port's replicated serving fleet against the JAX package's: the
pinned study-to-shard map, a two-replica port fleet proposing what the
reference's single scheduler proposes, migration by drain handoff and by
a SIGKILLed replica process (killed at a chaos site) bit for bit with an
undisturbed port scheduler, epoch-WAL chains migrating between the two
packages in both directions over one store root, the ownership fence,
and the fleet's HTTP answers (307 with ``Location``, retryable 503s)
held against the reference's."""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from hyperopt_tpu import zoo as ref_zoo
from hyperopt_tpu.obs.load import read_heat as ref_read_heat
from hyperopt_tpu.service import FleetReplica as RefReplica
from hyperopt_tpu.service import StudyScheduler as RefScheduler
from hyperopt_tpu.service import shard_of as ref_shard_of
from hyperopt_tpu.service.server import ServiceHTTPServer as RefServer
from hyperopt_tpu_torch import zoo
from hyperopt_tpu_torch.base import JOB_STATE_DONE
from hyperopt_tpu_torch.obs.load import read_heat
from hyperopt_tpu_torch.retry import RetryPolicy
from hyperopt_tpu_torch.service import (FleetReplica, ServiceClient, ShardUnavailable,
                                        StaleOwnershipError, StudyScheduler, shard_of)
from hyperopt_tpu_torch.service.client import ServiceUnavailable
from hyperopt_tpu_torch.service.server import ServiceHTTPServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one study per kernel route of the mix: quadratic1 (the fused kernel) and
# the HPO-B surrogate (grouped ei_diff)
MIX = [it for it in zoo.make_study_mix(5) if it.domain.name in ("quadratic1", "hpob_surrogate")]


def _loss(sid_index, tid):
    """A loss that depends on the study and the trial id only, so both
    sides of a comparison fold the same history."""
    return float(((tid * 7919 + sid_index * 104729) % 1009) / 1009.0)


def _replica(root, rid, n_shards=2, lease_ttl=5.0, ref=False, **kw):
    if ref:
        return RefReplica(root, n_shards=n_shards, replica_id=rid, addr=f"http://{rid}",
                          lease_ttl=lease_ttl, scheduler_kwargs={"wave_window": 0.0}, **kw)
    return FleetReplica(root, n_shards=n_shards, replica_id=rid, addr=f"http://{rid}",
                        lease_ttl=lease_ttl, device="cpu",
                        scheduler_kwargs={"wave_window": 0.0}, **kw)


def _server(replica):
    return (RefServer if isinstance(replica, RefReplica) else ServiceHTTPServer)(
        0, fleet=replica)


def _age_lease(replica, shard, sec=60.0):
    t = time.time() - sec
    os.utime(replica.leases._lease_path(f"shard{shard:04d}"), (t, t))


def _kill(replica):
    """What a SIGKILLed replica leaves behind: stale leases and member
    record, no drain, no compaction."""
    for shard in list(replica.schedulers):
        _age_lease(replica, shard)
    os.utime(replica._replica_path(), (time.time() - 600,) * 2)


def _create(server, items):
    sids = []
    for it in items:
        status, p = server.handle("POST", "/study", {"zoo": it.domain.name, "seed": it.seed,
                                                     "n_startup_jobs": 3})
        assert status == 200, p
        sids.append(p["study_id"])
    return sids


def _drive(server, sids, rounds):
    """``rounds`` ask/tell rounds over every study through ``server``;
    returns ``[(study index, tid, params)]``."""
    out = []
    for _ in range(rounds):
        for i, sid in enumerate(sids):
            status, p = server.handle("POST", "/ask", {"study_id": sid})
            assert status == 200, p
            t = p["trials"][0]
            status, p2 = server.handle("POST", "/tell", {"study_id": sid, "tid": t["tid"],
                                                         "loss": _loss(i, t["tid"])})
            assert status == 200, p2
            out.append((i, t["tid"], t["params"]))
    return out


def _single(items, rounds, ref=False):
    """The undisturbed single scheduler's stream over ``items``."""
    sched = RefScheduler(wal=False) if ref else StudyScheduler(device="cpu", wal=False)
    spaces = ref_zoo.ZOO if ref else zoo.ZOO
    sids = [sched.create_study(spaces[it.domain.name].space, seed=it.seed, n_startup_jobs=3)
            for it in items]
    out = []
    for _ in range(rounds):
        for i, sid in enumerate(sids):
            (a,) = sched.ask(sid)
            sched.tell(sid, a["tid"], _loss(i, a["tid"]))
            out.append((i, a["tid"], a["params"]))
    return out


def _bitwise(stream):
    return [(i, tid, {k: repr(v) for k, v in sorted(p.items())}) for i, tid, p in stream]


def _assert_parity(got, want):
    """Ids and keys bit for bit, values by the parity standard."""
    assert [(i, t, sorted(p)) for i, t, p in got] == [(i, t, sorted(p)) for i, t, p in want]
    for (_, _, a), (_, _, b) in zip(got, want):
        for k in b:
            np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=1e-5, atol=1e-6)


def test_shard_of_equals_the_reference_on_ten_thousand_ids():
    rng = np.random.default_rng(0)
    ids = [f"study-{rng.integers(2**48):012x}" for _ in range(10_000)] + ["", "x", 7]
    for n in (1, 2, 8, 13):
        assert [shard_of(s, n) for s in ids] == [ref_shard_of(s, n) for s in ids]


def test_two_replica_fleet_proposes_what_the_reference_single_scheduler_does(tmp_path):
    """Two port replicas share four shards; studies are created on both
    and driven through the other replica's URL (the client follows the
    307s); every stream equals the reference's single scheduler."""
    root = str(tmp_path)
    ra, rb = _replica(root, "ra", n_shards=4, lease_ttl=1.0), \
        _replica(root, "rb", n_shards=4, lease_ttl=1.0)
    sa, sb = ServiceHTTPServer(0, fleet=ra), ServiceHTTPServer(0, fleet=rb)
    assert sa.start() and sb.start()
    try:
        ra.set_addr(sa.url)
        rb.set_addr(sb.url)
        ra.join()
        rb.join()
        for _ in range(3):
            ra.steward_once()
            rb.steward_once()
        assert len(ra.schedulers) == 2 and len(rb.schedulers) == 2
        creators = [ServiceClient(sa.url), ServiceClient(sb.url)]
        sids = [creators[i % 2].create_study(zoo=it.domain.name, seed=it.seed,
                                             n_startup_jobs=3)
                for i, it in enumerate(MIX)]
        drivers = [ServiceClient(sb.url), ServiceClient(sa.url)]  # the other replica
        got = []
        for _ in range(6):
            for i, sid in enumerate(sids):
                (a,) = drivers[i % 2].ask(sid)
                drivers[i % 2].tell(sid, a["tid"], _loss(i, a["tid"]))
                got.append((i, a["tid"], a["params"]))
        assert sum(c.redirects for c in drivers) >= len(sids)
    finally:
        sa.stop()
        sb.stop()
    _assert_parity(got, _single(MIX, 6, ref=True))


def test_drain_handoff_migration_is_bit_for_bit(tmp_path):
    root = str(tmp_path)
    ra = _replica(root, "ra")
    ra.join()
    ra.steward_once()
    sa = ServiceHTTPServer(0, fleet=ra)
    sids = _create(sa, MIX)
    got = _drive(sa, sids, 4)
    assert ra.drain()  # every shard quiesced, compacted and handed off
    rb = _replica(root, "rb")
    rb.join()
    rb.steward_once()
    assert sorted(rb.schedulers) == [0, 1] and rb.adoptions == 2
    for shard in (0, 1):
        assert len(rb.wal_chain(shard)) == 1 and rb.epochs[shard] == 2
    got += _drive(ServiceHTTPServer(0, fleet=rb), sids, 4)
    assert _bitwise(got) == _bitwise(_single(MIX, 8))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_sigkilled_replica_process_is_reclaimed_bit_for_bit(tmp_path):
    """A replica process holding every shard is SIGKILLed at the tell site
    (a chaos kill, never a timer); a replica started once it died reclaims
    its stale leases and adopts by replay, the client retries through, and
    every stream equals an undisturbed port scheduler bit for bit with no
    acknowledged tell lost."""
    root, port = str(tmp_path / "store"), _free_port()
    env = {**os.environ, "PYTHONPATH": REPO, "HYPEROPT_TPU_WATCHDOG": "0",
           "HYPEROPT_TPU_CHAOS": "7:kill@tell:9"}
    child = subprocess.Popen(
        [sys.executable, "-m", "hyperopt_tpu_torch.service.server", "--device", "cpu",
         "--port", str(port), "--announce", "--store", root, "--fleet", "--fleet-shards", "2",
         "--lease-ttl", "1.0", "--replica-id", "r1"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env, cwd=REPO)
    survivor = {}
    try:
        assert child.stdout.readline().startswith("SERVICE_URL ")
        survivor_port = _free_port()
        c = ServiceClient([f"http://127.0.0.1:{port}", f"http://127.0.0.1:{survivor_port}"],
                          retry=RetryPolicy(max_retries=400, base_delay=0.02, max_delay=0.2))
        sids = [c.create_study(zoo=it.domain.name, seed=it.seed, n_startup_jobs=3)
                for it in MIX]

        def watch():
            child.wait()
            r0 = FleetReplica(root, n_shards=2, replica_id="r0", lease_ttl=1.0, device="cpu",
                              scheduler_kwargs={"wave_window": 0.005})
            srv = ServiceHTTPServer(survivor_port, fleet=r0)
            assert srv.start()
            r0.set_addr(srv.url)
            r0.start()
            survivor.update(replica=r0, server=srv)

        th = threading.Thread(target=watch, daemon=True)
        th.start()
        got, acked = [], []
        for _ in range(8):
            for i, sid in enumerate(sids):
                (a,) = c.ask(sid)
                c.tell(sid, a["tid"], _loss(i, a["tid"]))
                got.append((i, a["tid"], a["params"]))
                acked.append((sid, a["tid"]))
        th.join(timeout=60)
        assert child.returncode == -signal.SIGKILL
        r0 = survivor["replica"]
        # both reclaimed; while r1's member record lingers (3 lease TTLs)
        # the steward may hand one back and re-adopt it, as the reference's
        deadline = time.monotonic() + 30
        while sorted(r0.schedulers) != [0, 1] and time.monotonic() < deadline:
            time.sleep(0.1)
        assert r0.adoptions >= 2 and sorted(r0.schedulers) == [0, 1]
        for sid, tid in acked:  # every acknowledged tell is DONE in the store
            doc = next(d for d in r0.scheduler_for(sid)._studies[sid].trials._dynamic_trials
                       if d["tid"] == tid)
            assert doc["state"] == JOB_STATE_DONE and doc["result"]["status"] == "ok"
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        if survivor:
            survivor["server"].drain()
    assert _bitwise(got) == _bitwise(_single(MIX, 8))


@pytest.mark.parametrize("direction", ["JAX writes, port adopts", "port writes, JAX adopts"])
def test_epoch_wal_chain_migrates_across_the_packages(tmp_path, direction):
    """A shard epoch-WAL chain one package's replica wrote (left raw by a
    kill, or compacted by a drain) is adopted by the other package's
    replica over the same store root, whose next asks agree with the
    writer's own continuation; the params, owners and heat files the
    writer left are read by the adopter."""
    root = str(tmp_path)
    writer_is_ref = direction.startswith("JAX")
    wa = _replica(root, "wa", ref=writer_is_ref)
    wa.join()
    wa.steward_once()
    ws = _server(wa)
    sids = _create(ws, MIX)
    got = _drive(ws, sids, 4)
    wa._roll_heat(force=True)
    # the writer's heat records, read by the other package
    heat = (read_heat if writer_is_ref else ref_read_heat)(root)
    assert sorted(heat["shards"]) == ["0", "1"] and heat["corrupt"] == heat["torn"] == 0
    assert max(v["heat_ms"] for v in heat["shards"].values()) > 0
    if writer_is_ref:
        _kill(wa)  # the raw chain, no compaction
    else:
        assert wa.drain()
    ab = _replica(root, "ab", ref=not writer_is_ref)
    owners = {s: ab.read_owner(s) for s in (0, 1)}
    if writer_is_ref:
        assert {o["replica"] for o in owners.values()} == {"wa"}
    ab.join()
    ab.steward_once()
    assert sorted(ab.schedulers) == [0, 1]
    for shard, sched in ab.schedulers.items():
        # the chain compacted to one epoch file (none for a shard that
        # never journaled)
        chain = ab.wal_chain(shard)
        assert len(chain) == 1 if sched._studies else len(chain) <= 1
        want_heat = heat["shards"].get(str(shard), {}).get("heat_ms", 0.0)
        assert sched.load.inherited_ms == pytest.approx(want_heat, abs=1e-3)
    got += _drive(_server(ab), sids, 3)
    want = _single(MIX, 7, ref=writer_is_ref)
    assert _bitwise(got[:len(MIX) * 4]) == _bitwise(want[:len(MIX) * 4])
    _assert_parity(got, want)  # the adopter's continuation
    with pytest.raises(ValueError, match="identical params"):
        _replica(root, "wrong", n_shards=3, ref=not writer_is_ref)


def test_zombie_holder_is_fenced_after_a_reclaim(tmp_path):
    root = str(tmp_path)
    ra = _replica(root, "ra", lease_ttl=0.8)
    ra.join()
    ra.steward_once()
    sa = ServiceHTTPServer(0, fleet=ra)
    (sid,) = _create(sa, MIX[:1])
    _drive(sa, [sid], 2)
    zombie = ra.schedulers[shard_of(sid, 2)]
    status, p = sa.handle("POST", "/ask", {"study_id": sid})
    tid = p["trials"][0]["tid"]
    appends = zombie.journal.appends
    _kill(ra)
    rb = _replica(root, "rb", lease_ttl=0.8)
    rb.join()
    rb.steward_once()
    with pytest.raises(StaleOwnershipError):
        zombie.tell(sid, tid, 0.5)
    assert zombie.journal.appends == appends  # the fenced epoch WAL gained nothing
    assert ra.leases_lost >= 1 and shard_of(sid, 2) not in ra.schedulers
    status, p = sa.handle("POST", "/tell", {"study_id": sid, "tid": tid, "loss": 0.5})
    assert status == 307 and p["location"] == "http://rb"
    status, p = ServiceHTTPServer(0, scheduler=zombie).handle("POST", "/ask", {"study_id": sid})
    assert status == 503 and p["retry_after"] > 0
    # the new owner took the tell the zombie refused
    status, p = ServiceHTTPServer(0, fleet=rb).handle(
        "POST", "/tell", {"study_id": sid, "tid": tid, "loss": 0.5})
    assert status == 200, p


def _status_scenario(name, ref, root):
    """One fleet request path on either package; returns (status, payload
    keys, a Retry-After hint is given)."""
    ra, rb = _replica(root, "ra", ref=ref), _replica(root, "rb", ref=ref)
    if name == "503 unowned":
        res = _server(ra).handle("POST", "/ask", {"study_id": "study-x"})
        with pytest.raises(Exception) as exc:
            ra.place_study()
        assert type(exc.value).__name__ == "ShardUnavailable"
        return res[0], sorted(res[1]), res[1].get("retry_after") is not None
    ra.join()
    rb.join()
    for _ in range(3):
        ra.steward_once()
        rb.steward_once()
    sa, sb = _server(ra), _server(rb)
    status, p = sb.handle("POST", "/study", {"space": {"x": {"dist": "uniform",
                                                             "args": [-5, 5]}},
                                             "seed": 1, "n_startup_jobs": 10})
    sid = p["study_id"]
    if name == "307 other owner":
        status, p = sa.handle("POST", "/ask", {"study_id": sid})
    elif name == "200 owner":
        status, p = sb.handle("POST", "/ask", {"study_id": sid})
    elif name == "404 unknown tid":
        status, p = sb.handle("POST", "/tell", {"study_id": sid, "tid": 99, "loss": 1.0})
    elif name == "503 draining":
        rb.drain()
        status, p = sb.handle("POST", "/ask", {"study_id": sid})
    elif name == "200 healthz":
        status, p = sb.handle("GET", "/healthz", {})
        assert p["shards_held"] == [shard_of(sid, 2)] and p["replica"] == "rb"
        assert sorted(p["replica_addrs"]) == ["ra", "rb"]
    if name == "307 other owner":
        assert p["location"] == "http://rb"
    return status, sorted(p), p.get("retry_after") is not None


FLEET_SCENARIOS = ["307 other owner", "200 owner", "404 unknown tid", "503 draining",
                   "503 unowned", "200 healthz"]


@pytest.mark.parametrize("name", FLEET_SCENARIOS)
def test_fleet_statuses_and_keys_match_the_reference(name, tmp_path):
    got = _status_scenario(name, False, str(tmp_path / "port"))
    want = _status_scenario(name, True, str(tmp_path / "ref"))
    assert got == want and got[0] == int(name.split()[0])
    if got[0] == 503:
        assert got[2]


def test_http_307_carries_location_and_the_client_bounds_its_hops(tmp_path):
    root = str(tmp_path)
    ra, rb = _replica(root, "ra", lease_ttl=10.0), _replica(root, "rb", lease_ttl=10.0)
    sa, sb = ServiceHTTPServer(0, fleet=ra), ServiceHTTPServer(0, fleet=rb)
    assert sa.start() and sb.start()
    try:
        ra.set_addr(sa.url)
        rb.set_addr(sb.url)
        ra.join()
        rb.join()
        for _ in range(3):
            ra.steward_once()
            rb.steward_once()
        sid = ServiceClient(sb.url).create_study(zoo="quadratic1", seed=2, n_startup_jobs=4)
        ca = ServiceClient(sa.url)
        (t,) = ca.ask(sid)
        assert ca.redirects == 1 and ca.tell(sid, t["tid"], 0.5) == {"duplicate": False}
        ca.ask(sid)
        assert ca.redirects == 1  # the owner is cached
        req = urllib.request.Request(sa.url + "/ask", data=json.dumps({"study_id": sid}).encode(),
                                     headers={"Content-Type": "application/json"},
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=30)
        assert exc.value.code == 307 and exc.value.headers["Location"] == sb.url
        # an owner entry pointing back at the asker is a loop: the client
        # follows at most max_hops per attempt, then backs off, then gives up
        rb._drop_shard(shard_of(sid, 2))
        rb.addr = sa.url
        rb._publish_ownership(shard_of(sid, 2), 99)
        loop = ServiceClient(sa.url, retry=RetryPolicy(max_retries=2, base_delay=0.01,
                                                       max_delay=0.02))
        with pytest.raises(ServiceUnavailable):
            loop.ask(sid)
        assert 0 < loop.redirects <= (loop.max_hops + 1) * 3
    finally:
        sa.stop()
        sb.stop()


def test_unowned_shard_cannot_place_a_study(tmp_path):
    ra = _replica(str(tmp_path), "ra")
    with pytest.raises(ShardUnavailable):
        ra.place_study()
    status, p = ServiceHTTPServer(0, fleet=ra).handle("POST", "/study", {"zoo": "branin"})
    assert status == 503 and p["retry_after"] > 0


def test_a_handed_off_scheduler_stays_fenced_when_its_replica_readopts(tmp_path):
    """A request that reached a scheduler before its handoff meets the
    fence even after the same replica claims the shard again, so it can
    never land a tell the new scheduler does not see."""
    ra = _replica(str(tmp_path), "ra", n_shards=1)
    ra.join()
    ra.steward_once()
    sa = ServiceHTTPServer(0, fleet=ra)
    (sid,) = _create(sa, MIX[:1])
    _drive(sa, [sid], 2)
    status, p = sa.handle("POST", "/ask", {"study_id": sid})
    tid = p["trials"][0]["tid"]
    old = ra.schedulers[0]
    assert ra.handoff(0) and ra.adopt(0) and ra.epochs[0] == 2
    new = ra.schedulers[0]
    with pytest.raises(StaleOwnershipError):
        old.tell(sid, tid, 0.5)
    assert ra.schedulers[0] is new and ra.leases_lost == 0
    status, p = sa.handle("POST", "/tell", {"study_id": sid, "tid": tid, "loss": 0.5})
    assert status == 200, p
    assert new._studies[sid].n_told == 3


def test_an_adopter_repairs_a_counter_a_killed_replica_left_empty(tmp_path):
    """A replica killed between the tid counter's truncate and its write
    (the JAX package's order) leaves the counter empty, which reads as 0;
    the adopter's replay sets it back to the ids the store holds, so no
    id is served twice and the streams stay the undisturbed run's."""
    root = str(tmp_path)
    ra = _replica(root, "ra")
    ra.join()
    ra.steward_once()
    sa = ServiceHTTPServer(0, fleet=ra)
    sids = _create(sa, MIX)
    got = _drive(sa, sids, 4)
    for sid in sids:
        open(os.path.join(root, sid, "counter"), "w").close()
    _kill(ra)
    rb = _replica(root, "rb")
    rb.join()
    rb.steward_once()
    got += _drive(ServiceHTTPServer(0, fleet=rb), sids, 4)
    assert _bitwise(got) == _bitwise(_single(MIX, 8))


def test_the_tid_counter_never_reads_empty_while_it_is_rewritten(tmp_path, monkeypatch):
    from hyperopt_tpu_torch.filestore import FileStore

    store = FileStore(str(tmp_path))
    assert store.new_trial_ids(10) == list(range(10))
    path = os.path.join(str(tmp_path), "counter")

    class Killed(Exception):
        pass

    real_open = open

    def open_killed_before_the_trim(*a, **kw):
        f = real_open(*a, **kw)

        def truncate(*_a):
            raise Killed  # the process dies between the write and the trim
        f.truncate = truncate
        return f

    import builtins

    monkeypatch.setattr(builtins, "open", open_killed_before_the_trim)
    with pytest.raises(Killed):
        store.reset_counter(9)
    monkeypatch.setattr(builtins, "open", real_open)
    with open(path) as f:
        assert f.read() == "9 "
    assert store.new_trial_ids(1) == [9]
    store.reset_counter(12)  # up, past a counter that reads too low
    assert store.new_trial_ids(2) == [12, 13]
    with open(path) as f:
        assert f.read() == "14"


def test_an_appended_record_reaches_the_file_before_the_sync(tmp_path):
    """A replica killed between an ask's append and its wave's sync keeps
    the record: the adopter regenerates the ask's docs instead of finding
    them in the store with no record."""
    from hyperopt_tpu_torch.service.journal import StudyJournal

    j = StudyJournal(str(tmp_path / "w.jsonl"))
    j.append(StudyJournal.ask_rec("s", [0], 7, "rand"))
    assert [r["kind"] for r in StudyJournal(j.path).records()] == ["ask"]
    assert j.syncs == 0
