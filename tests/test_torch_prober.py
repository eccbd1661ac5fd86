"""The port's blackbox prober against the JAX package's, on the CPU.

The canary's stream on the port's CPU path equals the reference's live
stream (both drives run in this file; the reference's committed fixture is
never read, only its live ``local_digest()``), the pure pieces give the
reference's values, and the reference's prober cases hold for the port
against a golden pinned from the live drive: verdicts and detection,
the sealed ledger, free canary traffic, the server's surfaces and knobs,
and the capture plane a mismatch escalates to, whose session the next
wave's leader records."""

import io
import json
import os
import sys
import threading
import time
from contextlib import redirect_stdout

import pytest

from hyperopt_tpu.obs import prober as ref_prober
from hyperopt_tpu.obs import report as ref_report
from hyperopt_tpu_torch import chaos, hp
from hyperopt_tpu_torch._env import parse_probe, parse_probe_period, parse_probe_slo
from hyperopt_tpu_torch.obs import profiler as port_profiler
from hyperopt_tpu_torch.obs import report
from hyperopt_tpu_torch.obs.load import CostLedger
from hyperopt_tpu_torch.obs.prober import (CANARY, ProbeLedger, Prober, _LocalTransport,
                                           canary_key, detection_stats, load_golden,
                                           local_digest, main as prober_main,
                                           probes_path_for, read_probes, stream_digest)
from hyperopt_tpu_torch.obs.profiler import DeviceProfiler
from hyperopt_tpu_torch.obs.quality import QualityPlane
from hyperopt_tpu_torch.obs.slo import PROBE_TARGETS, SLOPlane
from hyperopt_tpu_torch.service import integrity
from hyperopt_tpu_torch.service.scheduler import StudyScheduler
from hyperopt_tpu_torch.service.server import ServiceHTTPServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

SPACE = {"x": hp.uniform("x", -5, 5)}
SPACE_SPEC = {"x": {"dist": "uniform", "args": [-5, 5]}}
CORRUPT = "7:corrupt@tick:1.0"


@pytest.fixture(autouse=True)
def _chaos_clean():
    chaos.reset()
    yield
    chaos.reset()


@pytest.fixture(scope="module")
def live():
    """One live canary drive per package: the port's on the CPU and the
    reference's (~6 s), shared by the file."""
    return {"port": local_digest(CANARY, device="cpu"),
            "ref": ref_prober.local_digest(CANARY)}


@pytest.fixture
def servers():
    """Servers a test builds through :func:`_local_server`; every prober
    thread and server stops at teardown."""
    made = []
    yield made
    for srv in made:
        srv.stop()


def _local_server(servers, **kw):
    kw.setdefault("quality", False)
    sched = StudyScheduler(wal=False, device="cpu", **kw)
    srv = ServiceHTTPServer(0, scheduler=sched, trace=False, slo=False)
    servers.append(srv)
    return srv


def _local_prober(srv, live, **kw):
    kw.setdefault("transport_factory", lambda url: _LocalTransport(srv))
    kw.setdefault("period", 30.0)
    kw.setdefault("golden", live["port"][0])
    return Prober(["local://srv"], backend="cpu", **kw)


# ---------------------------------------------------------------------------
# the canary's stream and the pure pieces
# ---------------------------------------------------------------------------


def test_cpu_digest_equals_the_reference_live_digest(live):
    """The port's CPU canary stream is the reference's live stream, bit for
    bit, and the port's committed ``cpu`` entry pins it."""
    (port_digest, port_flagged), (ref_digest, ref_flagged) = live["port"], live["ref"]
    assert not port_flagged and not ref_flagged
    assert port_digest == ref_digest
    assert load_golden(CANARY, backend="cpu") == port_digest
    assert load_golden(CANARY, backend="cuda") is None  # the card trusts its first stream


def test_local_digest_is_deterministic(live):
    assert local_digest(CANARY, device="cpu") == live["port"]


STREAMS = [
    [{"tid": 0, "params": {"x": 0.1 + 0.2, "y": -3.5}},
     {"tid": 1, "params": {"y": 1e-17, "x": 2.0}}],
    [{"tid": 7, "params": {"x": -4.999999999999999}}],
    [],
]


@pytest.mark.parametrize("i", range(len(STREAMS)))
def test_stream_digest_and_canary_key_equal_the_reference(i):
    stream = STREAMS[i]
    assert stream_digest(stream) == ref_prober.stream_digest(stream)
    assert stream_digest(json.loads(json.dumps(stream))) == stream_digest(stream)
    for knob, val in ((None, None), ("seed", 7), ("asks", 9), ("n_startup", 1), ("n_ei", 8),
                      ("zoo", "other")):
        c = None if knob is None else {knob: val}
        assert canary_key(c) == ref_prober.canary_key(c)
        if c is not None:
            assert canary_key(c) != canary_key()


# ---------------------------------------------------------------------------
# cycles, verdicts, detection
# ---------------------------------------------------------------------------


def test_clean_cycle_is_ok_green_and_sealed(tmp_path, servers, live):
    srv = _local_server(servers)
    led = probes_path_for(tmp_path, "r0")
    p = _local_prober(srv, live, ledger_path=led, replica="r0", clock=lambda: 1000.0)
    s = p.run_cycle(now=1000.0)
    assert s["verdict"] == "ok" and not s["diverged"]
    assert p.green(now=1000.0) and p.streak == 1
    recs, corrupt, torn = read_probes(led)
    assert corrupt == 0 and torn == 0
    assert [r["verdict"] for r in recs] == ["ok"]
    assert recs[0]["replica"] == "r0" and recs[0]["backend"] == "cpu"
    assert recs[0]["canary"] == canary_key(CANARY)
    assert recs[0]["digest"] == live["ref"][0]
    h = p.healthz_fields(now=1000.0)
    assert h["green"] and h["last_verdict"] == "ok" and h["golden_match_streak"] == 1


def test_corruption_detected_with_fake_clock_latency(tmp_path, servers, live):
    srv = _local_server(servers)
    led = probes_path_for(tmp_path, "r0")
    p = _local_prober(srv, live, ledger_path=led)
    assert p.run_cycle(now=100.0)["verdict"] == "ok"
    chaos.configure(CORRUPT)  # silent float corruption of the read-back proposals
    s = p.run_cycle(now=107.0)
    assert s["verdict"] == "mismatch"
    assert s["detection_latency_sec"] == pytest.approx(7.0)
    assert p.streak == 0 and not p.green(now=107.0)
    recs, _, _ = read_probes(led)
    st = detection_stats(recs)
    assert st == ref_prober.detection_stats(recs)
    assert st["episodes"] == 1 and st["mean_sec"] == pytest.approx(7.0)
    ev = [r.get("evidence") for r in recs if r.get("evidence")]
    assert ev, "a mismatch verdict carries no evidence bundle"
    with open(os.path.join(ev[-1], "bundle.json"), encoding="utf-8") as f:
        assert json.load(f)["verdict"] == "mismatch"


class _Session:
    """A stand-in ``torch.profiler`` session (no waiting, no trace)."""

    def stop(self):
        pass

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": []}, f)


def test_escalation_is_once_per_episode_and_routed_to_the_capture_plane(
        tmp_path, servers, live, monkeypatch):
    """A red streak escalates once; the capture it asks for is recorded by
    the leader of the next canary wave (this thread), not by the prober's
    or the capture's own thread."""
    monkeypatch.setattr(port_profiler, "_start_session", _Session)
    prof = DeviceProfiler(str(tmp_path / "caps"))
    srv = _local_server(servers, profiler=prof)
    p = _local_prober(srv, live, escalation_cooldown=0.0, profiler=prof)
    assert p.run_cycle(now=10.0)["verdict"] == "ok"
    chaos.configure(CORRUPT)
    for now in (20.0, 30.0, 40.0):
        assert p.run_cycle(now=now)["verdict"] == "mismatch"
    assert p.escalations == 1, "a red streak must escalate once"
    deadline = time.monotonic() + 30.0
    while p.last_capture is None and time.monotonic() < deadline:
        p.run_cycle(now=45.0)  # its waves serve the pending capture
        time.sleep(0.01)
    cap = p.last_capture
    assert cap is not None and cap["reason"] == "probe_mismatch"
    assert cap["scope"] == "wave leader" and cap["waves"] == 1
    # the stand-in session holds no kernel: the record says so
    assert cap["kernels"] == 0 and not cap["ok"] and "no device kernel" in cap["error"]
    assert "trace_json" not in cap and os.path.exists(cap["host_trace_json"])
    chaos.configure(None)
    assert p.run_cycle(now=50.0)["verdict"] == "ok"
    chaos.configure(CORRUPT)
    assert p.run_cycle(now=60.0)["verdict"] != "ok"
    assert p.escalations == 2, "a new episode escalates again"
    assert p.status_dict(now=60.0)["escalations"] == 2
    # the second episode's capture waits for a wave: detaching the waves
    # hands it back, so its thread ends with the test
    srv.scheduler.set_profiler(None)
    deadline = time.monotonic() + 30.0
    while (any(t.name == "hyperopt-capture-probe_mismatch" for t in threading.enumerate())
           and time.monotonic() < deadline):
        time.sleep(0.01)
    assert not any(t.name == "hyperopt-capture-probe_mismatch" for t in threading.enumerate())
    assert "detached" in p.last_capture["error"]


def test_error_verdict_fail_open_never_raises():
    class Boom:
        def request(self, *a, **kw):
            raise RuntimeError("probe transport exploded")

    p = Prober(["local://x"], transport_factory=lambda url: Boom(), period=30.0,
               backend="cpu")
    s = p.run_cycle(now=5.0)
    assert s["verdict"] == "error" and not p.green(now=5.0)


def test_fleet_divergence_turns_mismatch(servers):
    """Two replicas answering different clean streams diverge, even with
    no golden (TOFU)."""
    srv_a, srv_b = _local_server(servers), _local_server(servers)

    class Skewed(_LocalTransport):
        def request(self, method, path, body=None):
            if path == "/study" and body:
                body = dict(body, seed=int(body["seed"]) + 1)
            return super().request(method, path, body)

    transports = {"local://a": _LocalTransport(srv_a), "local://b": Skewed(srv_b)}
    p = Prober(["local://a", "local://b"], period=30.0, backend="cpu",
               transport_factory=lambda url: transports[url], profile_capture=False)
    p.golden, p.golden_source = None, "tofu"
    s = p.run_cycle(now=1.0)
    assert s["diverged"] and s["verdict"] == "mismatch"


def test_tofu_pins_first_clean_digest(servers, live):
    srv = _local_server(servers)
    p = Prober(["local://srv"], period=30.0, backend="cuda",
               transport_factory=lambda url: _LocalTransport(srv))
    assert p.golden is None and p.golden_source == "tofu"  # no committed card entry
    assert p.run_cycle(now=1.0)["verdict"] == "ok"
    assert p.golden == live["port"][0]
    assert p.run_cycle(now=2.0)["verdict"] == "ok" and p.golden == live["port"][0]


def test_prober_thread_starts_and_stops(servers, live):
    srv = _local_server(servers)
    p = _local_prober(srv, live, period=0.05)

    def names():
        return {t.name for t in threading.enumerate()}

    assert "hyperopt-prober" not in names()
    p.start()
    assert "hyperopt-prober" in names()
    deadline = time.monotonic() + 30.0
    while p.cycles < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    p.stop()
    assert "hyperopt-prober" not in names()
    assert p.cycles >= 1 and p.last["verdict"] == "ok"


# ---------------------------------------------------------------------------
# the sealed ledger
# ---------------------------------------------------------------------------


def test_ledger_corrupt_line_counted_torn_tail_silent(tmp_path):
    led = str(tmp_path / "r0.jsonl")
    L = ProbeLedger(led)
    for i in range(3):
        L.append({"kind": "probe", "cycle": i, "ts": float(i), "verdict": "ok"})
    with open(led, "ab") as f:
        f.write(b'{"kind": "probe", "torn-no-newline')
    data = open(led, "rb").read()
    flipped = data.replace(b'"cycle":1', b'"cycle":9', 1)
    assert flipped != data
    with open(led, "wb") as f:
        f.write(flipped)
    recs, corrupt, torn = read_probes(led)
    assert corrupt == 1 and torn == 1
    assert [r["cycle"] for r in recs] == [0, 2]
    assert ref_prober.read_probes(led) == (recs, corrupt, torn)  # the reference reads it alike


def test_ledger_append_fail_open(tmp_path):
    L = ProbeLedger(str(tmp_path / "nope" / "x" / "r0.jsonl"))
    os.makedirs(os.path.dirname(os.path.dirname(L.path)))
    with open(os.path.dirname(os.path.dirname(L.path)) + "/x", "w"):
        pass  # a file where the directory should be: makedirs raises OSError
    L.append({"kind": "probe", "verdict": "ok"})
    L.append({"kind": "probe", "verdict": "ok"})
    assert L._warned


def test_ledger_lines_are_integrity_sealed(tmp_path):
    led = str(tmp_path / "r0.jsonl")
    ProbeLedger(led).append({"kind": "probe", "cycle": 1, "verdict": "ok"})
    line = open(led, encoding="utf-8").read().strip()
    checked = list(integrity.iter_checked_jsonl(led))
    assert len(checked) == 1 and checked[0].status == integrity.OK
    assert integrity.CHECKSUM_FIELD in json.loads(line)
    ref_led = str(tmp_path / "ref.jsonl")
    ref_prober.ProbeLedger(ref_led).append({"kind": "probe", "cycle": 1, "verdict": "ok"})
    assert open(ref_led, encoding="utf-8").read().strip() == line


# ---------------------------------------------------------------------------
# canary traffic is free
# ---------------------------------------------------------------------------


def _drive_direct(sched, sid, n):
    out = []
    for _ in range(n):
        a = sched.ask(sid)[0]
        out.append((a["tid"], repr(a["params"]["x"])))
        sched.tell(sid, a["tid"], float((a["params"]["x"] - 1.0) ** 2))
    return out


def test_armed_equals_disarmed_bit_identical_direct(servers, live):
    srv_on = _local_server(servers)
    on = srv_on.scheduler
    off = StudyScheduler(wal=False, quality=False, device="cpu")
    p = _local_prober(srv_on, live)
    sid_on = on.create_study(SPACE, seed=21, n_startup_jobs=2)
    sid_off = off.create_study(SPACE, seed=21, n_startup_jobs=2)
    seq_on, seq_off = [], []
    for i in range(3):
        assert p.run_cycle(now=float(i))["verdict"] == "ok"
        seq_on += _drive_direct(on, sid_on, 3)
        seq_off += _drive_direct(off, sid_off, 3)
    assert seq_on == seq_off


def test_armed_equals_disarmed_bit_identical_over_http(servers, live):
    """Over real sockets: the armed server's prober thread probes its own
    URL while a client drives a tenant study; the stream equals the
    disarmed server's."""
    from hyperopt_tpu_torch.service import ServiceClient

    seqs = {}
    for armed in (True, False):
        srv = _local_server(servers)
        assert srv.start()
        if armed:
            p = srv.arm_prober(period=3.0)
            p.golden = live["port"][0]
        c = ServiceClient(srv.url)
        sid = c.create_study(space=SPACE_SPEC, seed=33, n_startup_jobs=2)
        seq = []
        for _ in range(9):
            (a,) = c.ask(sid)
            seq.append((a["tid"], repr(a["params"]["x"])))
            c.tell(sid, a["tid"], float((a["params"]["x"] - 1.0) ** 2))
        if armed:
            deadline = time.monotonic() + 30.0
            while p.last is None and time.monotonic() < deadline:
                time.sleep(0.02)
            srv._stop_prober()
            assert p.cycles >= 1 and p.verdicts["ok"] == p.cycles, p.recent
        srv.stop()
        seqs[armed] = seq
    assert seqs[True] == seqs[False]


def test_canary_studies_invisible_to_quality_load_tenants_and_census(tmp_path):
    from hyperopt_tpu_torch.obs.tenant import TenantLedger
    from hyperopt_tpu_torch.service.compile_plane import CompilePlane

    plane = CompilePlane(census_path=str(tmp_path / "census.jsonl"), device="cpu")
    sched = StudyScheduler(wal=False, device="cpu", quality=QualityPlane(), load=CostLedger(),
                           tenants=TenantLedger(), compile_plane=plane)
    canary = sched.create_study(SPACE, seed=5, n_startup_jobs=2, canary=True,
                                space_spec={"space": SPACE_SPEC}, n_EI_candidates=31)
    _drive_direct(sched, canary, 6)
    assert not plane.census._counts, "a canary-only tick fed the census bank"
    assert sched.tenants.status()["table"] == {}, "the canary reached the tenant ledger"
    tenant = sched.create_study(SPACE, seed=6, n_startup_jobs=2,
                                space_spec={"space": SPACE_SPEC})
    _drive_direct(sched, tenant, 6)
    assert sched.quality.study_status(canary) is None
    assert sched.quality.study_status(tenant) is not None
    assert sched.load.study_status(canary) is None
    t = sched.load.study_status(tenant)
    assert t is not None and t["tells"] == 6
    assert sched.tenants.status()["table"]["anon"]["tells"] == 6
    assert plane.census._counts


def test_canary_flag_rides_status_and_wal_replay(tmp_path):
    sched = StudyScheduler(store_root=str(tmp_path), device="cpu")
    sid = sched.create_study(SPACE, seed=5, n_startup_jobs=2,
                             space_spec={"space": SPACE_SPEC}, canary=True)
    want = _drive_direct(sched, sid, 3)
    assert sched._studies[sid].canary
    assert sched.study_status(sid).get("canary") is True
    del sched  # no drain: the resume replays the WAL
    resumed = StudyScheduler(store_root=str(tmp_path), quality=QualityPlane(), device="cpu")
    assert sid in resumed._studies and resumed._studies[sid].canary
    assert resumed.quality.study_status(sid) is None
    assert resumed.study_status(sid)["n_told"] == len(want)


def test_probe_header_skips_tenant_slo():
    sched = StudyScheduler(wal=False, quality=False, device="cpu")
    srv = ServiceHTTPServer(0, scheduler=sched, trace=False, slo=True)
    before = srv.slo.status()
    code, _ = srv.handle("POST", "/study", {"space": SPACE_SPEC, "seed": 1, "canary": True},
                         headers={"x-probe": "1", "x-tenant": "t"})
    assert code == 200
    after = srv.slo.status()
    assert after["availability"]["window_events"] == before["availability"]["window_events"]
    assert srv.handle("GET", "/healthz", None)[0] == 200


# ---------------------------------------------------------------------------
# SLO objectives, server surfaces
# ---------------------------------------------------------------------------


def test_probe_objectives_installed_only_when_armed(servers):
    sched = StudyScheduler(wal=False, quality=False, device="cpu")
    srv = ServiceHTTPServer(0, scheduler=sched, trace=False, slo=True)
    servers.append(srv)
    assert "probe_avail" not in srv.slo.status()
    assert srv.arm_prober() is None  # not bound yet
    assert srv.start()
    p = srv.arm_prober(period=30.0)
    assert p is not None and srv.arm_prober() is p
    assert p.backend == "cpu"
    st = srv.slo.status()
    for name in PROBE_TARGETS:
        assert name in st


def test_probe_slo_burns_on_mismatch(servers, live):
    plane = SLOPlane(clock=lambda: 1000.0)
    for name, spec in PROBE_TARGETS.items():
        plane.add_objective(name, spec)
    srv = _local_server(servers)
    p = _local_prober(srv, live, slo=plane, profile_capture=False)
    assert p.run_cycle(now=1000.0)["verdict"] == "ok"
    g0 = plane.status()["probe_golden_match"]
    assert g0["window_events"] >= 1
    assert g0["budget_remaining_frac"] == pytest.approx(1.0)
    chaos.configure(CORRUPT)
    assert p.run_cycle(now=1010.0)["verdict"] == "mismatch"
    g1 = plane.status()["probe_golden_match"]
    assert g1["window_events"] == g0["window_events"] + 1
    assert g1["budget_remaining_frac"] < g0["budget_remaining_frac"]
    assert plane.status()["probe_avail"]["budget_remaining_frac"] == pytest.approx(1.0)


def test_server_surfaces_probes_and_healthz(servers, live):
    srv = _local_server(servers)
    code, d = srv.handle("GET", "/probes", None)
    assert code == 200 and d["armed"] is False
    code, h = srv.handle("GET", "/healthz", None)
    assert code == 200 and "probe" not in h
    assert "probes" not in srv.snapshot_dict()
    assert "GET /probes" in srv.handle("GET", "/", None)[1]["endpoints"]
    assert srv.start()
    p = srv.arm_prober(period=30.0)
    p.golden = live["port"][0]
    p.run_cycle()
    code, d = srv.handle("GET", "/probes", None)
    assert code == 200 and d["armed"] is True and d["backend"] == "cpu"
    assert d["cycles"] >= 1 and d["golden_match_streak"] >= 1
    code, h = srv.handle("GET", "/healthz", None)
    assert code == 200 and h["ok"] and h["probe"]["green"]
    assert srv.snapshot_dict()["probes"]["armed"] is True
    srv.drain()
    assert "hyperopt-prober" not in {t.name for t in threading.enumerate()}


def test_metrics_expose_probe_families(servers, live):
    import urllib.request

    from validate_scrape import PROBE_FAMILIES, validate_probe_families

    srv = _local_server(servers)
    assert srv.start()
    p = srv.arm_prober(period=30.0)
    p.golden = live["port"][0]
    p.run_cycle()
    with urllib.request.urlopen(srv.url + "/metrics", timeout=10) as r:
        assert r.status == 200
        text = r.read().decode("utf-8")
    assert validate_probe_families(text) == []
    for fam in PROBE_FAMILIES:
        assert fam in text


def test_disarmed_prober_costs_nothing():
    n0 = threading.active_count()
    sched = StudyScheduler(wal=False, quality=False, device="cpu")
    srv = ServiceHTTPServer(0, scheduler=sched, trace=False, slo=True)
    assert srv.prober is None and srv.profiler is None and sched.profiler is None
    assert threading.active_count() == n0
    code, _ = srv.handle("POST", "/study", {"space": SPACE_SPEC, "seed": 1})
    assert code == 200
    assert srv.prober is None and threading.active_count() == n0
    assert not any(name.startswith("probe_") for name in srv.slo.status())


# ---------------------------------------------------------------------------
# the capture plane the server owns
# ---------------------------------------------------------------------------


def test_server_capture_is_recorded_by_the_wave_leader(tmp_path, monkeypatch, servers):
    """``HYPEROPT_TPU_PROFILE`` arms the server's capture plane; a capture
    asked for on another thread is started and stopped by the thread that
    leads the next tick wave, and holds that wave's operators.  On the CPU
    the session holds no device kernel, and the record says so."""
    monkeypatch.setenv("HYPEROPT_TPU_PROFILE", str(tmp_path / "caps"))
    srv = _local_server(servers)
    prof = srv.profiler
    assert prof is not None and srv.scheduler.profiler is prof
    sid = srv.handle("POST", "/study", {"space": SPACE_SPEC, "seed": 3,
                                        "n_startup_jobs": 1})[1]["study_id"]

    def ask_tell():
        code, a = srv.handle("POST", "/ask", {"study_id": sid})
        assert code == 200
        t = a["trials"][0]
        srv.handle("POST", "/tell", {"study_id": sid, "tid": t["tid"], "loss": 1.0})
        return t

    ask_tell()  # the startup ask: not a tick wave
    box = {}
    th = threading.Thread(target=lambda: box.setdefault("rec", prof.capture(0.5, reason="t")))
    th.start()
    deadline = time.monotonic() + 30.0
    while prof._request is None and time.monotonic() < deadline:
        time.sleep(0.005)
    ask_tell()  # this thread leads the wave
    th.join(timeout=60)
    rec = box["rec"]
    assert rec["scope"] == "wave leader" and rec["thread"] == "wave" and rec["waves"] == 1
    assert rec["kernels"] == 0 and not rec["ok"] and "no device kernel" in rec["error"]
    assert set(rec["stop_split"]) >= {"sync_sec", "stop_sec"}
    import gzip

    with gzip.open(rec["host_trace_json"], "rt") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events), "the wave's operators are missing"


def test_slo_fast_burn_takes_one_wave_capture(tmp_path, monkeypatch, servers):
    monkeypatch.setattr(port_profiler, "_start_session", _Session)
    monkeypatch.setenv("HYPEROPT_TPU_PROFILE", str(tmp_path / "caps"))
    srv = _local_server(servers)
    sid = srv.handle("POST", "/study", {"space": SPACE_SPEC, "seed": 3,
                                        "n_startup_jobs": 0})[1]["study_id"]
    srv._slo_escalation()
    deadline = time.monotonic() + 30.0
    while not srv.profiler.captures and time.monotonic() < deadline:
        code, a = srv.handle("POST", "/ask", {"study_id": sid})
        srv.handle("POST", "/tell", {"study_id": sid, "tid": a["trials"][0]["tid"], "loss": 1.0})
    (rec,) = srv.profiler.captures
    assert rec["reason"] == "slo_burn" and rec["scope"] == "wave leader" and rec["waves"] == 1


# ---------------------------------------------------------------------------
# knobs, report, CLI
# ---------------------------------------------------------------------------


def test_env_knobs(monkeypatch):
    from hyperopt_tpu import _env as ref_env

    cases = [
        ("HYPEROPT_TPU_PROBE", None), ("HYPEROPT_TPU_PROBE", "1"),
        ("HYPEROPT_TPU_PROBE_PERIOD", "2.5"), ("HYPEROPT_TPU_PROBE_PERIOD", "bogus"),
        ("HYPEROPT_TPU_PROBE_PERIOD", "-1"), ("HYPEROPT_TPU_PROBE_SLO", None),
        ("HYPEROPT_TPU_PROBE_SLO", "off"), ("HYPEROPT_TPU_PROBE_SLO", "avail=99.5,ask_p99_ms=500"),
        ("HYPEROPT_TPU_PROBE_SLO", "golden=90,junk"),
    ]
    for name, raw in cases:
        if raw is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, raw)
        for port_fn, ref_fn in ((parse_probe, ref_env.parse_probe),
                                (parse_probe_period, ref_env.parse_probe_period),
                                (parse_probe_slo, ref_env.parse_probe_slo)):
            assert port_fn() == ref_fn(), (name, raw, port_fn.__name__)
    monkeypatch.delenv("HYPEROPT_TPU_PROBE", raising=False)
    assert parse_probe() is False
    monkeypatch.setenv("HYPEROPT_TPU_PROBE_PERIOD", "bogus")
    assert parse_probe_period() == 30.0
    monkeypatch.setenv("HYPEROPT_TPU_PROBE_SLO", "avail=99.5,ask_p99_ms=500")
    cfg = parse_probe_slo()
    assert cfg["probe_avail"]["target"] == 0.995
    assert cfg["probe_ask_p99_ms"]["threshold_ms"] == 500.0


def test_report_probes_view_equals_the_reference(tmp_path):
    led = probes_path_for(tmp_path, "r1")
    L = ProbeLedger(led)
    base = {"kind": "probe", "replica": "r1", "target": "u", "golden": "abc",
            "golden_source": "fixture", "canary": canary_key(), "backend": "cpu"}
    L.append(dict(base, cycle=1, ts=10.0, verdict="ok"))
    L.append(dict(base, cycle=2, ts=14.0, verdict="mismatch", why="digest drift"))
    texts = []
    for main in (report.main, ref_report.main):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert main(["--probes", str(tmp_path)]) == 0
        texts.append(buf.getvalue())
    assert texts[0] == texts[1]
    assert "blackbox probes" in texts[0]
    assert "mismatch" in texts[0] and "4.00s" in texts[0]
    assert report.render_probes(led) == ref_report.render_probes(led)
    assert report.main(["--probes", str(tmp_path), "--format", "json"]) == 2
    assert report.main(["--probes", str(tmp_path), "--trend"]) == 2


def test_prober_cli_runs_bounded_cycles(tmp_path, servers, monkeypatch):
    """The standalone entry point: N cycles against a live HTTP server, a
    sealed ledger on disk, the exit code from the verdicts.  Without a
    card it keys the ``cpu`` golden, which this server serves."""
    srv = _local_server(servers)
    assert srv.start()
    led = str(tmp_path / "cli.jsonl")
    rc = prober_main(["--targets", srv.url, "--cycles", "1", "--period", "1.0",
                      "--ledger", led, "--replica", "cli"])
    assert rc == 0
    recs, corrupt, _ = read_probes(led)
    assert corrupt == 0 and [r["verdict"] for r in recs] == ["ok"]
    assert recs[0]["golden_source"] == "fixture" and recs[0]["backend"] == "cpu"
    chaos.configure(CORRUPT)
    assert prober_main(["--targets", srv.url, "--cycles", "1", "--period", "1.0"]) == 1
