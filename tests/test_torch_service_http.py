"""The port's HTTP front end against the JAX package's: the port's server
(on the CPU) with the port's client, both cross-wirings, the same status
and JSON keys on every error path, a real SIGKILLed server process
resumed bit for bit, the serving planes' routes answering as the
reference's, and the prober's options, once refused, honoured: ``--probe
on`` arms a prober on a real server process, and canary studies and ``GET
/probes`` answer as the reference's."""

import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from hyperopt_tpu.service import ServiceClient as RefClient
from hyperopt_tpu.service import StudyScheduler as RefScheduler
from hyperopt_tpu.service.overload import AdmissionGuard as RefGuard
from hyperopt_tpu.service.server import ServiceHTTPServer as RefServer
from hyperopt_tpu_torch import zoo
from hyperopt_tpu_torch.retry import RetryPolicy
from hyperopt_tpu_torch.service import AdmissionGuard, ServiceClient, StudyScheduler
from hyperopt_tpu_torch.service import server as port_server
from hyperopt_tpu_torch.service.server import ServiceHTTPServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPACE = {"x": {"dist": "uniform", "args": [-5, 5]}, "c": {"dist": "choice", "options": [0, 1]}}


def _loss(params):
    return float((float(params["x"]) - 1.0) ** 2 + float(params.get("c", 0)))


def _port_server(**kw):
    sched = StudyScheduler(device="cpu", wave_window=0.005, **kw)
    return ServiceHTTPServer(0, scheduler=sched)


def _ref_server(**kw):
    return RefServer(0, scheduler=RefScheduler(wave_window=0.005, **kw))


def _drive(client, n=6):
    """One zoo study and one space study, ``n`` ask/tell rounds each."""
    out = []
    for body in ({"zoo": "quadratic1", "seed": 5}, {"space": SPACE, "seed": 6}):
        sid = client.create_study(n_startup_jobs=2, **body)
        for _ in range(n):
            (a,) = client.ask(sid)
            out.append((a["tid"], a["params"]))
            assert client.tell(sid, a["tid"], _loss(a["params"])) == {"duplicate": False}
        assert client.tell(sid, a["tid"], 1.0) == {"duplicate": True}
    return out


@pytest.fixture
def port_srv():
    srv = _port_server()
    assert srv.start()
    yield srv
    srv.stop()


def test_port_server_serves_the_port_client(port_srv):
    c = ServiceClient(port_srv.url)
    stream = _drive(c)
    status = c.studies()
    assert [s["n_told"] for s in status["studies"]] == [6, 6]
    assert status["degrade"]["level"] == 0 and status["cohort_cache"]["misses"] >= 1
    sid = status["studies"][0]["study_id"]
    code, tl = c.request("GET", f"/study/{sid}/timeline")
    assert code == 200 and [e["event"] for e in tl["events"]][:2] == ["admit", "ask"]
    code, health = c.request("GET", "/healthz")
    assert code == 200 and health["ok"] and not health["draining"]
    import urllib.request

    metrics = urllib.request.urlopen(port_srv.url + "/metrics").read().decode()
    assert "hyperopt_tpu_service_asks_total" in metrics
    assert "hyperopt_tpu_slo_" in metrics
    assert len(stream) == 12 and all(-5 <= p["x"] <= 5 for _, p in stream)


@pytest.mark.parametrize("wiring", ["port client, JAX server", "JAX client, port server"])
def test_cross_wired_clients_and_servers(wiring):
    """Either package's client drives the other's server; both serve the
    same streams (ids bit for bit, params by the parity standard)."""
    streams = {}
    for side, (make_srv, make_client) in {
            "port": (_port_server, ServiceClient), "ref": (_ref_server, RefClient)}.items():
        if wiring.startswith("port client"):
            make_client = ServiceClient if side == "ref" else make_client
        else:
            make_client = RefClient if side == "port" else make_client
        srv = make_srv()
        assert srv.start()
        try:
            streams[side] = _drive(make_client(srv.url))
        finally:
            srv.stop()
    assert [t for t, _ in streams["port"]] == [t for t, _ in streams["ref"]]
    for (_, a), (_, b) in zip(streams["port"], streams["ref"]):
        for k in b:
            np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=1e-5, atol=1e-6)


def _scenario(name, make):
    """Run one error path on a server built by ``make``; returns (status,
    payload keys, has a Retry-After hint)."""
    kw = {"max_pending": 1} if name == "429 quota" else {}
    srv = make(**kw)
    h = srv.handle
    sid = h("POST", "/study", {"space": SPACE, "seed": 1, "n_startup_jobs": 10})[1]["study_id"]
    if name == "400 schema":
        res = h("POST", "/study", {"space": {"x": {"dist": "bogus"}}})
    elif name == "400 missing":
        res = h("POST", "/ask", {})
    elif name == "404 study":
        res = h("POST", "/ask", {"study_id": "study-nope"})
    elif name == "404 route":
        res = h("GET", "/nope", {})
    elif name == "409 tell":
        tid = h("POST", "/ask", {"study_id": sid})[1]["trials"][0]["tid"]
        h("POST", "/tell", {"study_id": sid, "tid": tid, "loss": 1.0})
        res = h("POST", "/tell", {"study_id": sid, "tid": tid, "loss": 1.0})
    elif name == "410 quarantined":
        srv.scheduler._quarantine_study(sid, "a corrupt record")
        res = h("POST", "/ask", {"study_id": sid})
    elif name == "429 shed":
        srv.guard = (AdmissionGuard if make is _port_server else RefGuard)(max_queue=1)
        srv.guard.admit_ask()
        res = h("POST", "/ask", {"study_id": sid})
    elif name == "429 quota":
        h("POST", "/ask", {"study_id": sid})
        res = h("POST", "/ask", {"study_id": sid})
    elif name == "503 draining":
        srv.scheduler.drain()
        res = h("POST", "/ask", {"study_id": sid})
    elif name == "507 store full":
        srv.guard.set_store_full(True, reason="disk", retry_after=0.5)
        res = h("POST", "/ask", {"study_id": sid})
    else:  # "200 tell batch"
        tids = [t["tid"] for t in h("POST", "/ask", {"study_id": sid, "n": 1})[1]["trials"]]
        res = h("POST", "/tell", {"study_id": sid,
                                  "results": [{"tid": t, "loss": 0.5} for t in tids]})
    status, payload = res
    return status, sorted(payload), payload.get("retry_after") is not None


SCENARIOS = ["400 schema", "400 missing", "404 study", "404 route", "409 tell",
             "410 quarantined", "429 shed", "429 quota", "503 draining", "507 store full",
             "200 tell batch"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_statuses_and_keys_match_the_reference(name):
    got = _scenario(name, _port_server)
    want = _scenario(name, _ref_server)
    assert got == want
    assert got[0] == int(name.split()[0])
    if got[0] in (503, 507) or name == "429 shed":
        assert got[2]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(root, port, chaos=None):
    env = {**os.environ, "PYTHONPATH": REPO, "HYPEROPT_TPU_WATCHDOG": "0"}
    env.pop("HYPEROPT_TPU_CHAOS", None)
    if chaos:
        env["HYPEROPT_TPU_CHAOS"] = chaos
    proc = subprocess.Popen(
        [sys.executable, "-m", "hyperopt_tpu_torch.service.server", "--device", "cpu",
         "--port", str(port), "--announce", "--store", root],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env, cwd=REPO)
    assert proc.stdout.readline().startswith("SERVICE_URL ")
    return proc


def test_sigkilled_server_process_resumes_bit_for_bit(tmp_path):
    """A real server process is SIGKILLed inside a cohort tick; the
    client retries through the restart, and every study's (tid, params)
    stream equals the port's undisturbed scheduler bit for bit."""
    n_studies, budget = 2, 8
    root, port = str(tmp_path / "store"), _free_port()
    proc = _spawn(root, port, "13:kill@tick:3")
    c = ServiceClient(f"http://127.0.0.1:{port}",
                      retry=RetryPolicy(max_retries=200, base_delay=0.05, max_delay=0.25))
    got, restarted = [], []
    sids = [c.create_study(zoo="quadratic1", seed=500 + i, n_startup_jobs=3)
            for i in range(n_studies)]
    import threading

    def watch():
        while proc.poll() is None:
            time.sleep(0.02)
        restarted.append(proc.returncode)
        restarted.append(_spawn(root, port))

    th = threading.Thread(target=watch, daemon=True)
    th.start()
    try:
        for _ in range(budget):
            for i, sid in enumerate(sids):
                (a,) = c.ask(sid)
                got.append((i, a["tid"], repr(a["params"]["x"])))
                c.tell(sid, a["tid"], float((a["params"]["x"] - (i - 1.0)) ** 2))
    finally:
        th.join(timeout=60)
        for p in [proc] + restarted[1:]:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
                assert p.wait(timeout=60) == 0
    assert restarted and restarted[0] == -signal.SIGKILL
    ref = StudyScheduler(device="cpu", wal=False)
    rsids = [ref.create_study(zoo.ZOO["quadratic1"].space, seed=500 + i, n_startup_jobs=3)
             for i in range(n_studies)]
    want = []
    for _ in range(budget):
        for i, sid in enumerate(rsids):
            (a,) = ref.ask(sid)
            want.append((i, a["tid"], repr(a["params"]["x"])))
            ref.tell(sid, a["tid"], float((a["params"]["x"] - (i - 1.0)) ** 2))
    assert got == want


def _probe_on_arms_the_server_process(root):
    """``--probe on``: the server process probes itself once bound; its
    verdicts show on ``GET /probes`` and in the sealed ledger under the
    store root, and SIGTERM drains it cleanly."""
    env = {**os.environ, "HYPEROPT_TPU_WATCHDOG": "0", "PYTHONPATH": REPO}
    proc = subprocess.Popen([sys.executable, "-m", "hyperopt_tpu_torch.service.server",
                             "--port", "0", "--announce", "--device", "cpu", "--store", root,
                             "--probe", "on", "--probe-period", "30"],
                            stdout=subprocess.PIPE, text=True, env=env, cwd=REPO)
    try:
        url = proc.stdout.readline().split()[-1]
        client = RefClient(url)  # the reference's client reads the port's /probes
        deadline = time.monotonic() + 120
        probes = client.request("GET", "/probes")[1]
        while not probes.get("last") and time.monotonic() < deadline:  # a finished cycle
            time.sleep(0.1)
            probes = client.request("GET", "/probes")[1]
        assert probes["armed"] and probes["backend"] == "cpu", probes
        assert probes["verdicts"]["ok"] == probes["cycles"] >= 1, probes
        assert client.request("GET", "/healthz")[1]["probe"]["green"]
    finally:
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    from hyperopt_tpu_torch.obs.prober import probes_path_for, read_probes

    recs, corrupt, _ = read_probes(probes_path_for(root, "single"))
    assert recs and corrupt == 0 and {r["verdict"] for r in recs} == {"ok"}


def _canary_study_is_admitted(root):
    sched = StudyScheduler(device="cpu", store_root=root)
    sid = sched.create_study(zoo.ZOO["quadratic1"].space, canary=True,
                             space_spec={"zoo": "quadratic1"})
    assert sched.study_status(sid)["canary"] is True
    assert StudyScheduler(device="cpu", store_root=root)._studies[sid].canary  # WAL replay


# the prober's options, refused until the prober was ported, are honoured
UNPORTED = [("--probe", _probe_on_arms_the_server_process),
            ("canary", _canary_study_is_admitted)]


@pytest.mark.parametrize("i", range(len(UNPORTED)))
def test_unported_options_name_their_item(i, tmp_path):
    what, check = UNPORTED[i]
    check(str(tmp_path))
    assert os.listdir(tmp_path), what  # the store root holds what it armed


@pytest.mark.parametrize("request_", [("GET", "/probes", {}, {}),
                                      ("POST", "/study", {"zoo": "branin", "canary": True}, {})])
def test_unported_planes_answer_501_over_http(request_):
    """Both once answered 501; they answer as the reference's now."""
    method, path, body, headers = request_
    srv, ref = _port_server(), _ref_server(wal=False)
    status, payload = srv.handle(method, path, body, headers=headers)
    ref_status, ref_payload = ref.handle(method, path, body, headers=headers)
    assert status == ref_status == 200
    assert set(payload) == set(ref_payload)
    if path == "/probes":
        assert payload["armed"] is False and payload["endpoint"] == "probes"
    else:
        assert srv.scheduler.study_status(payload["study_id"])["canary"] is True
    assert srv.handle("GET", "/studies", {}, headers={"x-tenant": "\n"})[0] == 400


PLANE_REQUESTS = {
    "tenants": ("GET", "/tenants", {}, {}),
    "fleet load": ("GET", "/fleet/load", {}, {}),
    "x-tenant studies": ("GET", "/studies", {}, {"x-tenant": "team-a"}),
    "x-tenant study": ("POST", "/study", {"zoo": "branin"}, {"x-tenant": "team-a"}),
    "body tenant": ("POST", "/study", {"zoo": "branin", "tenant": "team-b"}, {}),
    "reserved tenant": ("POST", "/study", {"zoo": "branin", "tenant": "other"}, {}),
    "hostile header": ("GET", "/tenants", {}, {"x-tenant": "a\x7f"}),
}


@pytest.mark.parametrize("name", sorted(PLANE_REQUESTS))
def test_plane_routes_and_the_tenant_header_answer_as_the_reference(name):
    """The routes of the serving planes and the ``x-tenant`` header answer
    the reference's status with the reference's keys; a tenant named on a
    study lands in both tenant tables."""
    method, path, body, headers = PLANE_REQUESTS[name]
    got = {}
    for side, make in (("port", _port_server), ("ref", _ref_server)):
        srv = make()
        srv.handle("POST", "/study", {"zoo": "quadratic1", "seed": 3},
                   headers={"x-tenant": "team-c"})
        status, payload = srv.handle(method, path, dict(body), headers=headers)
        table = srv.handle("GET", "/tenants", {})[1].get("table", {})
        got[side] = (status, sorted(payload), sorted(table),
                     {t: row["studies"] for t, row in table.items()})
    assert got["port"] == got["ref"]
    assert got["port"][0] == (400 if name in ("reserved tenant", "hostile header") else 200)


@pytest.mark.parametrize("argv", [["--fleet"], ["--fleet", "--store", "{d}", "--wal", "off"]])
def test_fleet_cli_refuses_what_the_reference_refuses(argv, tmp_path, capsys):
    from hyperopt_tpu.service import server as ref_server

    argv = ["--port", "0"] + [a.format(d=tmp_path) for a in argv]
    for main, extra in ((port_server.main, ["--device", "cpu"]), (ref_server.main, [])):
        with pytest.raises(SystemExit) as exc:
            main(argv + extra)
        assert exc.value.code == 2
        assert "--fleet" in capsys.readouterr().err
    assert not os.listdir(tmp_path)
