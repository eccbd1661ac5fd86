"""The port's end-to-end service gates (``scripts/torch_*_smoke.py``,
``run_torch_gates.sh``) on the CPU: the shared pieces of
``scripts/torch_gate_common.py`` (the stream comparisons, the raw HTTP
reading of typed errors with ``Retry-After``, the kernel-counter check
that refuses a card run without launches, the study that puts a gate's
servers on the ``ei_diff`` route), the SLO gate end to end at one
study and the STORE gate at its smallest size.  The other gates run at
small counts under ``-m slow`` (``pytest -m slow tests/test_torch_gates.py``)."""

import http.server
import json
import os
import subprocess
import sys
import threading

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import torch_gate_common as g  # noqa: E402


def _stream(*xs, tid0=0):
    return [(tid0 + i, (("x", repr(float(x))),)) for i, x in enumerate(xs)]


def test_compare_streams_is_bit_for_bit():
    want = [_stream(0.5, 1.25), _stream(-2.0)]
    assert g.compare_streams([_stream(0.5, 1.25), _stream(-2.0)], want) == []
    bad = g.compare_streams([_stream(0.5, 1.25 + 1e-12), None], want)
    assert len(bad) == 2 and "study 0 diverged" in bad[0] and "study 1" in bad[1]
    with pytest.raises(g.GateFailure):
        g.compare_streams([_stream(0.5)], want)


def test_tolerant_flips_count_each_study_up_to_its_first_flip():
    want = [_stream(1.0, 2.0, 3.0), _stream(4.0, 5.0)]
    assert g.tolerant_flips([_stream(1.0 + 1e-6, 2.0, 3.0), _stream(4.0, 5.0)], want) == []
    flips = g.tolerant_flips([_stream(1.0, 2.5, 9.0), _stream(4.0, 5.0 + 1e-3)], want)
    assert [(i, j) for i, j, _, _ in flips] == [(0, 1), (1, 1)]
    with pytest.raises(g.GateFailure):
        g.tolerant_flips([_stream(1.0, tid0=1)], [_stream(1.0)])


def test_canon_is_the_json_round_trip():
    import numpy as np

    p = {"x": np.float32(0.1), "c": 2, "s": "a"}
    got = g.canon(p)
    assert got == g.canon(json.loads(json.dumps({k: (float(v) if k == "x" else v)
                                                 for k, v in p.items()})))
    assert dict(got)["x"] == repr(float(np.float32(0.1)))


@pytest.mark.parametrize("launches,device,ok", [
    ({"ei_diff": 0, "fused_sample_ei": 0, "q_mass_diff": 0}, "cuda", False),
    ({"ei_diff": 3, "fused_sample_ei": 0, "q_mass_diff": 3}, "cuda", False),
    ({"ei_diff": 0, "fused_sample_ei": 7, "q_mass_diff": 3}, "cuda", False),
    ({"ei_diff": 3, "fused_sample_ei": 7, "q_mass_diff": 0}, "cuda", False),
    ({"ei_diff": 3, "fused_sample_ei": 7, "q_mass_diff": 3}, "cuda", True),
    ({"ei_diff": 0, "fused_sample_ei": 0, "q_mass_diff": 0}, "cpu", True),
])
def test_kernel_counter_check_refuses_a_card_run_without_launches(launches, device, ok):
    if ok:
        g.check_kernel_counts(launches, device)
    else:
        with pytest.raises(g.GateFailure, match="launched"):
            g.check_kernel_counts(launches, device)


class _Typed(http.server.BaseHTTPRequestHandler):
    """Answers ``POST /<status>`` with that status, a JSON error and
    ``Retry-After: 2`` on the typed sheds."""

    def do_POST(self):  # noqa: N802
        status = int(self.path.strip("/"))
        self.rfile.read(int(self.headers.get("Content-Length") or 0))
        body = json.dumps({"error": f"typed {status}"}).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        if status in (429, 503, 507):
            self.send_header("Retry-After", "2")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


@pytest.fixture(scope="module")
def typed_url():
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Typed)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


@pytest.mark.parametrize("status,retry_after", [(429, "2"), (507, "2"), (410, None),
                                                (200, None)])
def test_request_keeps_status_payload_and_retry_after(typed_url, status, retry_after):
    r = g.request(typed_url, f"/{status}", {"study_id": "s"})
    assert r.status == status
    assert r.payload == {"error": f"typed {status}"}
    assert r.retry_after == retry_after


def test_metric_reads_a_sample_and_defaults_to_zero():
    text = ("# TYPE hyperopt_tpu_chaos_corrupt_wal_total counter\n"
            "hyperopt_tpu_chaos_corrupt_wal_total 3\n"
            'hyperopt_tpu_service_shed_store_full_total{reason="enospc"} 2.5\n')
    assert g.metric(text, "hyperopt_tpu_chaos_corrupt_wal_total") == 3.0
    assert g.metric(text, "hyperopt_tpu_service_shed_store_full_total") == 2.5
    assert g.metric(text, "hyperopt_tpu_absent") == 0.0


def test_the_device_defaults_to_the_card_and_refuses_to_carry_on_without_one(monkeypatch):
    monkeypatch.delenv("TORCH_GATE_DEVICE", raising=False)
    assert g.gate_args("x", "", []).device == "cuda"
    monkeypatch.setenv("TORCH_GATE_DEVICE", "cpu")
    assert g.gate_args("x", "", [], n_studies=8).n_studies == 8
    assert g.prepare_device("cpu") == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            g.prepare_device("cuda")


def _run_gate(stem, *args, timeout=240):
    env = {**os.environ, "PYTHONPATH": REPO, "HYPEROPT_TPU_WATCHDOG": "0"}
    env.pop("HYPEROPT_TPU_CHAOS", None)
    res = subprocess.run([sys.executable, os.path.join(REPO, "scripts", f"{stem}.py"),
                          "--device", "cpu", *map(str, args)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, (res.stdout[-3000:], res.stderr[-3000:])
    results = [json.loads(ln.split(None, 1)[1]) for ln in res.stdout.splitlines()
               if ln.startswith("GATE_RESULT ")]
    assert len(results) == 1 and results[0]["ok"] and results[0]["device"] == "cpu"
    return results[0]


def test_slo_gate_end_to_end_at_one_study():
    res = _run_gate("torch_slo_smoke", "--n-studies", 1)
    assert res["studies"] == 1
    assert res["kernels"] == {"ei_diff": 0, "fused_sample_ei": 0, "q_mass_diff": 0}  # plain here


@pytest.mark.parametrize("i", [0, g.EI_DIFF_STUDY, 2])
def test_each_gate_serves_one_study_on_the_ei_diff_route(i, monkeypatch):
    """On the default route a TPE ask of study ``EI_DIFF_STUDY`` calls the
    ``ei_diff`` wrapper and no other study's does (they call the fused
    one), and its quantized label calls ``q_mass_diff``, so a gate's
    servers, held bit for bit against its reference, cross the three
    kernels.  The wrappers are counted here, where they take their plain
    versions."""
    from hyperopt_tpu_torch import megakernel

    calls = {"ei_diff": 0, "fused_sample_ei": 0, "q_mass_diff": 0}

    def counted(name):
        fn = getattr(megakernel, name)

        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    for name in calls:
        monkeypatch.setattr(megakernel, name, counted(name))
    monkeypatch.delenv("HYPEROPT_TPU_MEGAKERNEL", raising=False)
    g.reference_streams([g.Study(seed=5, budget=3, n_startup=1, loss=g.x_loss(0.5),
                                 spec=g.spec_of(i))], "cpu")
    on_ei_diff = i == g.EI_DIFF_STUDY
    assert (calls["ei_diff"] > 0, calls["fused_sample_ei"] > 0, calls["q_mass_diff"] > 0) == (
        on_ei_diff, not on_ei_diff, on_ei_diff)


def test_reference_counts_only_its_own_default_route_run(monkeypatch):
    """The counters are zeroed just before the reference's run: launches
    made before it (another route, a comparison) never reach ``kernels``."""
    from hyperopt_tpu_torch import megakernel

    monkeypatch.setattr(g, "LAUNCHES", {"ei_diff": 0, "fused_sample_ei": 0, "q_mass_diff": 0})
    monkeypatch.setattr(megakernel.ei_diff, "launches", 41)
    monkeypatch.setattr(megakernel.fused_sample_ei, "launches", 17)
    monkeypatch.setattr(megakernel.q_mass_diff, "launches", 5)
    monkeypatch.setenv("HYPEROPT_TPU_MEGAKERNEL", "off")
    studies = [g.Study(seed=5 + i, budget=3, n_startup=1, loss=g.x_loss(0.5),
                       spec=g.spec_of(i)) for i in range(2)]
    streams = g.reference_streams(studies, "cpu")
    assert [len(s) for s in streams] == [3, 3]
    assert g.LAUNCHES == {"ei_diff": 0, "fused_sample_ei": 0, "q_mass_diff": 0}
    assert os.environ["HYPEROPT_TPU_MEGAKERNEL"] == "off"  # restored after the run


def test_store_gate_at_its_smallest_size():
    res = _run_gate("torch_store_chaos_smoke", "--n-studies", 4, "--budget", 5, "--extra", 2,
                    "--corrupt-p", 0.05, "--enospc-clients", 2, "--enospc-budget", 3)
    assert res["injected"] >= 1 and res["scrub_corrupt"] + res["scrub_torn"] >= res["injected"]
    assert res["quarantined"] >= 1 and res["healthy_bitwise"] >= 1
    assert res["enospc_clients_done"] == 2


SLOW_GATES = [
    ("torch_service_chaos_smoke", ["--n-studies", 4, "--budget", 8, "--kill-tick", 3,
                                   "--overload-clients", 8,
                                   "--overload-budget", 4, "--degrade-asks", 8]),
    ("torch_fleet_smoke", ["--kill-studies", 6, "--kill-budget", 10, "--roll-studies", 3,
                           "--roll-budget", 6]),
    ("torch_tenant_smoke", ["--warm-rounds", 20, "--solo-sample", 10, "--mixed-rounds", 15]),
    ("torch_load_smoke", ["--hot-studies", 6]),
    ("torch_probe_smoke", ["--tenant-budget", 5]),
    ("torch_quality_smoke", ["--mix-n", 4]),
    ("torch_kernel_smoke", ["--mix-n", 2]),
    ("torch_coldstart_smoke", ["--n-spaces", 3, "--asks-per-study", 3, "--n-workers", 3]),
    ("torch_service_smoke", ["--n-studies", 12, "--n-workers", 4]),
]


@pytest.mark.slow
@pytest.mark.parametrize("stem,args", SLOW_GATES, ids=[s for s, _ in SLOW_GATES])
def test_gate_end_to_end_on_the_cpu(stem, args):
    _run_gate(stem, *args, timeout=600)
