"""Every ``HYPEROPT_TPU_*`` knob of the JAX package has one treatment in
the port (``_env.KNOBS``): honoured, refused with ``not_ported(knob,
item)`` at the entry points that read it, or accepted with no effect
because it only tunes XLA.  Knobs are set with ``monkeypatch`` only, so
none outlives its test.  The run's observability knobs, refused until
their planes were ported, are honoured: ``ObsConfig.from_env`` reads them
as the reference's does and ``fmin`` arms what they name.  So are the
prober's (``HYPEROPT_TPU_PROBE*``), the last knobs to be refused: no knob
is refused now, and the refusal mechanism is checked on a stand-in."""

import importlib.util
import pathlib
import re
import threading

import numpy as np
import pytest

import hyperopt_tpu
import hyperopt_tpu_torch as port
from hyperopt_tpu_torch import _env, device_fmin, hp, zoo
from hyperopt_tpu_torch.base import Domain
from hyperopt_tpu_torch.service import StudyScheduler
from hyperopt_tpu_torch.service.server import ServiceHTTPServer

PKG = pathlib.Path(port.__file__).resolve().parent
REF = pathlib.Path(hyperopt_tpu.__file__).resolve().parent

# a value that arms each refused (or once refused) knob (a path where the
# knob names a file)
ARMING = {
    "HYPEROPT_TPU_OBS": "{tmp}/run.jsonl",
    "HYPEROPT_TPU_PROFILE": "{tmp}/prof",
    "HYPEROPT_TPU_OBS_HTTP": "8123",
    "HYPEROPT_TPU_DEVMEM": "5",
    "HYPEROPT_TPU_FLIGHT": "{tmp}/run.flight.jsonl",
    "HYPEROPT_TPU_PROBE": "on",
    "HYPEROPT_TPU_PROBE_PERIOD": "5",
    "HYPEROPT_TPU_PROBE_SLO": "match=99",
}

# values that disarm a refused knob (or that a service knob, now honoured,
# reads as off): the port then behaves as the disarmed reference does
DISARMING = {
    "HYPEROPT_TPU_OBS": ["0", "off", "1", "basic"],
    "HYPEROPT_TPU_OBS_HTTP": ["0", "off"],
    "HYPEROPT_TPU_DEVMEM": ["off"],
    "HYPEROPT_TPU_FLIGHT": ["0", "off", "1"],
    "HYPEROPT_TPU_SERVICE_WAL": ["0", "off", "auto", "1"],
    "HYPEROPT_TPU_COMPILE_PLANE": ["0", "off"],
    "HYPEROPT_TPU_SERVICE_DEGRADE": ["0", "off"],
    "HYPEROPT_TPU_STORE_GC": ["off"],
    "HYPEROPT_TPU_STORE_WATERMARK": ["0"],
    "HYPEROPT_TPU_QUALITY": ["0"],
    "HYPEROPT_TPU_LOAD": ["off"],
    "HYPEROPT_TPU_TENANT": ["no"],
}

_SPACE = {"x": hp.uniform("x", -3, 3)}


def _quadratic(d):
    return (d["x"] - 1.0) ** 2


def _run_fmin():
    t = port.Trials(device="cpu")
    port.fmin(_quadratic, _SPACE, algo=port.rand.suggest, max_evals=3, trials=t, rstate=0,
              show_progressbar=False)
    return t


def _tpe_ask():
    t = port.Trials(device="cpu")
    return port.tpe.suggest([0], Domain(_quadratic, _SPACE), t, 0)


def _multihost():
    from hyperopt_tpu_torch.parallel import fmin_multihost

    return fmin_multihost(_quadratic, _SPACE, 4, batch=2, seed=0, _force_single=True,
                          device="cpu")


def _device_loop():
    dom = zoo.ZOO["quadratic1"]
    t = port.Trials(device="cpu")
    port.fmin(dom.traceable, dom.space, algo=port.rand.suggest, max_evals=2, trials=t,
              rstate=0, show_progressbar=False, device_loop=True)
    return t


ENTRY = {
    "fmin": _run_fmin,
    "fmin_multihost": _multihost,
    "tpe.suggest": _tpe_ask,
    "DeviceLoopRunner": _device_loop,
    "StudyScheduler": lambda: StudyScheduler(device="cpu"),
    "ServiceHTTPServer": lambda: ServiceHTTPServer(0, scheduler=StudyScheduler(device="cpu")),
}

# the service plane's knobs, honoured since the plane was ported: values
# the port reads as the reference does, and one it refuses (the reference
# warns and falls back)
SERVICE = {
    "HYPEROPT_TPU_SERVICE": ("parse_service", ["", "off", "8080", "0.0.0.0:9"], "http"),
    "HYPEROPT_TPU_SERVICE_WAL": ("parse_service_wal", ["", "on", "off", "{tmp}/w.jsonl"], None),
    "HYPEROPT_TPU_SERVICE_DEGRADE": ("parse_service_degrade", ["", "on", "off", "3"], "-1"),
    "HYPEROPT_TPU_SERVICE_QUEUE": ("parse_service_queue", ["", "16"], "0"),
    "HYPEROPT_TPU_SERVICE_DEADLINE_MS": ("parse_service_deadline_ms", ["", "off", "250"],
                                         "soon"),
    "HYPEROPT_TPU_SERVICE_ACCESS_LOG": ("parse_service_access_log",
                                        ["", "off", "{tmp}/access.jsonl"], None),
    "HYPEROPT_TPU_COMPILE_PLANE": ("parse_compile_plane", ["", "on", "0", "auto"], None),
    "HYPEROPT_TPU_COMPILE_BANK_TOP_N": ("parse_compile_bank_top_n", ["", "0", "4"], "-2"),
    "HYPEROPT_TPU_STORE_GC": ("parse_store_gc", ["", "off", "1"], None),
    "HYPEROPT_TPU_STORE_WATERMARK": ("parse_store_watermark", ["", "0", "0.05", "1e9"],
                                     "full"),
    "HYPEROPT_TPU_REQTRACE": ("parse_reqtrace", ["", "off", "1"], None),
    "HYPEROPT_TPU_SERVICE_SLO": ("parse_service_slo",
                                 ["", "off", "avail=99.5,ask_p99_ms=250,shed=2"], "speed=9"),
}

# the serving planes' and the fleet's knobs, honoured since they were
# ported: values the port reads as the reference does, and one it refuses
# (None: every value is read; the reference warns and falls back)
PLANES = {
    "HYPEROPT_TPU_QUALITY": ("parse_quality", ["", "0", "off", "1", "on"], None),
    "HYPEROPT_TPU_LOAD": ("parse_load", ["", "no", "1", "yes"], None),
    "HYPEROPT_TPU_TENANT": ("parse_tenant", ["", "false", "on"], None),
    "HYPEROPT_TPU_TENANT_TOP_K": ("parse_tenant_top_k", ["", "1", "8"], "0"),
    "HYPEROPT_TPU_QUALITY_SLO": ("parse_quality_slo", ["", "on", "off", "stagnant=5"],
                                 "stagnant=x"),
    "HYPEROPT_TPU_LOAD_SLO": ("parse_load_slo", ["", "off", "skew=2", "skew=2.5,balanced=5"],
                              "skew=0.5"),
    "HYPEROPT_TPU_TENANT_SLO": ("parse_tenant_slo",
                                ["", "off", "avail=0.95,ask_ms=250", "shed=0.5,ask_p=0.9"],
                                "ask_p99_ms=250"),
    "HYPEROPT_TPU_TENANT_QUOTA": ("parse_tenant_quota", ["", "off", "0", "2"], "many"),
    "HYPEROPT_TPU_FLEET_SHARDS": ("parse_fleet_shards", ["", "4", "16"], "0"),
    "HYPEROPT_TPU_FLEET_LEASE_TTL": ("parse_fleet_lease_ttl", ["", "3", "0.5"], "-1"),
    "HYPEROPT_TPU_FLEET_ADDR": ("parse_fleet_addr",
                                ["", "off", "http://127.0.0.1:1/", "http://h:2"], None),
}

# the multi-device knobs, each with values the port reads as the reference
# does, and one it refuses
MULTI_DEVICE = {
    "HYPEROPT_TPU_SHARD": (["", "off", "auto", "all", "3"], "-2"),
    "HYPEROPT_TPU_HIST_SHARD_MIN": (["", "1024", "64"], "0"),
    "HYPEROPT_TPU_ALLGATHER_TIMEOUT": (["", "0", "2.5"], "soon"),
    "HYPEROPT_TPU_PAYLOAD": (["", "u8", "f32"], "bits"),
}


@pytest.fixture(autouse=True)
def _disarmed_port_globals(monkeypatch):
    """``fmin_multihost`` beats the port's process-global watchdog: a
    disabled one here, so no thread outlives the test."""
    from hyperopt_tpu_torch.obs import flight, watchdog

    fr = flight.FlightRecorder()
    fr.enabled = False
    monkeypatch.setattr(flight, "_global", fr)
    monkeypatch.setattr(watchdog, "_global", watchdog._DISABLED)


@pytest.fixture
def no_knobs(monkeypatch):
    for name in _env.KNOBS:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def test_table_covers_every_knob_of_the_reference():
    names = set()
    for path in REF.rglob("*.py"):
        names.update(re.findall(r"HYPEROPT_TPU_[A-Z0-9_]+", path.read_text()))
    assert set(_env.KNOBS) == names and len(names) == 48
    assert {n for n, k in _env.KNOBS.items() if k.treatment == "honoured"} >= set(SERVICE)
    for name, knob in _env.KNOBS.items():
        assert knob.treatment in ("honoured", "refused", "none"), name
        assert (knob.item is not None) == (knob.treatment == "refused"), name
        if knob.refused_at:
            assert knob.arms is not None and set(knob.refused_at) <= set(ENTRY), name


def test_honoured_knobs_are_read_by_the_port():
    source = "\n".join(p.read_text() for p in PKG.rglob("*.py") if p.name != "_env.py")
    env_src = (PKG / "_env.py").read_text()
    for name, knob in _env.KNOBS.items():
        if knob.treatment == "honoured":
            assert name in source or f'"{name}"' in env_src.split("KNOBS = {")[0], name


# the knobs that were refused last (the blackbox prober's); a knob refused
# again later joins this list
ONCE_REFUSED = ("HYPEROPT_TPU_PROBE", "HYPEROPT_TPU_PROBE_PERIOD", "HYPEROPT_TPU_PROBE_SLO")


@pytest.mark.parametrize("name", sorted(ONCE_REFUSED))
def test_refused_knob_raises_naming_its_item(name, no_knobs, tmp_path):
    """A refused knob raises at its entry points; the prober's, refused
    until the prober was ported, are honoured there now."""
    knob = _env.KNOBS[name]
    if knob.treatment == "honoured":
        assert not knob.refused_at and knob.item is None
        no_knobs.setenv(name, ARMING[name].format(tmp=tmp_path))
        for entry in ("StudyScheduler", "ServiceHTTPServer"):
            ENTRY[entry]()  # nothing refuses it
        assert not any(tmp_path.iterdir())
        return
    if not knob.refused_at and knob.under is None:
        # the entry point that reads it is not in the port yet
        module = "hyperopt_tpu_torch." + knob.read_in.split()[0].replace("/", ".")
        assert importlib.util.find_spec(module) is None, module
        return
    no_knobs.setenv(name, ARMING[name].format(tmp=tmp_path))
    entries = knob.refused_at
    if knob.under is not None:  # read only under another knob, which raises first
        no_knobs.setenv(knob.under, ARMING[knob.under].format(tmp=tmp_path))
        entries = _env.KNOBS[knob.under].refused_at
    for entry in entries:
        with pytest.raises(NotImplementedError, match=f"item {knob.item}"):
            ENTRY[entry]()
    assert not any(tmp_path.iterdir())  # nothing the knob names was written


@pytest.mark.parametrize("name", sorted(MULTI_DEVICE))
def test_multi_device_knobs_are_honoured(name, no_knobs):
    from hyperopt_tpu import _env as ref_env
    from hyperopt_tpu_torch.parallel import payload

    assert _env.KNOBS[name].treatment == "honoured"
    read = {"HYPEROPT_TPU_SHARD": (_env.parse_shard, ref_env.parse_shard),
            "HYPEROPT_TPU_HIST_SHARD_MIN": (_env.parse_hist_shard_min,
                                            ref_env.parse_hist_shard_min),
            "HYPEROPT_TPU_ALLGATHER_TIMEOUT": (_env.parse_allgather_timeout,
                                               ref_env.parse_allgather_timeout),
            "HYPEROPT_TPU_PAYLOAD": (payload.wire_format, None)}[name]
    good, bad = MULTI_DEVICE[name]
    for raw in good:
        no_knobs.setenv(name, raw)
        if read[1] is not None:
            assert read[0]() == read[1](), raw
        else:
            assert read[0]() == (raw or "u8")
    no_knobs.setenv(name, bad)  # the reference warns and disarms; the port raises
    with pytest.raises(ValueError, match=name):
        read[0]()


@pytest.mark.parametrize("name", sorted(SERVICE))
def test_service_knobs_are_honoured(name, no_knobs, tmp_path):
    from hyperopt_tpu import _env as ref_env

    reader, good, bad = SERVICE[name]
    assert _env.KNOBS[name].treatment == "honoured"
    for raw in good:
        no_knobs.setenv(name, raw.format(tmp=tmp_path))
        assert getattr(_env, reader)() == getattr(ref_env, reader)(), raw
    if bad is not None:
        no_knobs.setenv(name, bad)  # the reference warns and falls back; the port raises
        with pytest.raises(ValueError, match=name):
            getattr(_env, reader)()


@pytest.mark.parametrize("name", sorted(PLANES))
def test_plane_and_fleet_knobs_are_honoured(name, no_knobs):
    from hyperopt_tpu import _env as ref_env

    reader, good, bad = PLANES[name]
    assert _env.KNOBS[name].treatment == "honoured" and not _env.KNOBS[name].refused_at
    for raw in good:
        no_knobs.setenv(name, raw)
        assert getattr(_env, reader)() == getattr(ref_env, reader)(), raw
        if raw:
            ENTRY["ServiceHTTPServer"]()  # the server and its scheduler read it
    if bad is not None:
        no_knobs.setenv(name, bad)  # the reference warns and falls back; the port raises
        with pytest.raises(ValueError, match=name):
            getattr(_env, reader)()


@pytest.mark.parametrize("name", sorted(DISARMING))
def test_disarming_values_of_refused_knobs_are_accepted(name, no_knobs):
    for raw in DISARMING[name]:
        no_knobs.setenv(name, raw)
        for entry in _env.KNOBS[name].refused_at or ("StudyScheduler", "ServiceHTTPServer"):
            ENTRY[entry]()


def test_knobs_without_a_counterpart_are_accepted_and_change_nothing(no_knobs, tmp_path):
    want = _run_fmin()
    for name, knob in _env.KNOBS.items():
        if knob.treatment == "none":
            no_knobs.setenv(name, str(tmp_path) if name.endswith("CACHE") else "1")
    got = _run_fmin()
    assert [d["misc"]["vals"] for d in got.trials] == [d["misc"]["vals"] for d in want.trials]
    assert got.losses() == want.losses()
    for entry in ENTRY.values():
        entry()
    assert not any(tmp_path.iterdir())


def test_unset_knobs_change_nothing(no_knobs):
    """With every knob unset each entry point runs, and honoured knobs set
    to their defaults give the same run."""
    for entry in ENTRY.values():
        entry()
    want = _run_fmin()
    for name, raw in (("HYPEROPT_TPU_HIST_DTYPE", "f32"), ("HYPEROPT_TPU_MEGAKERNEL", "on"),
                      ("HYPEROPT_TPU_TRIAL_RETRIES", "0"), ("HYPEROPT_TPU_CHAOS", "off"),
                      ("HYPEROPT_TPU_COMPILE_WIDEN", "0")):
        no_knobs.setenv(name, raw)
    got = _run_fmin()
    np.testing.assert_array_equal(got.losses(), want.losses())
    assert _env.refuse_armed_knobs("fmin") is None


def test_not_ported_names_the_knob_and_its_value(no_knobs):
    """The refusal mechanism stays for the next path that is not ported: a
    stand-in refused knob raises at the entry point that reads it, naming
    itself, its value and its item."""
    assert _env.refuse_armed_knobs("ServiceHTTPServer") is None
    no_knobs.setitem(_env.KNOBS, "HYPEROPT_TPU_STANDIN", _env.Knob(
        "refused", "99", "service/server", ("ServiceHTTPServer",), lambda r: r == "on"))
    no_knobs.setenv("HYPEROPT_TPU_STANDIN", "on")
    with pytest.raises(NotImplementedError, match=r"HYPEROPT_TPU_STANDIN='on' .*item 99"):
        ENTRY["ServiceHTTPServer"]()
    StudyScheduler(device="cpu")  # read by the server only: the scheduler is unaffected
    no_knobs.setenv("HYPEROPT_TPU_STANDIN", "off")
    ENTRY["ServiceHTTPServer"]()
    no_knobs.delitem(_env.KNOBS, "HYPEROPT_TPU_STANDIN")
    no_knobs.delenv("HYPEROPT_TPU_STANDIN")
    no_knobs.setenv("HYPEROPT_TPU_DEVMEM", "5")  # honoured now: the run samples
    assert _multihost().n_evals == 4
    no_knobs.delenv("HYPEROPT_TPU_DEVMEM")
    no_knobs.setenv("HYPEROPT_TPU_SHARD", "2")  # honoured: one CPU, an unsharded loop
    device_fmin.DeviceLoopRunner(Domain(_quadratic, _SPACE), {}, 1, 4, device="cpu")


OBS_KNOBS = ("HYPEROPT_TPU_OBS", "HYPEROPT_TPU_PROFILE", "HYPEROPT_TPU_OBS_HTTP",
             "HYPEROPT_TPU_DEVMEM", "HYPEROPT_TPU_FLIGHT", "HYPEROPT_TPU_COMPILE_CACHE")


@pytest.mark.parametrize("name", OBS_KNOBS)
def test_obs_knobs_are_honoured(name, no_knobs, tmp_path):
    """Each run-plane knob is honoured: the run's config reads it as the
    reference's does, ``fmin`` arms what it names and proposes what it
    proposes disarmed."""
    import dataclasses
    import socket

    from hyperopt_tpu.obs import ObsConfig as RefObsConfig
    from hyperopt_tpu_torch import _build
    from hyperopt_tpu_torch.obs import ObsConfig

    assert _env.KNOBS[name].treatment == "honoured" and not _env.KNOBS[name].refused_at
    want = _run_fmin()
    raw = ARMING.get(name, "{tmp}/cc").format(tmp=tmp_path)
    if name == "HYPEROPT_TPU_OBS_HTTP":
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            raw = str(sock.getsockname()[1])
    no_knobs.setenv(name, raw)
    assert dataclasses.asdict(ObsConfig.from_env()) == dataclasses.asdict(
        RefObsConfig.from_env())
    try:
        got = _run_fmin()
        built = _build.build_dir()
    finally:
        _build.set_build_dir(None)
    assert [d["misc"]["vals"] for d in got.trials] == [d["misc"]["vals"] for d in want.trials]
    armed = {
        "HYPEROPT_TPU_OBS": lambda: (tmp_path / "run.jsonl").stat().st_size > 0,
        "HYPEROPT_TPU_PROFILE": lambda: got.obs_profiler is not None,
        "HYPEROPT_TPU_OBS_HTTP": lambda: got.obs_http_url.endswith(":" + raw),
        "HYPEROPT_TPU_DEVMEM": lambda: got.obs_metrics.counter("devmem.samples").value >= 1,
        "HYPEROPT_TPU_FLIGHT": lambda: ObsConfig.from_env().flight_path == raw,
        "HYPEROPT_TPU_COMPILE_CACHE": lambda: built == (tmp_path / "cc").resolve(),
    }[name]
    assert armed()


# the prober's knobs: values the port reads as the reference does (a
# malformed one warns and keeps the default in both)
PROBE = {
    "HYPEROPT_TPU_PROBE": ("parse_probe", ["", "1", "on", "off", "maybe"]),
    "HYPEROPT_TPU_PROBE_PERIOD": ("parse_probe_period", ["", "2.5", "0", "soon"]),
    "HYPEROPT_TPU_PROBE_SLO": ("parse_probe_slo",
                               ["", "off", "avail=99.5,ask_p99_ms=500", "golden=90,junk"]),
}


@pytest.mark.parametrize("name", sorted(PROBE))
def test_probe_knobs_are_honoured(name, no_knobs, tmp_path):
    """Each ``HYPEROPT_TPU_PROBE*`` knob is read as the reference reads
    it, and the server arms the prober with what it names."""
    from hyperopt_tpu import _env as ref_env

    reader, values = PROBE[name]
    assert _env.KNOBS[name].treatment == "honoured" and not _env.KNOBS[name].refused_at
    for raw in values:
        no_knobs.setenv(name, raw)
        assert getattr(_env, reader)() == getattr(ref_env, reader)(), raw
    no_knobs.setenv(name, {"HYPEROPT_TPU_PROBE": "1", "HYPEROPT_TPU_PROBE_PERIOD": "45",
                           "HYPEROPT_TPU_PROBE_SLO": "ask_p99_ms=750"}[name])
    srv = ServiceHTTPServer(0, scheduler=StudyScheduler(device="cpu", wal=False))
    assert srv.prober is None  # the knob arms it only once the server is bound
    try:
        assert srv.start()
        p = srv.arm_prober()
        if name == "HYPEROPT_TPU_PROBE":
            assert _env.parse_probe()
        elif name == "HYPEROPT_TPU_PROBE_PERIOD":
            assert p.period == 45.0
        else:
            assert srv.slo.objectives["probe_ask_p99_ms"].threshold_ms == 750.0
    finally:
        srv.stop()
    assert "hyperopt-prober" not in {t.name for t in threading.enumerate()}


def test_profile_knob_arms_a_capture_plane_at_the_server(no_knobs, tmp_path):
    """``HYPEROPT_TPU_PROFILE`` arms the server's capture plane (it only
    logged before): the server's profiler is every scheduler's, an SLO fast
    burn takes one wave capture, and unset it arms nothing."""
    import time

    assert ServiceHTTPServer(0, scheduler=StudyScheduler(device="cpu")).profiler is None
    no_knobs.setenv("HYPEROPT_TPU_PROFILE", str(tmp_path / "caps"))
    sched = StudyScheduler(device="cpu", wal=False)
    srv = ServiceHTTPServer(0, scheduler=sched)
    assert srv.profiler is not None and sched.profiler is srv.profiler
    assert srv.profiler.out_dir == str(tmp_path / "caps")
    sid = sched.create_study(_SPACE, seed=1, n_startup_jobs=0)
    srv._slo_escalation()
    deadline = time.monotonic() + 60.0
    while not srv.profiler.captures and time.monotonic() < deadline:
        (a,) = sched.ask(sid)
        sched.tell(sid, a["tid"], 1.0)
    (rec,) = srv.profiler.captures
    assert rec["reason"] == "slo_burn" and rec["scope"] == "wave leader"
    assert rec["waves"] == 1 and rec["kernels"] == 0  # the CPU runs no device kernel
