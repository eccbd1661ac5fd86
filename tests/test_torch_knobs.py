"""Every ``HYPEROPT_TPU_*`` knob of the JAX package has one treatment in
the port (``_env.KNOBS``): honoured, refused with ``not_ported(knob,
item)`` at the entry points that read it, or accepted with no effect
because it only tunes XLA.  Knobs are set with ``monkeypatch`` only, so
none outlives its test."""

import importlib.util
import pathlib
import re

import numpy as np
import pytest

import hyperopt_tpu
import hyperopt_tpu_torch as port
from hyperopt_tpu_torch import _env, device_fmin, hp, zoo
from hyperopt_tpu_torch.base import Domain
from hyperopt_tpu_torch.service import StudyScheduler

PKG = pathlib.Path(port.__file__).resolve().parent
REF = pathlib.Path(hyperopt_tpu.__file__).resolve().parent

# a value that arms each refused knob (a path where the knob names a file)
ARMING = {
    "HYPEROPT_TPU_OBS": "{tmp}/run.jsonl",
    "HYPEROPT_TPU_PROFILE": "{tmp}/prof",
    "HYPEROPT_TPU_OBS_HTTP": "8123",
    "HYPEROPT_TPU_DEVMEM": "5",
    "HYPEROPT_TPU_FLIGHT": "{tmp}/run.flight.jsonl",
    "HYPEROPT_TPU_SERVICE_WAL": "{tmp}/service.wal.jsonl",
    "HYPEROPT_TPU_COMPILE_PLANE": "1",
    "HYPEROPT_TPU_COMPILE_BANK_TOP_N": "4",
    "HYPEROPT_TPU_SERVICE_DEGRADE": "on",
    "HYPEROPT_TPU_STORE_GC": "1",
    "HYPEROPT_TPU_STORE_WATERMARK": "0.05",
    "HYPEROPT_TPU_QUALITY": "on",
    "HYPEROPT_TPU_LOAD": "1",
    "HYPEROPT_TPU_TENANT": "yes",
    "HYPEROPT_TPU_TENANT_TOP_K": "8",
}

# values that disarm a refused knob: the port then behaves as the disarmed
# reference does
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


@pytest.mark.parametrize("name", sorted(n for n, k in _env.KNOBS.items()
                                        if k.treatment == "refused"))
def test_refused_knob_raises_naming_its_item(name, no_knobs, tmp_path):
    knob = _env.KNOBS[name]
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


@pytest.mark.parametrize("name", sorted(DISARMING))
def test_disarming_values_of_refused_knobs_are_accepted(name, no_knobs):
    for raw in DISARMING[name]:
        no_knobs.setenv(name, raw)
        for entry in _env.KNOBS[name].refused_at:
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
    no_knobs.setenv("HYPEROPT_TPU_COMPILE_PLANE", "on")
    with pytest.raises(NotImplementedError,
                       match=r"HYPEROPT_TPU_COMPILE_PLANE='on' .*item 13"):
        StudyScheduler(device="cpu")
    no_knobs.delenv("HYPEROPT_TPU_COMPILE_PLANE")
    no_knobs.setenv("HYPEROPT_TPU_DEVMEM", "5")
    with pytest.raises(NotImplementedError, match="HYPEROPT_TPU_DEVMEM='5' .*item 14"):
        _multihost()
    no_knobs.delenv("HYPEROPT_TPU_DEVMEM")
    no_knobs.setenv("HYPEROPT_TPU_SHARD", "2")  # honoured: one CPU, an unsharded loop
    device_fmin.DeviceLoopRunner(Domain(_quadratic, _SPACE), {}, 1, 4, device="cpu")
