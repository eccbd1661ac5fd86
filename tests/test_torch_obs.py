"""The port's run observability against the JAX package's, on the CPU.

- an armed ``fmin`` (JSONL stream, scrape server, capture plane,
  device-memory samples) proposes bit for bit what the disarmed run
  does, on branin and on a space with discrete, quantized, log and
  unbounded labels (ε-prior on);
- its health records equal the reference's armed run's: float stats at
  rtol 1e-5, atol 1e-6, ``sel_rank``, ``dup_rate``, ``prior_takes`` and
  the split sizes exactly;
- each package's report renders the other's stream to the same text
  (``render``, ``json_report``);
- ``ObsConfig.from_env`` equals the reference's on a table of values;
- the ``torch.profiler`` capture plane: bounded, exclusive, fail-open,
  one stall capture per run, a capture asked for on another thread is
  recorded by ``fmin``'s loop thread, and its artifact merges into the
  export, which ``scripts/validate_trace.py`` lints clean;
- device memory, the scrape server, the analytic kernel cost (one
  yardstick with ``chip_smoke.py``), the trajectory store and the
  quality record.

The reference's armed tick is compiled once per space in the module
fixture.  Both packages' flight recorders and watchdogs are disabled
while the runs of this module execute, so no handler or thread outlives
them."""

import dataclasses
import functools
import gzip
import json
import math
import os
import pickle
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import hyperopt_tpu as ref
from hyperopt_tpu import obs as ref_obs
from hyperopt_tpu.obs import devmem as ref_devmem
from hyperopt_tpu.obs import flight as ref_flight
from hyperopt_tpu.obs import report as ref_report
from hyperopt_tpu.obs import trajectory as ref_trajectory
from hyperopt_tpu.obs import watchdog as ref_watchdog
from hyperopt_tpu import progress as ref_progress
from hyperopt_tpu import zoo as ref_zoo
import hyperopt_tpu_torch as port
from hyperopt_tpu_torch import megakernel, obs, progress
from hyperopt_tpu_torch import zoo as port_zoo
from hyperopt_tpu_torch.base import Domain
from hyperopt_tpu_torch.obs import devmem, export, flight, health, report, serve, trajectory
from hyperopt_tpu_torch.obs import watchdog
from hyperopt_tpu_torch.obs.profiler import DeviceProfiler, annotation_ctx, split_profile_mode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6
EVALS, STARTUP, CANDIDATES = 40, 10, 64
EXACT = ("sel_rank", "dup_rate", "prior_takes", "n", "n_label_proposals", "n_below",
         "n_above")


def _space(hp):
    return {"x": hp.uniform("x", -5, 5), "y": hp.uniform("y", 0, 3),
            "lr": hp.loguniform("lr", math.log(1e-3), math.log(1.0)),
            "z": hp.normal("z", 0, 1), "q": hp.quniform("q", 0, 10, 1),
            "c": hp.choice("c", ["a", "b", "c"]), "k": hp.randint("k", 4)}


def _mixed(d):
    return ((d["x"] - 1.0) ** 2 + d["y"] + 0.1 * abs(math.log(d["lr"]) + 3.0)
            + 0.5 * d["z"] ** 2 + 0.05 * d["q"] + {"a": 0.0, "b": 0.3, "c": 0.6}[d["c"]]
            + 0.1 * d["k"])


def _case(pkg, name):
    if name == "branin":
        dom = (ref_zoo if pkg is ref else port_zoo).ZOO["branin"]
        return dom.objective, dom.space, {}
    return _mixed, _space(pkg.hp), {"prior_eps": 0.3}


def _fmin(pkg, name, **kw):
    fn, space, tuning = _case(pkg, name)
    t = pkg.Trials(device="cpu") if pkg is port else pkg.Trials()
    algo = functools.partial(pkg.tpe.suggest, n_startup_jobs=STARTUP,
                             n_EI_candidates=CANDIDATES, **tuning)
    pkg.fmin(fn, space, algo=algo, max_evals=EVALS, trials=t,
             rstate=np.random.default_rng(5), show_progressbar=False, **kw)
    return t


def _quiet_globals(mp):
    """Disabled flight recorders and watchdogs in both packages."""
    for fl, wd in ((flight, watchdog), (ref_flight, ref_watchdog)):
        fr = fl.FlightRecorder()
        fr.enabled = False
        mp.setattr(fl, "_global", fr)
        mp.setattr(wd, "_global", wd._DISABLED)


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    _quiet_globals(monkeypatch)
    for name in ("HYPEROPT_TPU_OBS", "HYPEROPT_TPU_PROFILE", "HYPEROPT_TPU_OBS_HTTP",
                 "HYPEROPT_TPU_DEVMEM", "HYPEROPT_TPU_FLIGHT"):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per case: the port's armed and disarmed runs and the reference's
    armed run, with their streams."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _quiet_globals(mp)
        mp.setenv("HYPEROPT_TPU_DEVMEM", "1")
        for name in ("branin", "mixed"):
            d = tmp_path_factory.mktemp(name)
            armed = _fmin(port, name, obs=str(d / "port.jsonl"), obs_http=0,
                          profile=str(d / "prof"))
            ref_armed = _fmin(ref, name, obs=str(d / "ref.jsonl"))
            mp.delenv("HYPEROPT_TPU_DEVMEM")
            plain = _fmin(port, name)
            mp.setenv("HYPEROPT_TPU_DEVMEM", "1")
            out[name] = {"armed": armed, "plain": plain, "ref": ref_armed,
                         "port_stream": obs.read_jsonl(str(d / "port.jsonl")),
                         "ref_stream": ref_obs.read_jsonl(str(d / "ref.jsonl")), "dir": d}
    return out


def _vals(trials):
    return [(t["tid"], t["misc"]["vals"]) for t in trials.trials]


# ---------------------------------------------------------------------------
# the armed run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["branin", "mixed"])
def test_armed_run_proposes_what_the_disarmed_run_does(runs, name):
    r = runs[name]
    assert _vals(r["armed"]) == _vals(r["plain"])
    assert r["armed"].losses() == r["plain"].losses()
    assert r["armed"].obs_health is not None and r["plain"].obs_health is None
    kinds = {rec["kind"] for rec in r["port_stream"]}
    assert {"span", "trial_event", "health", "devmem", "metrics"} <= kinds


@pytest.mark.parametrize("name", ["branin", "mixed"])
def test_health_records_match_the_reference(runs, name):
    r = runs[name]
    got = [x for x in r["port_stream"] if x["kind"] == "health"]
    want = [x for x in r["ref_stream"] if x["kind"] == "health"]
    assert len(got) == len(want) == EVALS - STARTUP
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if k in ("ts", "run_id"):
                continue
            if k == "labels":
                assert g[k].keys() == v.keys()
                for label, stats in v.items():
                    for s, x in stats.items():
                        if s == "dup_rate":
                            assert g[k][label][s] == x, (label, s)
                        else:
                            np.testing.assert_allclose(g[k][label][s], x, rtol=RTOL,
                                                       atol=ATOL, err_msg=f"{label} {s}")
            elif k in EXACT or isinstance(v, str):
                assert g[k] == v, k
            else:
                np.testing.assert_allclose(g[k], v, rtol=RTOL, atol=ATOL, err_msg=k)
    if name == "mixed":  # the ε-prior took some label proposals
        assert sum(x["prior_takes"] for x in got) > 0


def test_armed_trial_streams_match_the_reference(runs):
    for r in runs.values():
        for a, b in zip(r["ref"].trials, r["armed"].trials):
            assert a["misc"]["vals"].keys() == b["misc"]["vals"].keys()
            for k, v in a["misc"]["vals"].items():
                np.testing.assert_allclose(b["misc"]["vals"][k], v, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_reports_render_each_others_streams_to_the_same_text(runs, writer):
    for r in runs.values():
        recs = r[f"{writer}_stream"]
        text = report.render(recs)
        assert text == ref_report.render(recs)
        for section in ("phase-time breakdown", "search health", "trial-state waterfall",
                        "kernel roofline" if writer == "port" else "metrics snapshot"):
            assert section in text
        streams = [("run.jsonl", recs)]
        assert report.json_report(streams) == ref_report.json_report(streams)


def test_report_cli_renders_sections_and_exports(runs, tmp_path, capsys):
    path = str(runs["branin"]["dir"] / "port.jsonl")
    assert report.main([path]) == 0
    text = capsys.readouterr().out
    assert "device memory" in text and "suggest.tpe" in text
    assert report.main(["--format", "json", path]) == 0
    assert "sections" in json.loads(capsys.readouterr().out)
    out = str(tmp_path / "t.json")
    assert report.main(["--export-trace", out, path]) == 0
    rc = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "validate_trace.py"),
                         out], capture_output=True, text=True, timeout=120)
    assert rc.returncode == 0, rc.stdout + rc.stderr
    assert "no probe ledgers" in report.render_probes(str(tmp_path))


def test_tpe_cost_gauges_count_the_launched_ei_shapes(runs, monkeypatch):
    """``suggest.tpe.flops/.bytes`` are ``megakernel.ei_cost`` summed over
    the shapes a tick launches ``ei_diff`` at: ``ei_shapes`` predicts the
    shapes the wrapper sees on the mixed space's ask (a group of three,
    one unbounded label, the ε-prior's second launch of each)."""
    seen = []
    real = megakernel.ei_diff

    def spy(x, *tables):
        seen.append((x.shape[0], x.shape[1], tables[0].shape[-1]))
        return real(x, *tables)

    monkeypatch.setattr(megakernel, "ei_diff", spy)
    t = runs["mixed"]["plain"]
    domain = Domain(_mixed, _space(port.hp))
    cfg = {"prior_weight": 1.0, "n_EI_candidates": CANDIDATES, "gamma": 0.25, "LF": 25,
           "ei_select": "argmax", "ei_tau": 1.0, "prior_eps": 0.3}
    port.tpe.suggest([1000, 1001], domain, t, 3, n_startup_jobs=STARTUP,
                     n_EI_candidates=CANDIDATES, prior_eps=0.3)
    cap = t.history_object(domain.cs.labels).cap
    want = port.tpe._get_propose(domain.cs, cfg).ei_shapes(2, cap)
    assert sorted(seen) == sorted(want)
    assert sorted(want) == sorted([(3, 128, cap + 1), (1, 128, cap + 1), (3, 2, cap + 1),
                                   (1, 2, cap + 1)])
    final = [x for x in runs["mixed"]["port_stream"] if x["kind"] == "metrics"][-1]
    dev = final["snapshot"]["shared"]["device"]["metrics"]
    assert dev["suggest.tpe.exp_ops"] == 1.0 and dev["suggest.tpe.flops"] > 0


def test_one_cost_yardstick_with_chip_smoke():
    """``chip_smoke.py``'s roofline and ``obs/health.py``'s gauges read
    ``megakernel.ei_cost`` / ``fused_cost``: on phase 1's shapes the
    counts are the ones the script used before they moved (2·P·n·m
    exponentials; x, out and six tables), and the bounds follow."""
    sys.path.insert(0, REPO)
    import chip_smoke

    for P, n, m, *_ in chip_smoke.EI_SHAPES:
        ops, nbytes = megakernel.ei_cost(P, n, m)
        assert (ops, nbytes) == (2 * P * n * m, 4 * (2 * P * n + 6 * P * m))
        assert health.ei_launch_cost([(P, n, m)]) == (ops, nbytes)
        ms, by = chip_smoke.ei_bound(P, n, m)
        want = max(ops / chip_smoke.SFU_PER_S, nbytes / chip_smoke.HBM_BYTES_PER_S) * 1e3
        assert ms == pytest.approx(want, rel=1e-12)
    for P, N, m, *_ in chip_smoke.FUSED_SHAPES:
        ops, nbytes = megakernel.fused_cost(P, N, m)
        assert (ops, nbytes) == (2 * P * N * m + P * N, 16 * P * N + 36 * P * m + 8 * P)
        ms, _ = chip_smoke.fused_bound(P, N, m)
        assert ms == pytest.approx(max(ops / chip_smoke.SFU_PER_S,
                                       nbytes / chip_smoke.HBM_BYTES_PER_S) * 1e3, rel=1e-12)


def test_device_loop_records_its_compile_execute_split_and_cost(tmp_path):
    dom = port_zoo.ZOO["branin"]
    dev = obs.get_metrics("device")
    before = dev.snapshot()["metrics"].get("chunk.execute_sec", {}).get("count", 0)
    t = port.Trials(device="cpu")
    port.fmin(dom.traceable, dom.space, max_evals=30, trials=t, rstate=0,
              show_progressbar=False, device_loop=True, obs=str(tmp_path / "d.jsonl"),
              algo=functools.partial(port.tpe.suggest, n_EI_candidates=32))
    snap = dev.snapshot()["metrics"]
    assert snap["chunk.execute_sec"]["count"] == before + 3
    ops, nbytes = health.ei_launch_cost([(2, 32, 31)])
    assert snap["chunk.flops"] == 10 * ops and snap["chunk.bytes"] == 10 * nbytes
    text = report.render(obs.read_jsonl(str(tmp_path / "d.jsonl")))
    assert "chunk" in text and text == ref_report.render(obs.read_jsonl(str(tmp_path / "d.jsonl")))


def test_device_loop_chunk_spans_split_suggest_and_record(tmp_path):
    dom = port_zoo.ZOO["branin"]
    path = str(tmp_path / "d.jsonl")
    runs = {}
    for armed in (False, True):
        t = port.Trials(device="cpu")
        port.fmin(dom.traceable, dom.space, max_evals=40, trials=t, rstate=3,
                  show_progressbar=False, device_loop=True, obs=path if armed else None,
                  early_stop_fn=lambda trials, *args: (False, list(args)),
                  algo=functools.partial(port.tpe.suggest, n_EI_candidates=32))
        runs[armed] = t
        names = ("suggest", "suggest.dispatch", "suggest.readback", "record", "refresh",
                 "early_stop")
        assert {k: t.phase_timings[k]["count"] for k in names} == dict.fromkeys(names, 4)
    assert ([d["misc"]["vals"] for d in runs[True].trials]
            == [d["misc"]["vals"] for d in runs[False].trials])
    assert runs[True].losses() == runs[False].losses()
    recs = obs.read_jsonl(path)
    spans = [r for r in recs if r.get("kind") == "span"]
    name_of = {r["span_id"]: r["name"] for r in spans}
    inner = [r for r in spans if r["name"] in ("suggest.dispatch", "suggest.readback")]
    assert len(inner) == 8 and {name_of[r["parent_id"]] for r in inner} == {"suggest"}
    outer = [r for r in spans if r["name"] in ("record", "early_stop")]
    assert len(outer) == 8 and "suggest" not in {name_of.get(r["parent_id"]) for r in outer}
    assert report.render(recs) == ref_report.render(recs)
    streams = [("d.jsonl", recs)]
    assert report.json_report(streams) == ref_report.json_report(streams)


def test_trials_pickle_drops_the_live_obs_handles(runs):
    t = pickle.loads(pickle.dumps(runs["branin"]["armed"]))
    assert getattr(t, "obs_health", None) is None and getattr(t, "obs_profiler", None) is None
    assert len(t.trials) == EVALS


def test_progress_postfix_equals_the_reference(runs):
    metrics = runs["branin"]["armed"].obs_metrics
    bundle = obs.RunObs(obs.ObsConfig(level="trace", jsonl_path=os.devnull))
    ref_bundle = ref_obs.RunObs(ref_obs.ObsConfig(level="trace", jsonl_path=os.devnull))
    try:
        for b in (bundle, ref_bundle):
            for k in ("health.asks", ):
                b.metrics.counter(k).inc(metrics.counter(k).value)
            for k in ("health.last_ei_p50", "health.last_dup_rate"):
                b.metrics.gauge(k).set(metrics.gauge(k).value)
        assert progress.format_postfix(1.5, bundle) == ref_progress.format_postfix(
            1.5, ref_bundle)
        assert "EI p50" in progress.format_postfix(1.5, bundle)
        assert progress.format_postfix(1.5) == "best loss: 1.5"
    finally:
        bundle.finish()
        ref_bundle.finish()


# ---------------------------------------------------------------------------
# ObsConfig and the knobs
# ---------------------------------------------------------------------------


ENV_TABLE = [
    {}, {"HYPEROPT_TPU_OBS": "run.jsonl"}, {"HYPEROPT_TPU_OBS": "off"},
    {"HYPEROPT_TPU_OBS": "1"}, {"HYPEROPT_TPU_OBS": "basic"},
    {"HYPEROPT_TPU_PROFILE": "caps"}, {"HYPEROPT_TPU_PROFILE": "full:whole"},
    {"HYPEROPT_TPU_PROFILE": "full:"}, {"HYPEROPT_TPU_OBS_HTTP": "9109"},
    {"HYPEROPT_TPU_OBS_HTTP": "0.0.0.0:9109"}, {"HYPEROPT_TPU_OBS_HTTP": "0"},
    {"HYPEROPT_TPU_OBS_HTTP": "x:y"}, {"HYPEROPT_TPU_OBS_HTTP": "70000"},
    {"HYPEROPT_TPU_DEVMEM": "1"}, {"HYPEROPT_TPU_DEVMEM": "on"},
    {"HYPEROPT_TPU_DEVMEM": "2.5"}, {"HYPEROPT_TPU_DEVMEM": "-1"},
    {"HYPEROPT_TPU_DEVMEM": "soon"}, {"HYPEROPT_TPU_FLIGHT": "dump.jsonl"},
    {"HYPEROPT_TPU_FLIGHT": "0"}, {"HYPEROPT_TPU_FLIGHT": "1"},
    {"HYPEROPT_TPU_OBS": "a.jsonl", "HYPEROPT_TPU_PROFILE": "p",
     "HYPEROPT_TPU_OBS_HTTP": "127.0.0.1:0", "HYPEROPT_TPU_DEVMEM": "3"},
]


def test_obsconfig_from_env_equals_the_reference():
    for env in ENV_TABLE:
        got = dataclasses.asdict(obs.ObsConfig.from_env(env))
        assert got == dataclasses.asdict(ref_obs.ObsConfig.from_env(env)), env
        for path in (None, "p.jsonl"):
            with pytest.MonkeyPatch.context() as mp:
                for k, v in env.items():
                    mp.setenv(k, v)
                assert dataclasses.asdict(obs.ObsConfig.resolve(path)) == dataclasses.asdict(
                    ref_obs.ObsConfig.resolve(path)), (env, path)
    assert split_profile_mode("full:/x") == (None, "/x")


# ---------------------------------------------------------------------------
# the capture plane
# ---------------------------------------------------------------------------


class _Sleep:
    def __init__(self):
        self.calls = []

    def __call__(self, sec):
        self.calls.append(sec)


class _Session:
    """A stand-in ``torch.profiler`` session (no CUPTI, no waiting)."""

    def stop(self):
        pass

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": []}, f)


def _stubbed(tmp_path, monkeypatch, **kw):
    from hyperopt_tpu_torch.obs import profiler

    monkeypatch.setattr(profiler, "_start_session", _Session)
    sleep = _Sleep()
    return DeviceProfiler(str(tmp_path / "caps"), clock=sleep, **kw), sleep


def test_capture_is_bounded_exclusive_and_fails_open(tmp_path, monkeypatch):
    from hyperopt_tpu_torch.obs import profiler

    prof, sleep = _stubbed(tmp_path, monkeypatch, max_capture_sec=30.0)
    rec = prof.capture(3600)
    assert rec["ok"] and rec["sec"] == 30.0 and sleep.calls == [30.0]
    assert rec["trace_json"].endswith("device.trace.json.gz")
    for bad in ("abc", None, 0, -1):
        assert not prof.capture(bad)["ok"]
    assert prof.capture_count == 1
    with prof._lock:
        busy = prof.capture(1)
    assert not busy["ok"] and busy["busy"]

    def boom():
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(profiler, "_start_session", boom)
    bad = prof.capture(1)
    assert not bad["ok"] and "RuntimeError" in bad["error"]


def test_stall_escalation_captures_once_per_run(tmp_path, monkeypatch):
    class Clock:
        t = 0.0

        def __call__(self):
            return self.t

    clock = Clock()
    wd = watchdog.Watchdog(quiet_sec=300.0, clock=clock, flight=flight.FlightRecorder())
    wd.retain()
    prof, sleep = _stubbed(tmp_path, monkeypatch, stall_capture_sec=5.0)
    prof.attach_loop()  # a wedged loop: the stall capture runs on the watchdog's thread
    wd.add_escalation(prof.capture_on_stall)
    wd.beat("fmin.tick", n=1)
    clock.t = 301.0
    assert wd.check() is not None and prof.capture_count == 1 and sleep.calls == [5.0]
    clock.t = 700.0
    assert wd.check() is not None and prof.capture_count == 1
    assert prof.captures[0]["reason"] == "stall" and prof.captures[0]["thread"] == "caller"
    # the session ran on the watchdog's thread and holds none of the loop's
    # kernels: the record and the stall record in the postmortem say so
    rec = prof.captures[0]
    assert rec["scope"] == "watchdog thread" and rec["kernels"] == 0
    assert not rec["ok"] and "trace_json" not in rec and "no device kernel" in rec["error"]
    stall = next(r for r in wd._flight.records() if r.get("kind") == "stall")
    assert stall["capture"]["scope"] == "watchdog thread" and stall["capture"]["kernels"] == 0
    prof.reset_stall_budget()
    prof.capture_on_stall()
    assert prof.capture_count == 2
    prof.detach_loop()


def test_real_cpu_capture_round_trip(tmp_path):
    prof = DeviceProfiler(str(tmp_path / "caps"), max_capture_sec=2.0,
                          clock=lambda s: torch.ones(64).sum())
    with prof.annotation("fmin.tick", step=1, tid=3):
        torch.ones(8) * 2
    rec = prof.capture(0.1, reason="test")
    assert rec["ok"], rec
    with gzip.open(rec["trace_json"], "rt") as f:
        data = json.load(f)
    assert data["traceEvents"] and rec["t1"] >= rec["t0"]


def test_capture_asked_on_another_thread_is_recorded_by_the_loop(tmp_path):
    """While ``fmin`` runs, a capture asked for on another thread (the
    HTTP handler's case) is started and stopped by the loop at its tick
    boundaries, so the trace holds the loop's ``fmin.tick`` annotations;
    the merged export lints clean and the run's proposals do not move."""
    box = {}

    def objective(d):
        if len(box) == 0 and objective.calls == 15:
            prof = objective.trials.obs_profiler
            th = threading.Thread(target=lambda: box.setdefault("rec", prof.capture(0.3)))
            th.start()
            box["thread"] = th
        objective.calls += 1
        time.sleep(0.01)
        return (d["x"] - 1.0) ** 2 + d["y"]

    space = {"x": port.hp.uniform("x", -5, 5), "y": port.hp.uniform("y", 0, 3)}
    objective.calls = 0
    t = objective.trials = port.Trials(device="cpu")
    path = str(tmp_path / "run.jsonl")
    algo = functools.partial(port.tpe.suggest, n_startup_jobs=5, n_EI_candidates=16)
    port.fmin(objective, space, algo=algo, max_evals=60, trials=t, rstate=3,
              show_progressbar=False, obs=path, profile=str(tmp_path / "caps"))
    box["thread"].join(timeout=120)
    rec = box["rec"]
    assert rec["ok"] and rec["thread"] == "loop", rec
    with gzip.open(rec["trace_json"], "rt") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any(n.startswith("fmin.tick#step=") for n in names)
    plain = port.Trials(device="cpu")
    objective.calls, box = 1000, {"x": 1}
    port.fmin(objective, space, algo=algo, max_evals=60, trials=plain, rstate=3,
              show_progressbar=False)
    assert _vals(plain) == _vals(t)
    out = str(tmp_path / "merged.json")
    assert report.main(["--export-trace", out, path]) == 0
    with open(out) as f:
        events = json.load(f)["traceEvents"]
    dev = {e["pid"] for e in events if e["ph"] != "M" and e["pid"] >= export.DEVICE_PID_BASE}
    assert dev and any(e.get("name") == "process_name" and e["pid"] in dev
                       and e["args"]["name"].startswith("device:") for e in events)
    rc = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "validate_trace.py"),
                         out], capture_output=True, text=True, timeout=120)
    assert rc.returncode == 0, rc.stdout + rc.stderr


def test_profile_endpoint_fails_open_and_bounds_the_capture(tmp_path, monkeypatch):
    from hyperopt_tpu_torch.obs import profiler

    def get(url):
        with urllib.request.urlopen(url, timeout=30) as r:
            return json.loads(r.read().decode())

    off = obs.RunObs(obs.ObsConfig(http_port=0), run_id="prof-off")
    try:
        body = get(off.http.url + "/profile?sec=1")
        assert body["ok"] is False and "not armed" in body["error"]
    finally:
        off.finish()
    monkeypatch.setattr(profiler, "_start_session", _Session)
    on = obs.RunObs(obs.ObsConfig(http_port=0, profile_dir=str(tmp_path / "caps")),
                    run_id="prof-on")
    try:
        on.profiler._sleep = _Sleep()
        on.profiler.max_capture_sec = 2.0
        body = get(on.http.url + "/profile?sec=999")
        assert body["ok"] and body["sec"] == 2.0 and body["reason"] == "http"
        assert not get(on.http.url + "/profile?sec=abc")["ok"]
    finally:
        on.finish()


def test_disarmed_annotation_is_a_shared_null_context():
    assert annotation_ctx(None, "fmin.tick", step=1) is annotation_ctx(None, "x")
    bundle = obs.RunObs(obs.ObsConfig(), run_id="ann-off")
    try:
        assert bundle.annotate("fmin.tick", step=1) is bundle.annotate("y")
        with bundle.loop():
            bundle.boundary()
    finally:
        bundle.finish()


def test_full_mode_profiles_the_whole_run(tmp_path):
    t = port.Trials(device="cpu")
    port.fmin(lambda d: d["x"] ** 2, {"x": port.hp.uniform("x", -1, 1)}, max_evals=3,
              trials=t, rstate=0, show_progressbar=False,
              profile="full:" + str(tmp_path / "whole"))
    assert t.obs_profiler is None
    assert (tmp_path / "whole" / "device.trace.json.gz").stat().st_size > 0


# ---------------------------------------------------------------------------
# device memory and the scrape server
# ---------------------------------------------------------------------------


def test_devmem_census_and_sampler(tmp_path):
    assert devmem.memory_stats() == [{"device": "cpu", "platform": "cpu", "bytes_in_use": None,
                                      "peak_bytes_in_use": None, "bytes_limit": None}]
    held = torch.zeros(1000)
    devmem.register_owner("history", held, held[:10])
    census = devmem.live_array_census()
    assert census["history"]["bytes"] >= 4000  # a shared storage counts once
    entries = [{"bytes_in_use": 5, "peak_bytes_in_use": 9, "bytes_limit": 20},
               {"bytes_in_use": None}]
    assert devmem.roll_up(entries) == ref_devmem.roll_up(entries)
    bundle = obs.RunObs(obs.ObsConfig(level="trace", jsonl_path=str(tmp_path / "m.jsonl"),
                                      devmem_period=0.0), run_id="dm")
    try:
        rec = bundle.devmem.sample()
        assert rec["census"]["history"]["bytes"] >= 4000
        assert bundle.metrics.gauge("devmem.history_bytes").value >= 4000
    finally:
        bundle.finish()
    del held


def test_scrape_server_metrics_snapshot_and_events(runs, tmp_path):
    bundle = obs.RunObs(obs.ObsConfig(level="trace", jsonl_path=str(tmp_path / "s.jsonl"),
                                      http_port=0, devmem_period=0.0), run_id="scrape")
    try:
        bundle.counter("trials.completed").inc(3)
        bundle.gauge("best_loss").set(0.5)
        bundle.devmem.sample()
        health.record_program_cost("suggest.tpe", 10, 4)
        with urllib.request.urlopen(bundle.http.url + "/metrics", timeout=30) as r:
            text = r.read().decode()
        assert 'hyperopt_tpu_trials_completed_total{namespace="scrape"} 3.0' in text
        with urllib.request.urlopen(bundle.http.url + "/snapshot", timeout=30) as r:
            snap = json.loads(r.read().decode())
        assert snap["best_loss"] == 0.5 and snap["trials_completed"] == 3
        assert "suggest.tpe" in snap["sections"]["roofline"] and "devmem" in snap
    finally:
        bundle.finish()
    hub = serve.Broadcast()
    sub = hub.subscribe(maxlen=2)
    for i in range(5):
        hub.publish({"i": i})
    recs, dropped = hub.drain(sub, timeout=0.1)
    assert [r["i"] for r in recs] == [3, 4] and dropped == 3
    hub.unsubscribe(sub)
    assert hub.n_subscribers == 0


# ---------------------------------------------------------------------------
# trajectory and quality records
# ---------------------------------------------------------------------------


def test_trajectory_store_and_gate_decisions_equal_the_reference(tmp_path):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import bench_gate

    path = str(tmp_path / "traj.jsonl")
    for i, v in enumerate((100.0, 104.0, 98.0, 101.0, 60.0)):
        rec = trajectory.record_from_headline({"value": v}, config={"i": i},
                                              keys_override={"ask_p50_ms": 10.0 + i})
        assert rec["backend"] == "cpu"
        trajectory.append(rec, path)
    got, want = trajectory.load(path), ref_trajectory.load(path)
    assert got == want and len(got) == 5
    assert trajectory.KEY_DIRECTIONS == ref_trajectory.KEY_DIRECTIONS
    decision = bench_gate.windowed_compare(got[:-1], got[-1], trajectory.KEY_DIRECTIONS)
    assert decision == bench_gate.windowed_compare(want[:-1], want[-1],
                                                   ref_trajectory.KEY_DIRECTIONS)
    assert decision[0]  # the drop to 60 is a regression
    assert ref_report.render_trend(got) == report.render_trend(got)
