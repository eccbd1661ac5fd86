"""The port's host-only peripherals against the JAX package's: the
``obs.top`` dashboard renders the same frame, byte for byte, from the same
snapshots and streams (a sweep's, a dead source's, the port server's with
its planes and the prober armed), and ``plotting``'s three figures plot the
same data from one ``Trials`` history."""

import io
import itertools
import time
from contextlib import redirect_stdout

import numpy as np
import pytest

from hyperopt_tpu import plotting as ref_plotting
from hyperopt_tpu.obs import top as ref_top
from hyperopt_tpu_torch import Trials, fmin, hp, plotting, rand
from hyperopt_tpu_torch.obs import top
from hyperopt_tpu_torch.obs.prober import _LocalTransport
from hyperopt_tpu_torch.service.scheduler import StudyScheduler
from hyperopt_tpu_torch.service.server import ServiceHTTPServer

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

SPACE = {"x": hp.uniform("x", -5, 5), "y": hp.loguniform("y", -3, 1)}
SPACE_SPEC = {"x": {"dist": "uniform", "args": [-5, 5]}}

SWEEP = {
    "run_id": "r", "best_loss": 0.125, "trials_completed": 42,
    "sections": {
        "report": {"suggest": {"sec": 1.0, "count": 42, "frac": 1.0}},
        "health": {"asks": 5, "last_ei_p50": 0.4, "last_dup_rate": 0.1},
        "utilization": {},
        "ask_pipeline": {"calls": 42, "speculative": 0, "inflight": 2.0,
                         "blocked_sec": {"count": 42, "p50": 0.003}},
    },
    "last_heartbeats": {"fmin.tick": {"age_sec": 0.5, "ts": 1.0}},
    "inflight_trials": [{"tid": 41, "state": "claimed", "age_sec": 0.2}],
    "devmem": {"devices": [{"bytes_in_use": 1 << 30, "bytes_limit": 2 << 30}]},
}


@pytest.fixture
def clock(monkeypatch):
    """A deterministic ``time.time`` and ``time.monotonic`` both packages
    read; ``reset()`` starts them over, so each package's frames see the
    same instants."""
    state = {}

    def reset():
        state["wall"], state["mono"] = itertools.count(), itertools.count()

    reset()
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0 + 0.5 * next(state["wall"]))
    monkeypatch.setattr(time, "monotonic", lambda: 1000.0 + 0.25 * next(state["mono"]))
    return reset


def _frames(mod, refreshes, clock):
    clock()
    histories = {}
    return [mod.render_frame(sources, histories, now=1_700_000_000.0 + i)
            for i, sources in enumerate(refreshes)]


def test_sweep_and_dead_sources_render_the_reference_frames(clock):
    later = dict(SWEEP, trials_completed=50,
                 sections=dict(SWEEP["sections"],
                               health={"asks": 6, "last_ei_p50": 0.6, "last_dup_rate": 0.2}))
    refreshes = [[("p0", SWEEP), ("p1", {"error": "URLError: refused"})], [("p0", later)]]
    got, want = _frames(top, refreshes, clock), _frames(ref_top, refreshes, clock)
    assert got == want
    assert "best 0.125" in got[0] and "DEAD" in got[0] and "EI p50" in got[1]


def test_service_snapshot_renders_the_reference_frame(clock):
    """The port server's ``/snapshot`` (quality, load and tenant planes,
    the SLO plane, a prober that ran a cycle) renders as the reference
    renders it."""
    sched = StudyScheduler(wal=False, device="cpu")
    srv = ServiceHTTPServer(0, scheduler=sched, slo=True, trace=True)
    try:
        sid = srv.handle("POST", "/study", {"space": SPACE_SPEC, "seed": 2,
                                            "n_startup_jobs": 1},
                         headers={"x-tenant": "team-a"})[1]["study_id"]
        for _ in range(3):
            code, a = srv.handle("POST", "/ask", {"study_id": sid})
            srv.handle("POST", "/tell", {"study_id": sid, "tid": a["trials"][0]["tid"],
                                         "loss": 0.5})
        assert srv.start()
        p = srv.arm_prober(period=30.0)
        p.stop()
        p._transport_factory = lambda url: _LocalTransport(srv)
        assert p.run_cycle()["verdict"] == "ok"
        snap = srv.snapshot_dict()
        assert snap["probes"]["cycles"] >= 1
        refreshes = [[("svc", snap)], [("svc", snap), ("gone", {"error": "refused"})]]
        got, want = _frames(top, refreshes, clock), _frames(ref_top, refreshes, clock)
    finally:
        srv.stop()
    assert got == want
    assert "SERVICE" in got[0] and sid[:24] in got[0] and "DEAD" in got[1]


def test_streams_render_the_reference_frames(tmp_path, clock):
    """A stream the port's ``fmin`` wrote: the snapshot both packages
    rebuild from it, the frame, and ``--once`` over the file and its
    directory."""
    path = str(tmp_path / "run.jsonl")
    fmin(lambda d: (d["x"] - 1.0) ** 2 + d["y"], SPACE, algo=rand.suggest, max_evals=8,
         trials=Trials(device="cpu"), rstate=np.random.default_rng(0),
         show_progressbar=False, obs=path)
    snap = top.snapshot_from_stream(path)
    assert snap == ref_top.snapshot_from_stream(path)
    assert snap["trials_completed"] == 8
    refreshes = [[("run.jsonl", snap)]]
    assert _frames(top, refreshes, clock) == _frames(ref_top, refreshes, clock)
    for arg in (path, str(tmp_path)):
        texts = []
        for main in (top.main, ref_top.main):
            clock()
            buf = io.StringIO()
            with redirect_stdout(buf):
                assert main(["--once", arg]) == 0
            texts.append(buf.getvalue())
        assert texts[0] == texts[1] and "run.jsonl" in texts[0]


def test_mid_run_records_give_the_reference_snapshot():
    records = [
        {"kind": "span", "name": "suggest", "ts": 1.0, "wall_sec": 0.1},
        {"kind": "trial_event", "event": "trial_new", "tid": 0, "ts": 1.0},
        {"kind": "trial_event", "event": "trial_finished", "tid": 0, "ts": 1.2},
        {"kind": "trial_event", "event": "trial_finished", "tid": 1, "ts": 1.4},
        {"kind": "health", "algo": "tpe", "ts": 1.3, "ei_p50": 0.7, "dup_rate": 0.05},
    ]
    snap = top.snapshot_from_records(records)
    assert snap == ref_top.snapshot_from_records(records)
    assert snap["trials_completed"] == 2 and snap["sections"]["health"]["asks"] == 1


@pytest.fixture(scope="module")
def history():
    """One port ``Trials`` history: 30 random-search trials, a few failed."""
    t = Trials(device="cpu")

    def objective(d):
        if d["x"] > 4.0:
            return {"status": "fail"}
        return {"loss": (d["x"] - 1.0) ** 2 + d["y"], "status": "ok"}

    fmin(objective, SPACE, algo=rand.suggest, max_evals=30, trials=t,
         rstate=np.random.default_rng(4), show_progressbar=False)
    return t


def _close(*figs):
    import matplotlib.pyplot as plt

    for f in figs:
        plt.close(f)


def test_plot_history_plots_the_reference_data(history):
    got = plotting.main_plot_history(history)
    want = ref_plotting.main_plot_history(history)
    try:
        (ga,), (wa,) = got.axes, want.axes
        np.testing.assert_array_equal(ga.collections[0].get_offsets(),
                                      wa.collections[0].get_offsets())
        np.testing.assert_array_equal(ga.lines[0].get_xydata(), wa.lines[0].get_xydata())
        assert len(ga.collections[0].get_offsets()) == sum(
            r.get("status") == "ok" for r in history.results)
        best = ga.lines[0].get_xydata()[:, 1]
        assert np.all(np.diff(best) <= 0)
    finally:
        _close(got, want)


def test_plot_histogram_counts_equal_the_reference(history):
    got = plotting.main_plot_histogram(history)
    want = ref_plotting.main_plot_histogram(history)
    try:
        counts = [[p.get_height() for p in f.axes[0].patches] for f in (got, want)]
        edges = [[p.get_x() for p in f.axes[0].patches] for f in (got, want)]
        assert counts[0] == counts[1] and edges[0] == edges[1]
        assert sum(counts[0]) == sum(r.get("status") == "ok" for r in history.results)
    finally:
        _close(got, want)


def test_plot_vars_plots_the_reference_data(history):
    got = plotting.main_plot_vars(history, columns=2)
    want = ref_plotting.main_plot_vars(history, columns=2)
    try:
        assert len(got.axes) == len(want.axes)
        for ga, wa in zip(got.axes, want.axes):
            assert ga.get_title() == wa.get_title()
            if ga.collections:
                np.testing.assert_array_equal(ga.collections[0].get_offsets(),
                                              wa.collections[0].get_offsets())
                np.testing.assert_array_equal(ga.collections[0].get_array(),
                                              wa.collections[0].get_array())
        assert {a.get_title() for a in got.axes if a.collections} - {""} == {"x", "y"}
    finally:
        _close(got, want)


def test_plots_tolerate_empty_trials():
    t = Trials(device="cpu")
    figs = [plotting.main_plot_history(t), plotting.main_plot_histogram(t),
            plotting.main_plot_vars(t)]
    try:
        assert all(f is not None for f in figs)
    finally:
        _close(*figs)
