"""The evaluation backends against the JAX package's: a file store either
package writes reads in the other, claims are single under contention, a
``python -m hyperopt_tpu_torch.worker`` process serves a store, ``fmin``
over ``FileTrials`` and over ``ExecutorTrials`` gives the reference's trial
stream, the retry policy and the chaos grammar are the reference's, and
an expired ``timeout`` cancels what is still in flight.

The port's flight recorder and watchdog are process-global, as the
reference's are: each test here swaps in disarmed ones, so no signal
handler, hook or thread outlives it into another test of the process."""

import errno
import functools
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import hyperopt_tpu as ref
from hyperopt_tpu import chaos as ref_chaos, filestore as ref_filestore
from hyperopt_tpu import retry as ref_retry, zoo as ref_zoo
from hyperopt_tpu._env import forced_cpu_env
from hyperopt_tpu.parallel import executor as ref_executor
import hyperopt_tpu_torch as port
from hyperopt_tpu_torch import chaos, filestore, retry, worker, zoo
from hyperopt_tpu_torch.base import (JOB_STATE_CANCEL, JOB_STATE_DONE, JOB_STATE_ERROR,
                                     JOB_STATE_NEW, JOB_STATE_RUNNING, coarse_utcnow)
from hyperopt_tpu_torch.obs import flight as port_flight, watchdog as port_watchdog
from hyperopt_tpu_torch.obs.events import TRIAL_CLAIMED
from hyperopt_tpu_torch.parallel import ExecutorTrials

RTOL, ATOL = 1e-5, 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _disarmed_port_globals(monkeypatch):
    fr = port_flight.FlightRecorder()
    fr.enabled = False
    monkeypatch.setattr(port_flight, "_global", fr)
    monkeypatch.setattr(port_watchdog, "_global", port_watchdog._DISABLED)
    monkeypatch.setattr(chaos, "_plan", None)
    monkeypatch.delenv("HYPEROPT_TPU_CHAOS", raising=False)
    monkeypatch.delenv("HYPEROPT_TPU_TRIAL_RETRIES", raising=False)


def _doc(tid, state, x):
    now = coarse_utcnow()
    doc = {"state": state, "tid": tid, "spec": None,
           "result": {"status": "new"},
           "misc": {"tid": tid, "cmd": ("domain_attachment", "FMinIter_Domain"),
                    "idxs": {"x": [tid]}, "vals": {"x": [x]}},
           "exp_key": None, "owner": None, "version": 0,
           "book_time": None, "refresh_time": None}
    if state != JOB_STATE_NEW:
        doc.update(owner="host:1", book_time=now, refresh_time=now)
    if state == JOB_STATE_DONE:
        doc["result"] = {"status": "ok", "loss": float(x) ** 2}
    if state == JOB_STATE_ERROR:
        doc["misc"]["error"] = ("<class 'ValueError'>", "boom")
    return doc


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_store_written_by_one_package_reads_in_the_other(tmp_path, writer):
    w_mod, r_mod = (filestore, ref_filestore) if writer == "port" else (ref_filestore, filestore)
    store = w_mod.FileStore(tmp_path)
    assert store.new_trial_ids(3) == [0, 1, 2]
    assert store.new_trial_ids(2) == [3, 4]
    states = [JOB_STATE_NEW, JOB_STATE_RUNNING, JOB_STATE_DONE, JOB_STATE_ERROR]
    docs = [_doc(tid, s, 0.5 + tid) for tid, s in enumerate(states)]
    for d in docs:
        store.write_doc(d)
    for sub in ("new", "running", "done", "error"):
        assert os.listdir(tmp_path / sub) == [f"{states.index(_STATE[sub])}.pkl"]
    other = r_mod.FileStore(tmp_path)
    assert other.new_trial_ids(1) == [5]  # the counter reads on
    assert other.load_all() == docs
    for s in states:
        assert other.count(s) == 1
    # the trials view of each package over the same directory
    rt = ref_filestore.FileTrials(tmp_path)
    pt = filestore.FileTrials(tmp_path, device="cpu")
    assert [d["tid"] for d in pt.trials] == [d["tid"] for d in rt.trials] == [0, 1, 2]
    assert pt._dynamic_trials == rt._dynamic_trials
    assert other.read_events() == store.read_events()  # one durable event log


_STATE = {"new": JOB_STATE_NEW, "running": JOB_STATE_RUNNING, "done": JOB_STATE_DONE,
          "error": JOB_STATE_ERROR}


def test_threaded_reserve_claims_each_trial_once(tmp_path):
    store = filestore.FileStore(tmp_path)
    n = 48
    for tid in store.new_trial_ids(n):
        store.write_doc(_doc(tid, JOB_STATE_NEW, 0.1 * tid))
    claimed = {}
    lock = threading.Lock()

    def worker(owner):
        s = filestore.FileStore(tmp_path)
        while True:
            doc = s.reserve(owner)
            if doc is None:
                return
            with lock:
                claimed.setdefault(doc["tid"], []).append(owner)
            s.finish(doc, result={"status": "ok", "loss": 0.0})

    threads = [threading.Thread(target=worker, args=(f"w{i}",)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert sorted(claimed) == list(range(n))
    assert all(len(v) == 1 for v in claimed.values())
    events = [e for e in store.read_events() if e["event"] == TRIAL_CLAIMED]
    assert sorted(e["tid"] for e in events) == list(range(n))
    assert store.count(JOB_STATE_DONE) == n and store.count(JOB_STATE_NEW) == 0


def _worker(pkg, store, device_args=()):
    """A worker process on ``store``: the port's with ``--device cpu``, or
    the reference's pinned to the CPU."""
    env = forced_cpu_env(os.environ)
    env["PYTHONPATH"] = REPO
    args = [sys.executable, "-m", f"{pkg}.worker", "--store", str(store),
            "--poll-interval", "0.02", "--reserve-timeout", "60", *device_args]
    return subprocess.Popen(args, env=env, cwd=REPO, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)


def _stop(proc):
    proc.terminate()
    try:
        proc.wait(30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(30)


def _ref_ml_logreg(d):
    """The reference's ``ml_logreg_cv`` objective behind a module-level
    name: its own function closes over a cached local, which cloudpickle
    cannot carry to the pool."""
    return ref_zoo.ZOO["ml_logreg_cv"].objective(d)


def _rounds(pkg, zoo_mod, trials, name, q, rounds, seed, fn="objective"):
    """``fmin`` in rounds of ``q`` asks, each run to completion before the
    next: the asks see the same finished history whatever the workers'
    timing, so two packages' streams can be compared."""
    dom = zoo_mod.ZOO[name]
    obj = _ref_ml_logreg if (pkg is ref and name == "ml_logreg_cv") else getattr(dom, fn)
    algo = functools.partial(pkg.tpe.suggest, n_startup_jobs=4, n_EI_candidates=32)
    for r in range(rounds):
        pkg.fmin(obj, dom.space, algo=algo, max_evals=q * (r + 1),
                 max_queue_len=q, trials=trials, rstate=np.random.default_rng(seed + r),
                 show_progressbar=False)
    return trials


def _assert_same_docs(rt, pt):
    rdocs = sorted(rt.trials, key=lambda d: d["tid"])
    pdocs = sorted(pt.trials, key=lambda d: d["tid"])
    assert [d["tid"] for d in rdocs] == [d["tid"] for d in pdocs]
    for a, b in zip(rdocs, pdocs):
        va, vb = a["misc"]["vals"], b["misc"]["vals"]
        assert va.keys() == vb.keys()
        for k in va:
            np.testing.assert_allclose(va[k], vb[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"tid {a['tid']} {k}")
        assert a["state"] == b["state"] == JOB_STATE_DONE
        np.testing.assert_allclose(a["result"]["loss"], b["result"]["loss"],
                                   rtol=RTOL, atol=ATOL)


def test_fmin_over_file_trials_matches_reference(tmp_path):
    """Each package's driver and worker process on its own store: the same
    12 trials (4 prior draws, then 4 TPE rounds of 2), every doc done, and
    no trial claimed twice."""
    rdir, pdir = tmp_path / "ref", tmp_path / "port"
    procs = [_worker("hyperopt_tpu", rdir),
             _worker("hyperopt_tpu_torch", pdir, ("--device", "cpu"))]
    try:
        rt = _rounds(ref, ref_zoo, ref_filestore.FileTrials(rdir), "branin", 2, 6, 11)
        pt = _rounds(port, zoo, filestore.FileTrials(pdir, device="cpu"), "branin", 2, 6, 11)
    finally:
        for p in procs:
            _stop(p)
    assert len(pt.trials) == 12
    _assert_same_docs(rt, pt)
    claims = [e["tid"] for e in pt.store.read_events() if e["event"] == TRIAL_CLAIMED]
    assert sorted(claims) == list(range(12))
    assert sorted(os.listdir(pdir / "done")) == sorted(f"{t}.pkl" for t in range(12))
    for sub in ("new", "running", "error", "cancel"):
        assert not os.listdir(pdir / sub)
    # the port's store reads in the reference, every doc done
    assert ref_filestore.FileStore(pdir).count(JOB_STATE_DONE) == 12


@pytest.mark.parametrize("name,traceable", [("branin", False), ("ml_logreg_cv", True)])
def test_fmin_over_executor_trials_matches_reference(name, traceable):
    """A pool of two: per-trial evaluation of a host objective, or (for the
    ML domain) each queue of 4 as one batch evaluation."""
    rt = ref_executor.ExecutorTrials(n_workers=2, traceable=traceable)
    pt = ExecutorTrials(n_workers=2, traceable=traceable, device="cpu")
    try:
        fn = "traceable" if traceable else "objective"
        _rounds(ref, ref_zoo, rt, name, 4, 4, 3)
        _rounds(port, zoo, pt, name, 4, 4, 3, fn=fn)
    finally:
        rt.shutdown()
        pt.shutdown()
    assert len(pt.trials) == 16
    _assert_same_docs(rt, pt)
    if traceable:
        assert pt.metrics.counter("batch_evals").value == 4


def test_worker_process_serves_a_store_on_the_cpu(tmp_path):
    """One worker, ``--device cpu``, serving ``FileTrials.fmin``: it
    evaluates the ML objective given host numbers on the device it was
    told, and records the attempts; the default device is the card."""
    ft = filestore.FileTrials(tmp_path, device="cpu")
    dom = zoo.ZOO["ml_logreg_cv"]
    proc = _worker("hyperopt_tpu_torch", tmp_path, ("--device", "cpu"))
    try:
        ft.fmin(dom.objective, dom.space, algo=port.rand.suggest, max_evals=3,
                max_queue_len=3, rstate=0, show_progressbar=False)
    finally:
        _stop(proc)
    assert [d["state"] for d in ft.trials] == [JOB_STATE_DONE] * 3
    assert all(d["misc"]["attempts"] == 1 for d in ft.trials)
    assert all(0.0 < d["result"]["loss"] <= 50.0 for d in ft.trials)
    assert all(d["owner"].endswith(f":{proc.pid}") for d in ft.trials)
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            worker.FileWorker(tmp_path)


_RELEASE = threading.Event()


def _hang(d):
    """An objective that hangs until the test releases it."""
    _RELEASE.wait(30)
    return 0.0


def test_async_fmin_refuses_lookahead_and_cancels_on_timeout(tmp_path):
    dom = zoo.ZOO["quadratic1"]
    ft = filestore.FileTrials(tmp_path, device="cpu")
    with pytest.raises(ValueError, match="lookahead"):
        port.fmin(dom.objective, dom.space, max_evals=2, trials=ft, lookahead=1,
                  show_progressbar=False)
    # no worker serves the store: the timeout expires and the driver
    # cancels what it queued instead of waiting on it
    t0 = time.monotonic()
    port.fmin(dom.objective, dom.space, algo=port.rand.suggest, max_evals=4, max_queue_len=2,
              trials=ft, timeout=0.3, rstate=0, show_progressbar=False, return_argmin=False)
    assert time.monotonic() - t0 < 10
    assert ft.store.count(JOB_STATE_CANCEL) == 2
    assert ref_filestore.FileStore(tmp_path).count(JOB_STATE_CANCEL) == 2
    # an executor whose objective hangs past the fmin timeout
    _RELEASE.clear()
    et = ExecutorTrials(n_workers=1, device="cpu")
    try:
        port.fmin(_hang, dom.space, algo=port.rand.suggest, max_evals=2, max_queue_len=1,
                  trials=et, timeout=0.3, rstate=0, show_progressbar=False,
                  return_argmin=False)
        states = [d["state"] for d in et._dynamic_trials]
        assert states and all(s == JOB_STATE_CANCEL for s in states)
        assert et.metrics.counter("trials.cancelled").value == len(states)
    finally:
        _RELEASE.set()
        et.shutdown()


def test_retry_policy_matches_reference():
    for kw in ({}, {"max_retries": 3, "base_delay": 0.1, "max_delay": 1.0, "jitter": 0.3},
               {"max_retries": 2, "jitter": 0.0}):
        rp, pp = ref_retry.RetryPolicy(**kw), retry.RetryPolicy(**kw)
        for attempt in range(6):
            for key in (0, "w:7", 12):
                assert pp.delay(attempt, key=key) == rp.delay(attempt, key=key)
                assert pp.delay_after(attempt, key, 0.7) == rp.delay_after(attempt, key, 0.7)
            assert pp.retries_left(attempt) == rp.retries_left(attempt)
    for raw in ("", "3", "2:0.25", "-1", "x", "2:0", " 4 "):
        env = {"HYPEROPT_TPU_TRIAL_RETRIES": raw}
        assert (retry.RetryPolicy.from_env(env).__dict__
                == ref_retry.RetryPolicy.from_env(env).__dict__), raw
    assert retry.RetryPolicy.coerce(2) == retry.RetryPolicy(max_retries=2)
    with pytest.raises(TypeError):
        retry.RetryPolicy.coerce("2")


def test_executor_retries_a_flaky_objective_under_the_env_policy(monkeypatch):
    """``HYPEROPT_TPU_TRIAL_RETRIES`` is honoured: the worker CLI's default
    policy, and the policy a backend is given."""
    monkeypatch.setenv("HYPEROPT_TPU_TRIAL_RETRIES", "2:0.001")
    policy = retry.RetryPolicy.from_env()
    assert policy == retry.RetryPolicy(max_retries=2, base_delay=0.001)
    calls = []

    def flaky(d):
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("transient")
        return d["x"]

    et = ExecutorTrials(n_workers=1, retry=policy, device="cpu")
    try:
        port.fmin(flaky, {"x": port.hp.uniform("x", 0, 1)}, algo=port.rand.suggest,
                  max_evals=1, trials=et, rstate=0, show_progressbar=False)
    finally:
        et.shutdown()
    doc = et.trials[0]
    assert doc["state"] == JOB_STATE_DONE and doc["misc"]["attempts"] == 3
    assert et.metrics.counter("trials.retries").value == 2


@pytest.mark.parametrize("spec", [
    "7:kill@trial:3", "1:ioerr@io:0.25;stall@trial:0.5:0.01", "3:enospc@io:0.1",
    "9:term@gen:2;corrupt@wal:0.3", "", "off", "x:kill@a:1", "1:", "1:boom@a:1",
    "1:kill@a", "1:stall@a:0.5"])
def test_chaos_grammar_and_schedule_match_reference(spec):
    rp, pp = ref_chaos.parse_spec(spec), chaos.parse_spec(spec)
    assert (rp is None) == (pp is None)
    if rp is None:
        return
    assert pp.seed == rp.seed
    fields = ("action", "site", "count", "prob", "sec", "text")
    assert ([tuple(getattr(r, f) for f in fields) for r in pp.rules]
            == [tuple(getattr(r, f) for f in fields) for r in rp.rules])
    for site in sorted({r.site for r in rp.rules}):
        for _ in range(40):
            assert pp.check(site, io=True) == rp.check(site, io=True)


def test_chaos_io_fault_reaches_the_store_write(tmp_path):
    chaos.configure("3:ioerr@io:1.0")
    with pytest.raises(OSError, match="chaos"):
        filestore.FileStore(tmp_path)
    chaos.configure("3:enospc@io:1.0")
    with pytest.raises(OSError) as err:
        filestore._atomic_write(str(tmp_path / "x"), b"1")
    assert err.value.errno == errno.ENOSPC
    chaos.configure(None)
    filestore.FileStore(tmp_path).new_trial_ids(1)
