"""The port's ``fmin`` against the JAX package's: with the same ``rstate``,
40 evaluations (20 prior draws, then 20 TPE asks) give the same trial
stream on quadratic1, branin and the conditional q1_choice, and the loop's
options behave as the reference's do."""

import functools
import pickle

import numpy as np
import pytest
import torch

import hyperopt_tpu as ref
from hyperopt_tpu import zoo as ref_zoo
import hyperopt_tpu_torch as port
from hyperopt_tpu_torch import convert, early_stop, zoo
from hyperopt_tpu_torch.base import Domain, PaddedHistory

RTOL, ATOL = 1e-5, 1e-6


def _run(pkg, zoo_mod, name, n, seed, **kw):
    trials = pkg.Trials(device="cpu") if pkg is port else pkg.Trials()
    dom = zoo_mod.ZOO[name]
    pkg.fmin(dom.objective, dom.space, algo=kw.pop("algo", pkg.tpe.suggest), max_evals=n,
             trials=trials, rstate=np.random.default_rng(seed), show_progressbar=False, **kw)
    return trials


def _assert_same_stream(rt, pt):
    assert len(rt.trials) == len(pt.trials)
    for a, b in zip(rt.trials, pt.trials):
        assert a["tid"] == b["tid"]
        va, vb = a["misc"]["vals"], b["misc"]["vals"]
        assert va.keys() == vb.keys()
        for k in va:
            assert len(va[k]) == len(vb[k]), (a["tid"], k)
            np.testing.assert_allclose(va[k], vb[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"tid {a['tid']} {k}")
        assert a["result"]["status"] == b["result"]["status"]
        np.testing.assert_allclose(a["result"]["loss"], b["result"]["loss"],
                                   rtol=RTOL, atol=ATOL, err_msg=f"tid {a['tid']} loss")


@pytest.mark.parametrize("name", ["quadratic1", "branin", "q1_choice"])
def test_tpe_trial_stream_matches_reference(name):
    rt = _run(ref, ref_zoo, name, 40, seed=0)
    pt = _run(port, zoo, name, 40, seed=0)
    _assert_same_stream(rt, pt)
    assert pt.argmin.keys() == rt.argmin.keys()


def test_tuned_tpe_with_queue_and_lookahead_matches_reference():
    algo = {p: functools.partial(p.tpe.suggest, n_startup_jobs=5, n_EI_candidates=64,
                                 gamma=0.3) for p in (ref, port)}
    kw = dict(max_queue_len=2, lookahead=1)
    rt = _run(ref, ref_zoo, "branin", 24, seed=3, algo=algo[ref], **kw)
    pt = _run(port, zoo, "branin", 24, seed=3, algo=algo[port], **kw)
    _assert_same_stream(rt, pt)


def test_rand_points_to_evaluate_and_early_stop_match_reference():
    points = [{"x": 0.5}, {"x": 2.9}]
    out = []
    for pkg, zmod in ((ref, ref_zoo), (port, zoo)):
        dom = zmod.ZOO["quadratic1"]
        extra = {"device": "cpu"} if pkg is port else {}
        trials = (pkg.generate_trials_to_calculate(points, **extra))
        stop = (pkg.early_stop.no_progress_loss(5) if pkg is ref
                else early_stop.no_progress_loss(5))
        best = pkg.fmin(dom.objective, dom.space, algo=pkg.rand.suggest, max_evals=30,
                        trials=trials, rstate=np.random.default_rng(1),
                        show_progressbar=False, early_stop_fn=stop)
        out.append((trials, best))
    (rt, rbest), (pt, pbest) = out
    _assert_same_stream(rt, pt)
    assert len(pt.trials) < 30  # the early stop fired
    np.testing.assert_allclose(rbest["x"], pbest["x"], rtol=RTOL)


def test_loss_threshold_and_checkpoint_resume(tmp_path):
    dom = zoo.ZOO["quadratic1"]
    path = str(tmp_path / "trials.pkl")
    port.fmin(dom.objective, dom.space, max_evals=30, rstate=np.random.default_rng(0),
              show_progressbar=False, trials_save_file=path, device="cpu",
              loss_threshold=-1.0)
    with open(path, "rb") as f:
        saved = pickle.load(f)
    assert len(saved.trials) == 30 and saved.device.type == "cpu"
    port.fmin(dom.objective, dom.space, max_evals=35, rstate=np.random.default_rng(1),
              show_progressbar=False, trials_save_file=path)
    with open(path, "rb") as f:
        assert len(pickle.load(f).trials) == 35
    t = port.Trials(device="cpu")
    port.fmin(dom.objective, dom.space, max_evals=200, trials=t, loss_threshold=0.5,
              rstate=np.random.default_rng(0), show_progressbar=False)
    assert len(t.trials) < 200 and min(t.losses()) <= 0.5


def test_unported_options_raise(tmp_path):
    """The run-plane options once refused here are ported: ``obs`` streams
    JSONL, ``obs_http`` serves, ``profile`` arms the capture plane and
    ``compile_cache`` names the kernel build directory.  A run the device
    loop cannot take still raises."""
    from hyperopt_tpu_torch import _build

    dom = zoo.ZOO["quadratic1"]
    t = port.Trials(device="cpu")
    try:
        port.fmin(dom.objective, dom.space, max_evals=2, device="cpu", trials=t,
                  show_progressbar=False, obs=str(tmp_path / "run.jsonl"), obs_http=0,
                  profile=str(tmp_path / "prof"), compile_cache=str(tmp_path / "cc"))
        assert _build.build_dir() == (tmp_path / "cc").resolve()
    finally:
        _build.set_build_dir(None)
    assert (tmp_path / "run.jsonl").stat().st_size > 0
    assert t.obs_http_url.startswith("http://127.0.0.1:")
    assert t.obs_profiler is not None and t.obs_health is not None
    # device_loop is ported: a run it cannot take raises with the reasons
    with pytest.raises(ValueError, match="ineligible"):
        port.fmin(dom.objective, dom.space, max_evals=2, device="cpu",
                  show_progressbar=False, device_loop=True, max_queue_len=2)


def test_reference_trials_continue_in_the_port():
    """A study run by the JAX package, carried over as trial docs, gets the
    same next TPE proposals from the port."""
    rt = _run(ref, ref_zoo, "q1_choice", 30, seed=4)
    pt = convert.trials_from_reference_docs(rt.trials, device="cpu")
    assert pt.device.type == "cpu" and len(pt.trials) == 30
    rdom = ref.base.Domain(ref_zoo.ZOO["q1_choice"].objective, ref_zoo.ZOO["q1_choice"].space)
    pdom = Domain(zoo.ZOO["q1_choice"].objective, zoo.ZOO["q1_choice"].space)
    rdocs = ref.tpe.suggest([30, 31, 32], rdom, rt, 1234)
    pdocs = port.tpe.suggest([30, 31, 32], pdom, pt, 1234)
    for a, b in zip(rdocs, pdocs):
        assert a["misc"]["idxs"] == b["misc"]["idxs"]
        for k, v in a["misc"]["vals"].items():
            np.testing.assert_allclose(v, b["misc"]["vals"][k], rtol=RTOL, atol=ATOL)


def test_quantized_history_storage_is_not_ported(monkeypatch):
    """Quantized history is ported now: under ``HYPEROPT_TPU_HIST_DTYPE=int8``
    the port's history stores int8 codes and its branin stream follows the
    reference's."""
    monkeypatch.setenv("HYPEROPT_TPU_HIST_DTYPE", "int8")
    assert PaddedHistory(("x",), device="cpu").hist_dtype == "int8"
    rt = _run(ref, ref_zoo, "branin", 30, seed=2)
    pt = _run(port, zoo, "branin", 30, seed=2)
    _assert_same_stream(rt, pt)
    ph = pt.history_object(("x", "y"))
    assert ph.qparams is not None and ph.device_view()["vals"]["x"].dtype == torch.int8


@pytest.mark.parametrize("name", ["bf16", "fp8"])
def test_compressed_history_streams_match_reference(name, monkeypatch):
    monkeypatch.setenv("HYPEROPT_TPU_HIST_DTYPE", name)
    rt = _run(ref, ref_zoo, "q1_choice", 30, seed=5)
    pt = _run(port, zoo, "q1_choice", 30, seed=5)
    _assert_same_stream(rt, pt)

