"""Overload control and the degrade ladder against the JAX package's:
``Deadline``, ``AdmissionGuard`` and ``DegradeLadder`` decide as the
reference does under a fake clock; a scheduler under seeded tick faults
serves the reference's (tid, algo, degraded) stream; and only the faults
of the card's pressure are absorbed by the ladder, never a kernel that
does not build, launch or keep the CUDA context alive."""

import random

import numpy as np
import pytest
import torch

from hyperopt_tpu import chaos as ref_chaos
from hyperopt_tpu import hp as ref_hp
from hyperopt_tpu.service import StudyScheduler as RefScheduler
from hyperopt_tpu.service import overload as ref_overload
from hyperopt_tpu_torch import chaos, hp
from hyperopt_tpu_torch.service import StudyScheduler, overload
from hyperopt_tpu_torch.service import scheduler as sched_mod


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def _guard_script(mod):
    """One admission script run on a package's overload module: every
    admit's outcome (admitted, or the shed's type and Retry-After)."""
    clk = FakeClock()
    g = mod.AdmissionGuard(max_queue=3, clock=clk)
    log = []

    def attempt(fn, *a):
        try:
            return fn(*a)
        except mod.OverloadError as e:
            log.append((type(e).__name__, round(e.retry_after, 9)))
            return None

    tokens = [attempt(g.admit_ask) for _ in range(4)]  # the 4th sheds (cold floor)
    for sec in (0.3, 0.5, 0.1, 0.9):
        g.observe_wave(sec)
    log.append(("ewma", round(g.wave_ewma(), 9)))
    attempt(g.admit_ask)  # sheds with the measured hint
    g.release(tokens[0])
    tokens[0] = attempt(g.admit_ask, mod.Deadline(50.0, clock=clk))  # unservable deadline
    tokens[0] = attempt(g.admit_ask, mod.Deadline(5000.0, clock=clk))
    tells = [attempt(g.admit_tell) for _ in range(3 * g.TELL_SLACK + 1)]  # tells shed at 4x
    log.append(("tells admitted", sum(t is not None for t in tells)))
    g.set_store_full(True, reason="disk", retry_after=0.5)
    g.release(tokens[1])
    attempt(g.admit_ask)  # 507-shaped shed
    clk.t += 1.5  # the latch window (2 x retry_after) ends: one probe passes
    tokens[1] = attempt(g.admit_ask)
    log.append(("admitted after the latch", tokens[1] is not None))
    for t in tokens + tells:
        if t is not None:
            g.release(t)
    return log


def test_admission_guard_decides_as_the_reference():
    got, want = _guard_script(overload), _guard_script(ref_overload)
    assert got == want
    assert ("StoreFullShed", 0.5) in got and got.count(("OverloadError", 0.05)) == 1


@pytest.mark.parametrize("header,default", [(None, 30000.0), ("250", 30000.0), ("9e9", 1000.0),
                                            ("bogus", 500.0), ("-3", None), (None, None)])
def test_deadline_from_request_matches_the_reference(header, default):
    clk = FakeClock()
    a = overload.Deadline.from_request(header, default, clock=clk)
    b = ref_overload.Deadline.from_request(header, default, clock=clk)
    assert a.remaining() == b.remaining()
    clk.t += 0.4
    assert (a.expired(), a.remaining()) == (b.expired(), b.remaining())


@pytest.mark.parametrize("seed", range(3))
def test_degrade_ladder_walks_as_the_reference(seed):
    rng = random.Random(seed)
    a, b = overload.DegradeLadder(recover_after=3), ref_overload.DegradeLadder(recover_after=3)
    for _ in range(200):
        fault = rng.random() < 0.2
        la = a.record_fault() if fault else a.record_clean_wave()
        lb = b.record_fault() if fault else b.record_clean_wave()
        assert la == lb and a.spec() == b.spec()
    assert a.transitions == b.transitions and a.status() == b.status()
    assert overload.LADDER_LEVELS == ref_overload.LADDER_LEVELS


def _chaos_stream(pkg_sched, pkg_hp, pkg_chaos, **kw):
    """Four studies over two spaces under seeded ``ioerr@tick``: the
    (study, tid, algo, degraded, params) of every answer."""
    spaces = [{"x": pkg_hp.uniform("x", -5, 5)},
              {"x": pkg_hp.uniform("x", -5, 5), "c": pkg_hp.choice("c", [0, 1, 2])}]
    sched = pkg_sched(wal=False, degrade=2, **kw)
    sids = [sched.create_study(spaces[i % 2], seed=20 + i, study_id=f"s{i}", n_startup_jobs=2)
            for i in range(4)]
    pkg_chaos.configure("5:ioerr@tick:0.3")
    out = []
    try:
        for _ in range(14):
            for sid, (a,) in sorted(sched.ask_many([(s, 1) for s in sids]).items()):
                out.append((sid, a["tid"], a.get("algo", "tpe"), bool(a.get("degraded")),
                            a["params"]))
                sched.tell(sid, a["tid"], float(a["params"]["x"]) ** 2)
    finally:
        pkg_chaos.configure(None)
        pkg_chaos.reset()
    return out, sched.degrade.status(), list(sched.degrade.transitions)


def test_tick_faults_serve_the_reference_stream():
    got, got_status, got_moves = _chaos_stream(StudyScheduler, hp, chaos, device="cpu")
    want, want_status, want_moves = _chaos_stream(RefScheduler, ref_hp, ref_chaos)
    assert [g[:4] for g in got] == [w[:4] for w in want]
    assert got_status == want_status and got_moves == want_moves
    assert any(g[3] for g in got) and {g[2] for g in got} == {"tpe", "rand"}
    for g, w in zip(got, want):
        for k in w[4]:
            np.testing.assert_allclose(float(g[4][k]), float(w[4][k]), rtol=1e-5, atol=1e-6)


FAULTS = [
    # absorbed: the card's pressure, injected faults, non-finite proposals
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), True),
    (RuntimeError("CUDA out of memory. Tried to allocate 20 MiB"), True),
    (chaos.InjectedFault("chaos: injected I/O error at tick"), True),
    (overload.NonFiniteProposal("cohort tick read back non-finite proposals"), True),
    # surfaced: kernels that do not build, load or launch, and sticky errors
    (RuntimeError("nvcc failed (1): nvcc -gencode arch=compute_90a,code=sm_90a"), False),
    (OSError("libei_diff_1234.so: cannot open shared object file"), False),
    (ValueError("ei_diff: tables must all be [P=4, m=17], got (4, 16)"), False),
    (ValueError("fused_sample_ei: P=70000 exceeds the kernel's grid (65535)"), False),
    (RuntimeError("ei_diff kernel launch failed: CUDA error 700"), False),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), False),
    (RuntimeError("CUDA error: unspecified launch failure"), False),
    (RuntimeError("RESOURCE_EXHAUSTED: out of memory"), False),  # an XLA message
    (KeyError("label"), False),
]


@pytest.mark.parametrize("i", range(len(FAULTS)))
def test_only_the_cards_pressure_is_a_device_fault(i):
    exc, absorbed = FAULTS[i]
    assert overload.is_device_fault(exc) is absorbed


@pytest.mark.parametrize("fault", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("ei_diff kernel launch failed: CUDA error 719"),
    ValueError("ei_diff: the kernel takes contiguous tensors"),
])
def test_a_kernel_fault_fails_the_ask_instead_of_walking_the_ladder(fault, monkeypatch):
    """No hidden fallback: a kernel's own fault answers as an error (500
    over HTTP), the ladder stays at level 0 and nothing is served from the
    rand floor."""
    from hyperopt_tpu_torch import megakernel, zoo

    sched = StudyScheduler(device="cpu", wal=False)
    assert sched.degrade is not None  # the ladder is on by default
    # the surrogate's numeric labels score in ei_diff (its quantized ones
    # keep it off the fused route)
    sid = sched.create_study(zoo.ZOO["hpob_surrogate"].space, seed=3, n_startup_jobs=2)
    for _ in range(2):
        (a,) = sched.ask(sid)
        sched.tell(sid, a["tid"], 1.0)

    def broken(*a, **k):
        raise fault

    monkeypatch.setattr(megakernel, "ei_diff", broken)
    with pytest.raises(type(fault)):
        sched.ask(sid)
    assert sched.degrade.status()["faults"] == 0 and sched.degrade.level() == 0
    assert sched.study_status(sid)["n_pending"] == 0
    monkeypatch.undo()
    (a,) = sched.ask(sid)  # the stack rebuilt from the host arrays
    assert "degraded" not in a


def test_an_out_of_memory_tick_walks_the_ladder(monkeypatch):
    sched = StudyScheduler(device="cpu", wal=False, degrade=2)
    sid = sched.create_study({"x": hp.uniform("x", -5, 5)}, seed=4, n_startup_jobs=2)
    for _ in range(2):
        (a,) = sched.ask(sid)
        sched.tell(sid, a["tid"], 1.0)

    def oom(self, *a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 4.00 GiB")

    monkeypatch.setattr(sched_mod._Cohort, "tick", oom)
    (a,) = sched.ask(sid)
    assert a["degraded"] and a["algo"] == "rand" and sched.degrade.level() == 3
