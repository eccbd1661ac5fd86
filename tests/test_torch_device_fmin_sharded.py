"""The port's capacity-sharded device loop against the JAX package's, run
live on the CPU.

Under ``HYPEROPT_TPU_SHARD`` with a capacity at or past
``HYPEROPT_TPU_HIST_SHARD_MIN`` the reference compiles its chunk program
with the loop state split along the capacity axis over the 8 CPU devices
``tests/conftest.py`` forces.  The port's runner sees a mesh that names
the CPU 2, 4 or 8 times (``sharding.local_devices`` patched, as
``chip_smoke.py`` names the card several times); every entry lies on its
device, so it keeps the state whole and runs the unsharded loop.  Its
trials equal the reference's sharded trials at the parity standard (keys,
masks and ids exactly; floats at rtol 1e-5, atol 1e-6) and the port's
unsharded trials bit for bit, in float32 and bfloat16 state; a reference
sharded state, gathered by ``np.asarray`` and carried across by
``convert.device_loop_state_from_numpy``, continues as the reference
continues.  A mesh over two cards raises item 12c.
"""

import numpy as np
import pytest
import torch

import hyperopt_tpu as ref
from hyperopt_tpu import device_fmin as ref_device_fmin
from hyperopt_tpu import megakernel as ref_megakernel
from hyperopt_tpu import pallas_ei as ref_pallas_ei
from hyperopt_tpu import zoo as ref_zoo
import hyperopt_tpu_torch as port
from hyperopt_tpu_torch import convert, device_fmin, megakernel, pallas_ei, zoo
from hyperopt_tpu_torch.base import Domain
from hyperopt_tpu_torch.fmin import FMinIter
from hyperopt_tpu_torch.parallel import sharding

from test_torch_device_fmin import CFG, _assert_same_docs, _assert_same_rows

RTOL, ATOL = 1e-5, 1e-6
EVALS = 40


def _shard_env(mp, n=None, shard_min=8, hist_dtype=None):
    """Arm the capacity split (``HYPEROPT_TPU_SHARD=8``, the threshold at
    ``shard_min``) and, for the port, name the CPU ``n`` times as this
    process's devices; ``n=None`` leaves the knob unset (unsharded)."""
    if hist_dtype is not None:
        mp.setenv("HYPEROPT_TPU_HIST_DTYPE", hist_dtype)
    if n is None:
        mp.delenv("HYPEROPT_TPU_SHARD", raising=False)
        return
    mp.setenv("HYPEROPT_TPU_SHARD", "8")
    mp.setenv("HYPEROPT_TPU_HIST_SHARD_MIN", str(shard_min))
    mp.setattr(sharding, "local_devices", lambda device=None: [torch.device("cpu")] * n)


def _stream(trials):
    return [d["misc"]["vals"] for d in trials.trials], trials.losses()


def _fmin(pkg, name, n_evals=EVALS):
    dom = (zoo if pkg is port else ref_zoo).ZOO[name]
    trials = pkg.Trials(device="cpu") if pkg is port else pkg.Trials()
    pkg.fmin(dom.traceable if pkg is port else dom.objective, dom.space,
             algo=pkg.tpe.suggest, max_evals=n_evals, trials=trials,
             rstate=np.random.default_rng(0), show_progressbar=False, device_loop=True)
    return trials


@pytest.fixture(scope="module")
def ref_sharded():
    """The reference's sharded ``fmin(device_loop=True)`` runs, compiled
    once for the module: ``{name: Trials}``."""
    with pytest.MonkeyPatch.context() as mp:
        _shard_env(mp, n=8)
        return {name: _fmin(ref, name) for name in ("branin", "hartmann6")}


@pytest.fixture(scope="module")
def port_unsharded():
    with pytest.MonkeyPatch.context() as mp:
        _shard_env(mp)
        return {name: _fmin(port, name) for name in ("branin", "hartmann6")}


# ---------------------------------------------------------------------------
# fmin(device_loop=True)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("name", ["branin", "hartmann6"])
def test_sharded_fmin_matches_reference_and_unsharded(monkeypatch, ref_sharded,
                                                      port_unsharded, name, n):
    _shard_env(monkeypatch, n=n)
    pt = _fmin(port, name)
    _assert_same_docs(ref_sharded[name], pt)
    assert _stream(pt) == _stream(port_unsharded[name])  # bit for bit


def test_sharded_runs_continue_bitwise_and_a_failed_chunk_drops_the_state(monkeypatch,
                                                                         port_unsharded):
    # the state is opaque to fmin: it carries across run() calls
    _shard_env(monkeypatch, n=4)
    dom = zoo.ZOO["branin"]
    trials = port.Trials(device="cpu")
    it = FMinIter(port.tpe.suggest, Domain(dom.traceable, dom.space), trials,
                  max_evals=EVALS, rstate=np.random.default_rng(0), show_progressbar=False,
                  device_loop=True)
    it.run(10)
    assert it._device_state[2].shape == (EVALS,) and it._device_n_done == 10
    it.run(30)
    assert _stream(trials) == _stream(port_unsharded["branin"])

    # a chunk that fails part way drops the resume handle
    real = device_fmin.DeviceLoopRunner.run_chunk
    calls = []

    def failing(self, state, start, limit, seed):
        calls.append(start)
        if len(calls) == 2:
            raise RuntimeError("injected chunk failure")
        return real(self, state, start, limit, seed)

    monkeypatch.setattr(device_fmin.DeviceLoopRunner, "run_chunk", failing)
    t2 = port.Trials(device="cpu")
    it2 = FMinIter(port.tpe.suggest, Domain(dom.traceable, dom.space), t2, max_evals=EVALS,
                   rstate=np.random.default_rng(0), show_progressbar=False, device_loop=True)
    with pytest.raises(RuntimeError, match="injected"):
        it2.run(EVALS)
    assert it2._device_state is None and it2._device_n_done == 0


# ---------------------------------------------------------------------------
# DeviceLoopRunner chunks
# ---------------------------------------------------------------------------


def _runner(name="branin", n_startup=20, cap=128):
    dom = zoo.ZOO[name]
    return device_fmin.DeviceLoopRunner(Domain(dom.traceable, dom.space), CFG, n_startup, cap,
                                        device="cpu")


def _whole(state):
    """A loop state's leaves as a list of ``[cap]`` tensors."""
    vals, active, losses, has_loss = state
    return [*vals.values(), *active.values(), losses, has_loss]


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("hist_dtype", ["float32", "bf16"])
def test_runner_chunks_equal_the_unsharded_runner(monkeypatch, hist_dtype, n):
    _shard_env(monkeypatch, hist_dtype=hist_dtype)
    plain = _runner()
    _shard_env(monkeypatch, n=n, shard_min=128)
    split = _runner()
    assert sharding.should_shard_history(128, sharding.suggest_mesh(8, device="cpu"))
    ps, ss = plain.init_state(), split.init_state()
    want_dtype = torch.bfloat16 if hist_dtype == "bf16" else torch.float32
    for leaf in (*ss[0].values(), ss[2]):  # kept whole, in the storage type
        assert leaf.shape == (128,) and leaf.dtype == want_dtype
    for start in range(0, 40, 10):  # 20 startup steps, then 20 TPE steps
        ps, p_rows = plain.run_chunk(ps, start, start + 10, seed=start + 1)
        ss, s_rows = split.run_chunk(ss, start, start + 10, seed=start + 1)
        np.testing.assert_array_equal(s_rows, p_rows)
        for a, b in zip(_whole(ss), _whole(ps)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert bool(ss[3][:40].all()) and not bool(ss[3][40:].any())


def test_sharded_runner_replays_the_unsharded_loop(monkeypatch):
    # one loop program for both: a split that lies on one device compiles
    # (on a card, captures) nothing of its own
    plain = _runner()
    _shard_env(monkeypatch, n=2, shard_min=128)
    split = _runner()
    assert split._loop is plain._loop
    assert _runner(cap=120)._loop is not plain._loop  # 120 < 128: another capacity


# ---------------------------------------------------------------------------
# carrying a reference sharded state across
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hist_dtype", ["float32", "bf16"])
def test_reference_sharded_state_continues_on_the_port(monkeypatch, hist_dtype):
    _shard_env(monkeypatch, n=8, hist_dtype=hist_dtype)
    rdom = ref.base.Domain(ref_zoo.ZOO["branin"].objective, ref_zoo.ZOO["branin"].space)
    rr = ref_device_fmin.DeviceLoopRunner(rdom, CFG, 8, EVALS)
    assert rr._mesh is not None and rr._mesh.devices.size == 8
    rs = rr.init_state()
    for start in (0, 10, 20):
        rs, _ = rr.run_chunk(rs, start, start + 10, seed=start + 11)
    labels = ("x", "y")
    vals, active, losses, has_loss = (
        {l: np.asarray(part[l]) for l in labels} if isinstance(part, dict) else np.asarray(part)
        for part in rs)
    pr = _runner(n_startup=8, cap=EVALS)
    ps = convert.device_loop_state_from_numpy(labels, vals, active, losses, has_loss,
                                              device="cpu")
    assert ps[2].shape == (EVALS,) and ps[0]["x"].dtype == pr.hist_dtype
    rs, r_rows = rr.run_chunk(rs, 30, 40, seed=41)
    ps, p_rows = pr.run_chunk(ps, 30, 40, seed=41)
    _assert_same_rows(r_rows, p_rows, len(labels))
    whole = _whole(ps)
    for j, l in enumerate(labels):
        np.testing.assert_allclose(whole[j].float().numpy(),
                                   np.asarray(rs[0][l]).astype(np.float32), rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(whole[2 + j].numpy(), np.asarray(rs[1][l]))
    np.testing.assert_array_equal(whole[5].numpy(), np.asarray(rs[3]))


# ---------------------------------------------------------------------------
# a mesh over more than one card; the pallas_ei names
# ---------------------------------------------------------------------------


def test_a_mesh_over_two_cards_raises_before_any_allocation(monkeypatch):
    monkeypatch.setenv("HYPEROPT_TPU_SHARD", "auto")
    monkeypatch.setenv("HYPEROPT_TPU_HIST_SHARD_MIN", "8")
    monkeypatch.setattr(sharding, "local_devices",
                        lambda device=None: [torch.device("cuda", 0), torch.device("cuda", 1)])

    def no_loop(*a, **kw):
        raise AssertionError("the loop was built")

    monkeypatch.setattr(device_fmin, "_get_loop", no_loop)
    monkeypatch.setattr(device_fmin._Loop, "new_state", no_loop)
    with pytest.raises(NotImplementedError,
                       match="capacity-sharded device loop over more than one card .*item 12c"):
        _runner(cap=EVALS)
    assert sharding.on_one_device(sharding.suggest_mesh(devices=["cuda:0", "cuda:0"]),
                                  "cuda:0")
    assert not sharding.on_one_device(sharding.suggest_mesh(devices=["cpu", "cpu"]), "cuda:0")


def test_pallas_ei_shim_mirrors_the_reference():
    assert pallas_ei.ei_diff is megakernel.ei_diff
    assert pallas_ei.ei_diff_reference is megakernel.ei_diff_plain
    assert isinstance(pallas_ei.pallas_available(), bool)
    if not torch.cuda.is_available():
        assert pallas_ei.pallas_available() is False
    assert ref_pallas_ei.ei_diff_reference is ref_megakernel.ei_diff_reference
    rng = np.random.default_rng(12)
    n, m = 50, 17
    x = rng.uniform(-3, 3, n).astype(np.float32)
    tabs = []
    for _ in range(2):
        w = rng.uniform(0.1, 1.0, m).astype(np.float32)
        w[-3:] = 0.0  # dead components
        tabs += [w / w.sum(), rng.normal(0, 1, m).astype(np.float32),
                 rng.uniform(0.2, 2.0, m).astype(np.float32)]
    want = np.asarray(ref_pallas_ei.ei_diff_reference(x, *tabs))
    got = pallas_ei.ei_diff_reference(torch.from_numpy(x)[None],
                                      *(torch.from_numpy(t)[None] for t in tabs))[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # the wrapper takes the plain version on the CPU
    assert torch.equal(pallas_ei.ei_diff(torch.from_numpy(x)[None],
                                         *(torch.from_numpy(t)[None] for t in tabs))[0], got)
