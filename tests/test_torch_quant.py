"""The port's history quantization against the JAX package's: qparams for
every ``hp`` family, the int8/fp8 codes of the host and device encoders,
the snap round trip and the decode, bit for bit, on seeded grids that
include the clip edges; the bf16 degrade; and a quantized padded history.
Codes and qparams compare bitwise; decoded values of log families at
rtol 1e-5 (torch's ``exp`` and XLA's differ by up to an ulp)."""

import logging

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hyperopt_tpu import hp as ref_hp, quant as ref_quant
from hyperopt_tpu.base import Domain as RefDomain
from hyperopt_tpu_torch import hp, quant
from hyperopt_tpu_torch.base import Domain, PaddedHistory


def _families(h):
    return {
        "uniform": h.uniform("v", -5, 5),
        "quniform": h.quniform("v", 0, 10, 2),
        "loguniform": h.loguniform("v", -4, 0),
        "qloguniform": h.qloguniform("v", 0, 3, 2),
        "normal": h.normal("v", 1, 3),
        "qnormal": h.qnormal("v", 0, 8, 2),
        "lognormal": h.lognormal("v", 0, 1),
        "qlognormal": h.qlognormal("v", 1, 1, 1),
        "uniformint": h.uniformint("v", 1, 6),
        "randint": h.randint("v", 2, 7),
        "randint_wide": h.randint("v", 0, 200),
        "randint_too_wide": h.randint("v", 0, 300),
        "choice": h.choice("v", [0, 1, 2]),
        "pchoice": h.pchoice("v", [(0.25, 0), (0.75, 1)]),
        "tight_uniform": h.uniform("v", 1000.0, 1000.001),
    }


@pytest.mark.parametrize("name", ["int8", "fp8"])
@pytest.mark.parametrize("family", list(_families(ref_hp)))
def test_label_qparams_match_reference(family, name):
    rcs = RefDomain(None, {"v": _families(ref_hp)[family]}).cs
    cs = Domain(None, {"v": _families(hp)[family]}).cs
    want = ref_quant.label_qparams(rcs.params["v"].dist, name)
    assert quant.label_qparams(cs.params["v"].dist, name) == want
    assert quant.space_qparams(cs, name) == ref_quant.space_qparams(rcs, name)


def _grid(qp, n=20001):
    """Values across the coded range and past both clip edges, plus the
    exact grid points; in value space for log families."""
    scale, zero, islog = qp
    t = np.concatenate([np.linspace(zero - 140 * scale, zero + 140 * scale, n),
                        zero + scale * np.arange(-127, 128)]).astype(np.float32)
    return np.exp(t).astype(np.float32) if islog else t


QPARAMS = {"linear": (10 / 254, 0.0, False), "offset": (0.0314, 1.5, False),
           "log": (4 / 254, -2.0, True), "discrete": (1.0, 2.0, False)}


@pytest.mark.parametrize("name", ["int8", "fp8"])
@pytest.mark.parametrize("kind", list(QPARAMS))
def test_codes_snap_and_decode_match_reference(kind, name):
    qp = QPARAMS[kind]
    x = _grid(qp)
    bits = np.int8 if name == "int8" else np.uint8
    want_host = np.asarray(ref_quant.quantize_np(x, qp, name)).view(bits)
    got_host = quant.quantize_np(x, qp, name)
    assert got_host.dtype == quant.vals_dtype(name)
    np.testing.assert_array_equal(got_host.view(torch.int8 if name == "int8" else torch.uint8)
                                  .numpy(), want_host)
    want_dev = np.asarray(jax.jit(lambda v: ref_quant.quantize(v, qp, name))(
        jnp.asarray(x))).view(bits)
    got_dev = quant.quantize(torch.from_numpy(x), qp, name)
    np.testing.assert_array_equal(
        got_dev.view(torch.int8 if name == "int8" else torch.uint8).numpy(), want_dev)
    np.testing.assert_array_equal(quant.snap_np(x, qp, name), ref_quant.snap_np(x, qp, name))
    assert quant.snap_np(np.float32(x[7]), qp, name) == ref_quant.snap_np(x[7], qp, name)
    want = np.asarray(jax.jit(lambda c: ref_quant.dequantize(c, qp))(
        jnp.asarray(ref_quant.quantize_np(x, qp, name))))
    got = quant.dequantize(got_host, qp).numpy()
    if qp[2]:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


def test_fp8_round_trip_matches_ml_dtypes():
    """Numpy has no float8: the port's host fp8 goes through torch, which
    rounds as ml_dtypes does on every point of the coded range."""
    v = np.linspace(-130, 130, 200001).astype(np.float32)
    want = v.astype(ml_dtypes.float8_e4m3fn).astype(np.float32)
    got = torch.from_numpy(v).to(torch.float8_e4m3fn).to(torch.float32).numpy()
    np.testing.assert_array_equal(got, want)


def test_resolve_degrades_q_labels_to_bf16_with_one_warning(caplog):
    space = lambda h: {"x": h.uniform("x", 0, 1), "q": h.quniform("q", 0, 10, 2)}  # noqa: E731
    rcs, cs = RefDomain(None, space(ref_hp)).cs, Domain(None, space(hp)).cs
    ok = Domain(None, {"x": hp.uniform("x", 0, 1)}).cs
    before = quant.fallback_count()
    with caplog.at_level(logging.WARNING, logger=quant.__name__):
        for _ in range(3):
            assert quant.resolve(cs, "int8", context="unit") == ("bfloat16", None)
    assert ref_quant.resolve(rcs, "int8", context="unit") == ("bfloat16", None)
    assert quant.fallback_count() == before + 3
    assert sum(r.name == quant.__name__ for r in caplog.records) == 1
    assert quant.resolve(ok, "int8")[0] == "int8"
    assert quant.resolve(ok, "bfloat16") == ("bfloat16", None)


@pytest.mark.parametrize("name", ["int8", "fp8", "bfloat16", "float32"])
def test_padded_history_stores_and_snaps_like_the_reference(name):
    """A quantized history snaps its recorded rows when it arms, stores
    codes (losses bf16) on the device, and decodes to its snapped host
    values; bf16 and f32 store floats."""
    space = {"x": hp.uniform("x", -5, 5), "lr": hp.loguniform("lr", -4, 0)}
    cs = Domain(None, space).cs
    rng = np.random.default_rng(1)
    ph = PaddedHistory(cs.labels, "cpu", hist_dtype=name)
    raw = [{"x": float(rng.uniform(-5, 5)), "lr": float(np.exp(rng.uniform(-4, 0)))}
           for _ in range(6)]
    for r in raw[:3]:
        ph.append(r, float(rng.uniform()))
    ph.ensure_qparams(cs)
    for r in raw[3:]:
        ph.append(r, float(rng.uniform()))
    dev = ph.device_view()
    for l in cs.labels:
        host = ph._vals[l][:6]
        if name in ("int8", "fp8"):
            qp = quant.label_qparams(cs.params[l].dist, name)
            np.testing.assert_array_equal(
                host, ref_quant.snap_np(np.asarray([r[l] for r in raw], np.float32), qp, name))
            assert dev["vals"][l].dtype == quant.vals_dtype(name)
            got = quant.dequantize(dev["vals"][l][:6], qp).numpy()
            np.testing.assert_allclose(got, host, rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(host, np.asarray([r[l] for r in raw], np.float32))
            assert dev["vals"][l].dtype == quant.vals_dtype(name)
    assert dev["losses"].dtype == quant.losses_dtype(name)
