"""The port's request-trace plane (``obs/reqtrace.py``) against the JAX
package's: the reference's own header corpus (valid, malformed,
oversized, control bytes, all-zero ids, non-strings) through both
packages' ``parse``, ``extract_or_mint``, ``sanitize_request_id`` and
``child``; the context's ``traceparent``; minted ids of the reference's
shape, each package parsing the other's; and armed servers proposing bit
for bit as disarmed ones."""

import importlib.util
import os
import re

import pytest

from hyperopt_tpu.obs import reqtrace as ref
from hyperopt_tpu_torch.obs import reqtrace as port
from hyperopt_tpu_torch.service import StudyScheduler
from hyperopt_tpu_torch.service.server import ServiceHTTPServer


def _reference_corpus():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_reqtrace.py")
    spec = importlib.util.spec_from_file_location("_ref_reqtrace_corpus", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.VALID_TP, list(mod.HOSTILE_TRACEPARENTS)


VALID_TP, HOSTILE = _reference_corpus()
VALID = [VALID_TP, VALID_TP.replace("00-", "01-", 1) + "-future",
         "00-0123456789abcdef0123456789abcdef-0123456789abcdef-00"]
HEADERS = VALID + HOSTILE + [None, 7, b"00-aa-bb-01", ["00"], {"tp": 1}]
REQUEST_IDS = ["req-1_2.3:ok", "", "x" * 1000, "evil\nheader", "\x00\x01", 42, None,
               "x" * 128, "x" * 129, "a b", "trace/ok", "тест", "req-42"]
HEX32, HEX16 = re.compile(r"^[0-9a-f]{32}$"), re.compile(r"^[0-9a-f]{16}$")


def _ids(ctx):
    return None if ctx is None else (ctx.trace_id, ctx.span_id, ctx.parent_id)


def _shape_ok(ctx):
    return (HEX32.match(ctx.trace_id) and HEX16.match(ctx.span_id)
            and ctx.trace_id != "0" * 32 and ctx.span_id != "0" * 16)


@pytest.mark.parametrize("header", HEADERS, ids=range(len(HEADERS)))
def test_parse_matches_the_reference(header):
    assert _ids(port.parse(header)) == _ids(ref.parse(header))


@pytest.mark.parametrize("header", HEADERS, ids=range(len(HEADERS)))
def test_extract_or_mint_matches_the_reference(header):
    got, want = port.extract_or_mint(header), ref.extract_or_mint(header)
    assert _shape_ok(got) and _shape_ok(want)
    parsed = ref.parse(header)
    if parsed is None:  # a fresh trace in both, never the hostile value
        assert got.parent_id is None and want.parent_id is None
        assert got.trace_id != header and got.trace_id != want.trace_id
    else:  # the caller's trace continues under a new span
        assert (got.trace_id, got.parent_id) == (want.trace_id, want.parent_id) \
            == (parsed.trace_id, parsed.span_id)
        assert got.span_id != parsed.span_id


@pytest.mark.parametrize("value", REQUEST_IDS, ids=range(len(REQUEST_IDS)))
def test_sanitize_request_id_matches_the_reference(value):
    assert port.sanitize_request_id(value) == ref.sanitize_request_id(value)


def test_child_and_traceparent_match_the_reference():
    for tp in VALID:
        p, r = port.parse(tp), ref.parse(tp)
        assert p.traceparent() == r.traceparent()
        kp, kr = port.child(p), ref.child(r)
        assert (kp.trace_id, kp.parent_id) == (kr.trace_id, kr.parent_id) \
            == (p.trace_id, p.span_id)
        assert _shape_ok(kp) and kp.span_id != p.span_id
        assert kp.traceparent() == f"00-{kp.trace_id}-{kp.span_id}-01"
        assert port.TraceContext(kr.trace_id, kr.span_id).traceparent() == kr.traceparent()


def test_minted_ids_have_the_reference_shape_and_cross_parse():
    for _ in range(20):
        p, r = port.mint(), ref.mint()
        assert _shape_ok(p) and _shape_ok(r)
        assert p.parent_id is None and r.parent_id is None
        assert _ids(ref.parse(p.traceparent())) == (p.trace_id, p.span_id, None)
        assert _ids(port.parse(r.traceparent())) == (r.trace_id, r.span_id, None)
    assert port.mint().trace_id != port.mint().trace_id


def test_use_and_current_restore_like_the_reference():
    assert port.current() is None
    ctx = port.mint()
    with port.use(ctx):
        assert port.current() is ctx and port.current_trace_id() == ctx.trace_id
        with port.use(port.child(ctx)) as inner:
            assert port.current() is inner
        assert port.current() is ctx
    assert port.current() is None


def _drive(trace, headers):
    srv = ServiceHTTPServer(0, scheduler=StudyScheduler(device="cpu", wal=False),
                            trace=trace, slo=False)
    code, r = srv.handle("POST", "/study", {"space": {"x": {"dist": "uniform",
                                                            "args": [-5, 5]}},
                                            "seed": 7, "n_startup_jobs": 2})
    assert code == 200, r
    sid, out = r["study_id"], []
    for i in range(6):
        code, a = srv.handle("POST", "/ask", {"study_id": sid}, headers=headers)
        assert code == 200, a
        t = a["trials"][0]
        out.append((t["tid"], repr(float(t["params"]["x"]))))
        code, _ = srv.handle("POST", "/tell", {"study_id": sid, "tid": t["tid"],
                                               "loss": (float(t["params"]["x"]) - 1) ** 2})
        assert code == 200
    return out, a


@pytest.mark.parametrize("header", [VALID_TP, HOSTILE[4], HOSTILE[-2]])
def test_armed_server_proposes_bit_for_bit_as_disarmed(header):
    armed, last = _drive(True, {"traceparent": header, "x-request-id": "req-9"})
    disarmed, _ = _drive(False, {})
    assert armed == disarmed
    assert HEX32.match(last["trace"])
    if ref.parse(header) is not None:
        assert last["trace"] == ref.parse(header).trace_id
