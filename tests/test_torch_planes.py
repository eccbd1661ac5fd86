"""The port's serving planes against the JAX package's: the cost ledger,
the tenant ledger (its deficit-round-robin order included) and the
search-quality plane give the reference's status dicts for the same tell
and tick sequence (device seconds injected, the clocks faked); the heat
ledger's lines and the tenant field of the WAL admit record are
byte-compatible and resume across the packages; the per-tenant admission
budget sheds as the reference's; the server installs the reference's SLO
objectives; and armed planes never move a proposal."""

import itertools
import json
import shutil
import time

import numpy as np
import pytest

from hyperopt_tpu import hp as ref_hp
from hyperopt_tpu import zoo as ref_zoo
from hyperopt_tpu.obs import load as ref_load
from hyperopt_tpu.obs import quality as ref_quality
from hyperopt_tpu.obs import tenant as ref_tenant
from hyperopt_tpu.service import StudyScheduler as RefScheduler
from hyperopt_tpu.service import integrity as ref_integrity
from hyperopt_tpu.service.overload import AdmissionGuard as RefGuard
from hyperopt_tpu.service.scheduler import Study as RefStudy
from hyperopt_tpu.service.server import ServiceHTTPServer as RefServer
from hyperopt_tpu_torch import Trials, hp, zoo
from hyperopt_tpu_torch.obs import load, quality, tenant
from hyperopt_tpu_torch.service import AdmissionGuard, OverloadError, StudyScheduler, integrity
from hyperopt_tpu_torch.service.scheduler import Study
from hyperopt_tpu_torch.service.server import ServiceHTTPServer

@pytest.fixture
def fake_clock(monkeypatch):
    """Deterministic ``time.monotonic``/``time.time`` (both packages read
    the one ``time`` module); ``reset()`` restarts them for the other
    package's run."""
    state = {}

    def reset():
        state["mono"] = itertools.count(100.0, 0.05)
        state["wall"] = itertools.count(1.7e9, 0.25)

    reset()
    monkeypatch.setattr(time, "monotonic", lambda: next(state["mono"]))
    monkeypatch.setattr(time, "time", lambda: next(state["wall"]))
    return reset


# (op, args): one tick and tell sequence over three studies, two cohorts
COST_OPS = [
    ("bind", (3, "r0")), ("inherit", (12.5,)),
    ("tick", ([("s1", 1), ("s2", 3)], 0.004, 96.0, 4096.0, "cap16")),
    ("tell", ("s1",)), ("tell", ("s2",)),
    ("tick", ([("s3", 2)], 0.0125, 48.0, 1024.0, "cap32")),
    ("tick", ([("s1", 1), ("s3", 1)], 0.0, 48.0, 2048.0, "cap16")),
    ("tick", ([], 0.5, 0.0, 0.0, None)), ("inherit", (3.0,)),
    ("tell", ("s4",)), ("forget", ("s2",)),
    ("tick", ([("s1", 2), ("s2", 2)], 0.00731, 96.0, 4096.0, "cap16")),
]


def _cost_run(mod):
    led = mod.CostLedger()
    for op, args in COST_OPS:
        if op == "tick":
            entries, sec, cand, hbm, cohort = args
            led.observe_tick(entries, sec, cand=cand, hbm_bytes=hbm, cohort=cohort)
        elif op == "tell":
            led.observe_tell(*args)
        else:
            getattr(led, op)(*args)
    return (led.status(), led.publish(), led.heat_record(),
            {s: led.study_status(s) for s in ("s1", "s2", "s3", "s4", "s5")}, led.heat_ms)


def test_cost_ledger_status_equals_the_reference(fake_clock):
    got = _cost_run(load)
    fake_clock()
    want = _cost_run(ref_load)
    assert got == want
    assert got[0]["busy_frac"] > 0 and got[0]["cohorts"]["cap16"]["studies"] == 2


def _tenant_run(mod, top_k=3):
    led = mod.TenantLedger(top_k=top_k)
    orders = []
    for t in ("anon", "a", "b"):
        led.note_study(t)
    led.observe_tick([("a", 1), ("b", 3)], 0.008, hbm_bytes=2048.0)
    orders.append(led.drr_order(["a", "b", "a", "anon"]))
    led.observe_tell("a")
    led.observe_request("a", latency_sec=0.012)
    led.observe_request("b", shed=True)
    led.observe_request("b", latency_sec=0.3)
    for i in range(6):
        orders.append(led.drr_order(["b", "a", "anon"] if i % 2 else ["anon", "b"]))
        led.observe_tick([("anon", 1), ("b", i + 1)], 0.001 * (i + 1))
    led.note_study("c")  # past top_k: the least active row goes to `other`
    led.observe_tick([("c", 2)], 0.02)
    led.note_study("d")
    led.forget_study("a")
    led.forget_study("zz")
    orders.append(led.drr_order(["d", "c", "b"]))
    return (led.status(), led.publish(), led.heat_table(), orders,
            {t: led.study_status(t) for t in ("anon", "a", "b", "c", "d", "other")})


def test_tenant_ledger_and_its_drr_order_equal_the_reference():
    got, want = _tenant_run(tenant), _tenant_run(ref_tenant)
    assert got == want
    assert got[0]["evictions"] >= 1 and "other" in got[0]["table"]
    assert len(got[3]) == 8 and all(o for o in got[3])


class _St:
    """The study fields the quality plane reads, and its timeline."""

    def __init__(self, sid, spec):
        self.study_id = sid
        self.space_spec = spec
        self.events = []

    def note(self, event, **attrs):
        self.events.append((event, {k: v for k, v in attrs.items() if v is not None}))


LOSSES = {"q1": [3.0, 2.0, None, 2.5, 2.5, 2.5, 2.5, 2.5, 0.05, 1.0],
          "br": [9.0, 0.5, 0.45, 0.6, None, 0.7, 0.8, 0.9, 0.95, 0.3]}


def _quality_run(mod):
    plane = mod.QualityPlane(window=4)
    sts = {"q1": _St("q1", {"zoo": "quadratic1"}), "br": _St("br", {"zoo": "branin"})}
    events = []
    for i in range(10):
        for sid, st in sts.items():
            events.append(plane.observe_tell(st, LOSSES[sid][i], replay=i < 2))
    return (plane.status(), plane.publish(), events,
            {sid: plane.study_status(sid) for sid in sts},
            {sid: st.events for sid, st in sts.items()})


def test_quality_plane_status_equals_the_reference():
    got, want = _quality_run(quality), _quality_run(ref_quality)
    assert got == want
    status = got[0]
    assert status["cohorts"]["tpe_quadratic1"]["solved"] == 1 and status["stagnations"] >= 1
    runs = ([1.0, None, 0.3, 0.2], 10, 0.25, 0.0), ([5.0, 4.0], 2, 1.0, None)
    for args in runs:
        assert quality.summarize_run(*args) == ref_quality.summarize_run(*args)
    with pytest.raises(NotImplementedError, match="item 14"):
        quality.quality_record("bench", {})


def test_merge_status_equals_the_reference(fake_clock):
    statuses = []
    for shard, ops in ((0, COST_OPS[2:5]), (1, COST_OPS[5:8])):
        led = ref_load.CostLedger()
        led.bind(shard, "r0")
        for op, args in ops:
            if op == "tick":
                led.observe_tick(args[0], args[1], cand=args[2], hbm_bytes=args[3],
                                 cohort=args[4])
            else:
                led.observe_tell(*args)
        statuses.append(led.status())
    assert load.merge_status(statuses) == ref_load.merge_status(statuses)
    assert load.merge_status([None]) is None
    t_stats = [_tenant_run(ref_tenant)[0], _tenant_run(ref_tenant, top_k=8)[0]]
    assert tenant.merge_status(t_stats) == ref_tenant.merge_status(t_stats)
    q_stats = [_quality_run(ref_quality)[0]] * 2
    assert quality.merge_status(q_stats) == ref_quality.merge_status(q_stats)
    for vals in ([], [1.0], [0.0, 0.0], [1.0, 3.0, None]):
        assert load.heat_skew(vals) == ref_load.heat_skew(vals)


def test_heat_ledger_lines_are_byte_compatible_and_read_across(tmp_path):
    root = str(tmp_path)
    recs = [{"kind": "heat", "replica": "ra", "shard": 0, "heat_ms": 12.5, "device_ms": 12.5,
             "busy_frac": 0.1, "studies": 2, "asks": 3, "tells": 3, "waves": 2, "cand": 72.0,
             "hbm_bytes": 4096.0, "ts": 1.7e9, "tenants": {"a": 4.0, "anon": 8.5}},
            {"kind": "heat", "replica": "rb", "shard": 1, "heat_ms": 3.25, "device_ms": 3.25,
             "busy_frac": 0.0, "studies": 1, "asks": 1, "tells": 0, "waves": 1, "cand": 24.0,
             "hbm_bytes": 1024.0, "ts": 1.7e9 + 1, "tenants": {"a": 3.25}},
            {"kind": "heat", "replica": "rb", "shard": 0, "heat_ms": 20.0, "device_ms": 7.5,
             "busy_frac": 0.2, "studies": 2, "asks": 5, "tells": 4, "waves": 3, "cand": 96.0,
             "hbm_bytes": 8192.0, "ts": 1.7e9 + 2, "tenants": {"a": 6.0}}]
    load.HeatLedger(load.heat_path_for(root, "ra")).append(recs[0])
    ref_load.HeatLedger(ref_load.heat_path_for(root, "ra-ref")).append(recs[0])
    port_file = load.heat_path_for(root, "ra")
    with open(port_file, "rb") as f, open(ref_load.heat_path_for(root, "ra-ref"), "rb") as g:
        assert f.read() == g.read()
    for rec in recs[1:]:
        load.HeatLedger(load.heat_path_for(root, "rb")).append(rec)
    with open(load.heat_path_for(root, "rb"), "ab") as f:
        f.write(b'{"kind": "heat", "shard": 1, "heat_')  # a torn tail
    assert load.read_heat(root) == ref_load.read_heat(root)
    assert load.read_heat(root)["shards"]["0"]["heat_ms"] == 20.0
    for shard in (0, 1, 5):
        assert load.inherited_heat(root, shard) == ref_load.inherited_heat(root, shard)
    assert tenant.read_tenant_heat(root) == ref_tenant.read_tenant_heat(root)
    assert integrity.seal(recs[1]) == ref_integrity.seal(recs[1])


@pytest.mark.parametrize("kwargs", [{"tenant": "team-a", "n_startup_jobs": 3, "max_trials": 9,
                                     "gamma": 0.3},
                                    {"n_startup_jobs": 4}, {"tenant": "anon"}])
def test_admit_kwargs_with_a_tenant_are_the_references(kwargs):
    got = Study("s", {"x": hp.uniform("x", 0, 1)}, seed=1, trials=Trials(device="cpu"),
                **kwargs)
    want = RefStudy("s", {"x": ref_hp.uniform("x", 0, 1)}, seed=1, **kwargs)
    assert json.dumps(got.admit_kwargs) == json.dumps(want.admit_kwargs)
    assert got.tenant == want.tenant
    got_status = {k: v for k, v in got.status_dict().items() if k not in ("created",
                                                                           "last_active")}
    want_status = {k: v for k, v in want.status_dict().items() if k not in ("created",
                                                                            "last_active")}
    assert got_status == want_status


def _tenant_drive(sched, zoo_mod, rounds, sids=None):
    """Admit two tenant studies and one anonymous (first call), then
    ``rounds`` ask/tell rounds; returns the sids and the stream."""
    if sids is None:
        sids = [sched.create_study(zoo_mod.ZOO[name].space, seed=s, n_startup_jobs=3,
                                   space_spec={"zoo": name}, **kw)
                for name, s, kw in (("quadratic1", 4, {"tenant": "team-a"}),
                                    ("hpob_surrogate", 5, {"tenant": "team-b"}),
                                    ("branin", 6, {}))]
    out = []
    for _ in range(rounds):
        for i, sid in enumerate(sids):
            (a,) = sched.ask(sid)
            sched.tell(sid, a["tid"], float(((a["tid"] * 31 + i * 7) % 17) / 17.0))
            out.append((i, a["tid"], a["params"]))
    return sids, out


@pytest.mark.parametrize("writer", ["JAX", "port"])
def test_tenant_wal_record_resumes_across_the_packages(tmp_path, writer):
    root = str(tmp_path / "w")
    first = (RefScheduler(store_root=root) if writer == "JAX"
             else StudyScheduler(store_root=root, device="cpu"))
    sids, _ = _tenant_drive(first, ref_zoo if writer == "JAX" else zoo, 4)
    # as after a crash (every record is fsynced, nothing compacted): the
    # other package resumes one copy of the root, the writer's another
    other, own = str(tmp_path / "other"), str(tmp_path / "own")
    shutil.copytree(root, other)
    shutil.copytree(root, own)
    first.drain()
    resumed = (StudyScheduler(store_root=other, device="cpu") if writer == "JAX"
               else RefScheduler(store_root=other))
    again = (RefScheduler(store_root=own) if writer == "JAX"
             else StudyScheduler(store_root=own, device="cpu"))
    for sched in (resumed, again):
        assert [sched._studies[s].tenant for s in sids] == ["team-a", "team-b", "anon"]
    assert resumed.tenants.status() == again.tenants.status()
    assert resumed.tenants.status()["table"]["team-a"]["tells"] == 4
    _, got = _tenant_drive(resumed, None, 2, sids)
    _, want = _tenant_drive(again, None, 2, sids)
    assert [(i, t) for i, t, _ in got] == [(i, t) for i, t, _ in want]
    for (_, _, a), (_, _, b) in zip(got, want):
        for k in b:
            np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=1e-5, atol=1e-6)


def test_planes_armed_propose_what_disarmed_do_bit_for_bit():
    """Waves of many tenants (the deficit-round-robin reorders them)
    through armed and disarmed schedulers: the same streams bit for bit,
    and the armed planes recorded the run."""
    mix = zoo.make_study_mix(10)
    streams, planes = [], None
    for armed in (True, False):
        off = {} if armed else {"quality": False, "load": False, "tenants": False}
        sched = StudyScheduler(device="cpu", wal=False, **off)
        sids = [sched.create_study(it.domain.space, seed=it.seed, n_startup_jobs=3,
                                   space_spec={"zoo": it.domain.name},
                                   tenant=f"t{i % 4}" if i % 5 else None)
                for i, it in enumerate(mix)]
        stream = []
        for r in range(7):
            wave = [(sid, 1) for sid in (sids if r % 2 else sids[::-1])]
            out = sched.ask_many(wave)
            for i, sid in enumerate(sids):
                (a,) = out[sid]
                sched.tell(sid, a["tid"], float(((a["tid"] * 13 + i) % 11) / 11.0))
                stream.append((i, a["tid"], {k: repr(v) for k, v in a["params"].items()}))
        streams.append(stream)
        if armed:
            planes = (sched.quality.status(), sched.load.status(), sched.tenants.status(),
                      sched.studies_status())
    assert streams[0] == streams[1]
    q, cost, ten, studies = planes
    assert q["studies"] == 10 and cost["waves"] >= 4 and cost["tells"] == 70
    assert sorted(ten["table"]) == ["anon", "t0", "t1", "t2", "t3"] and ten["tells"] == 70
    assert all("quality" in s and "load" in s for s in studies["studies"])
    assert studies["tenants"]["asks"] == cost["asks"]


def test_per_tenant_budget_sheds_as_the_reference():
    seq = [("admit", "a"), ("admit", "a"), ("admit", "a"), ("admit", "b"), ("release", "a"),
           ("admit", "a"), ("admit", None), ("admit", "b"), ("release", "b"), ("admit", "b")]
    outcomes = {}
    for side, guard in (("port", AdmissionGuard(max_queue=5, tenant_quota=2)),
                        ("ref", RefGuard(max_queue=5, tenant_quota=2))):
        out = []
        for op, t in seq:
            if op == "release":
                guard.release("ask", tenant=t)
                continue
            try:
                guard.admit_ask(tenant=t)
                out.append("ok")
            except Exception as e:  # noqa: BLE001
                out.append(type(e).__name__ + str(e))
        outcomes[side] = (out, dict(guard._tenant_inflight), guard.tenant_quota)
    assert outcomes["port"] == outcomes["ref"]
    assert outcomes["port"][0][2].startswith("OverloadError")
    with pytest.raises(OverloadError):
        guard = AdmissionGuard(max_queue=5, tenant_quota=1)
        guard.admit_ask(tenant="x")
        guard.admit_ask(tenant="x")
    assert AdmissionGuard(tenant_quota=False).tenant_quota is None


def test_server_installs_the_reference_slo_objectives():
    names = {}
    for side, make in (("port", lambda: ServiceHTTPServer(
            0, scheduler=StudyScheduler(device="cpu", wal=False))),
                       ("ref", lambda: RefServer(0, scheduler=RefScheduler(wal=False)))):
        srv = make()
        _, p = srv.handle("POST", "/study", {"zoo": "branin", "n_startup_jobs": 5},
                          headers={"x-tenant": "team-a"})
        srv.handle("POST", "/ask", {"study_id": p["study_id"]}, headers={"x-tenant": "team-a"})
        srv.handle("GET", "/snapshot", {})
        names[side] = (sorted(srv.slo.objectives), srv.load_skew_max, sorted(srv._tenant_objs))
    assert names["port"] == names["ref"]
    assert "stagnation" in names["port"][0] and "imbalance" in names["port"][0]
    assert "tenant:team-a:ask_p99" in names["port"][0]
