"""The service plane's durable half against the JAX package's: sealed
records and their classification, scrub, the WAL record for record, and
stores written by one package resumed by the other (WAL only, store +
WAL, compacted), on the CPU.

Ids, seeds and counts are held bit for bit; proposals by the parity
standard (rtol 1e-5, atol 1e-6).  Each package's writer runs once per
root kind (module-scoped fixtures), so the reference compiles its cohort
programs once."""

import json
import os
import shutil

import numpy as np
import pytest

from hyperopt_tpu import chaos as ref_chaos
from hyperopt_tpu.service import StudyScheduler as RefScheduler
from hyperopt_tpu.service import integrity as ref_integrity
from hyperopt_tpu.service import scrub as ref_scrub
from hyperopt_tpu.service.spacespec import space_from_spec as ref_space
from hyperopt_tpu_torch import chaos as port_chaos
from hyperopt_tpu_torch.service import StudyScheduler as PortScheduler
from hyperopt_tpu_torch.service import integrity, scrub
from hyperopt_tpu_torch.service.journal import StudyJournal
from hyperopt_tpu_torch.service.spacespec import space_from_spec as port_space

CHOICE_SPEC = {"x": {"dist": "uniform", "args": [-5, 5]},
               "c": {"dist": "choice", "options": [0, 1, 2]}}
# (spec wrapper, seed) of each study: a zoo study and a space with a choice
STUDIES = [({"zoo": "quadratic1"}, 11), ({"zoo": "quadratic1"}, 12),
           ({"space": CHOICE_SPEC}, 13), ({"space": CHOICE_SPEC}, 14)]
ROUNDS, NEXT = 4, 3
KINDS = ("wal_only", "store_wal", "compacted")


class _Pkg:
    """One package's scheduler, chaos plane and spec reader."""

    def __init__(self, name):
        self.name = name
        self.ref = name == "ref"
        self.Scheduler = RefScheduler if self.ref else PortScheduler
        self.chaos = ref_chaos if self.ref else port_chaos
        self.space_from_spec = ref_space if self.ref else port_space

    def scheduler(self, **kw):
        if not self.ref:
            kw["device"] = "cpu"
        return self.Scheduler(**kw)

    def space(self, wrapper):
        if "zoo" in wrapper:
            from hyperopt_tpu_torch import zoo as port_zoo
            from hyperopt_tpu import zoo as ref_zoo

            return (ref_zoo if self.ref else port_zoo).ZOO[wrapper["zoo"]].space
        return self.space_from_spec(wrapper["space"])


PKGS = {"ref": _Pkg("ref"), "port": _Pkg("port")}


def _loss(params):
    return float((float(params["x"]) - 1.0) ** 2 + float(params.get("c", 0)))


def _sched_kw(root, kind):
    if kind == "wal_only":
        return {"wal": os.path.join(root, "service.wal.jsonl")}
    return {"store_root": root}


def _write(pkg, root, kind):
    """The writer's sequence: admit, startup and TPE asks, tells (one a
    failure), a void ask, a pending ask; compacted by a drain for the
    compacted kind."""
    sched = pkg.scheduler(**_sched_kw(root, kind))
    sids = [sched.create_study(pkg.space(w), seed=seed, study_id=f"s{i}", space_spec=w,
                               n_startup_jobs=2)
            for i, (w, seed) in enumerate(STUDIES)]
    for r in range(ROUNDS):
        for sid, (a,) in sched.ask_many([(sid, 1) for sid in sids]).items():
            status = "fail" if (r == 2 and sid == "s1") else None
            sched.tell(sid, a["tid"], _loss(a["params"]), status=status)
    # a void ask: its tick faults with the ladder off
    sched.degrade = None
    pkg.chaos.configure("1:ioerr@tick:1.0")
    try:
        with pytest.raises(OSError):
            sched.ask("s0")
    finally:
        pkg.chaos.configure(None)
        pkg.chaos.reset()
    (pending,) = sched.ask("s1")  # left untold: resumes as pending
    if kind == "compacted":
        assert sched.drain()
    elif sched.journal is not None:
        sched.journal.sync()
    return pending


def _study_state(sched, sid):
    st = sched._studies[sid]
    return (st.seed, st.n_asked, st.n_told, st.state, st.rstate.bit_generator.state,
            sorted(d["tid"] for d in st.trials._dynamic_trials))


def _continue(sched, n=NEXT):
    """The next ``n`` asks of every study (told), as ``[(sid, tid, params)]``."""
    out = []
    sids = sorted(s for s in sched._studies if sched._studies[s].state == "active")
    for _ in range(n):
        for sid, answers in sorted(sched.ask_many([(s, 1) for s in sids]).items()):
            for a in answers:
                out.append((sid, a["tid"], a["params"]))
                sched.tell(sid, a["tid"], _loss(a["params"]))
    return out


def _assert_parity(got, want):
    assert [(s, t) for s, t, _ in got] == [(s, t) for s, t, _ in want]
    for (_, _, a), (_, _, b) in zip(got, want):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """``{(writer, kind): (pristine root, state after the writer's own
    resume, the writer's continuation)}``."""
    out = {}
    for writer in ("ref", "port"):
        for kind in KINDS:
            root = str(tmp_path_factory.mktemp(f"{writer}_{kind}"))
            _write(PKGS[writer], root, kind)
            pristine = str(tmp_path_factory.mktemp(f"{writer}_{kind}_pristine"))
            shutil.copytree(root, pristine, dirs_exist_ok=True)
            own = PKGS[writer].scheduler(**_sched_kw(root, kind))
            state = {sid: _study_state(own, sid) for sid in own._studies}
            out[writer, kind] = (pristine, state, _continue(own))
    return out


def _copy(src, tmp_path):
    dst = str(tmp_path / "root")
    shutil.copytree(src, dst)
    return dst


# -- sealed records ----------------------------------------------------------

RECORDS = [
    {"kind": "admit", "sid": "s1", "spec": {"zoo": "branin"}, "seed": 7,
     "kwargs": {"n_startup_jobs": 5, "gamma": 0.25}, "ts": 1.5},
    {"kind": "ask", "sid": "s1", "tids": [0, 1], "seed": 2**31 - 2, "algo": "tpe",
     "req": "ab12", "ts": 1e9 + 0.125},
    {"kind": "tell", "sid": "s1", "tid": 3, "loss": -0.1, "status": None, "ts": 2.0},
    {"kind": "snapshot", "sid": "é", "spec": None, "rstate": {"state": {"state": 2**100}},
     "n_asked": 3, "n_told": 2, "state": "active"},
    {},
]


@pytest.mark.parametrize("i", range(len(RECORDS)))
def test_seal_and_verify_match_the_reference(i):
    rec = RECORDS[i]
    line = integrity.seal(dict(rec))
    assert line == ref_integrity.seal(dict(rec))
    assert integrity.seal_obj(dict(rec)) == ref_integrity.seal_obj(dict(rec))
    for verify in (integrity.verify_obj, ref_integrity.verify_obj):
        assert verify(json.loads(line)) == integrity.OK
    bad = json.loads(line)
    bad["c"] = format(int(bad["c"], 16) ^ 1, "08x")
    assert integrity.verify_obj(dict(bad)) == ref_integrity.verify_obj(dict(bad)) == "corrupt"
    assert integrity.crc32c(b"123456789") == 0xE3069283


def test_line_classification_matches_the_reference(tmp_path):
    sealed = [integrity.seal({"kind": "admit", "sid": f"s{i}", "seed": i}) for i in range(5)]
    mid = bytearray(sealed[2].encode())
    mid[len(mid) // 2] ^= 0x04  # one flipped bit in the middle of a record
    path = tmp_path / "w.jsonl"
    path.write_bytes(b"\n".join([sealed[0].encode(), sealed[1][:20].encode(), bytes(mid),
                                 json.dumps({"kind": "close", "sid": "s9"}).encode(),
                                 sealed[3].encode(), sealed[4][:-7].encode()]))
    got = [(c.status, c.lineno, c.rec) for c in integrity.iter_checked_jsonl(str(path))]
    want = [(c.status, c.lineno, c.rec) for c in ref_integrity.iter_checked_jsonl(str(path))]
    assert got == want
    assert [s for s, _, _ in got] == ["ok", "corrupt", "corrupt", "unchecked", "ok", "torn"]


def test_scrub_reports_what_the_reference_reports(written, tmp_path):
    root = _copy(written["ref", "store_wal"][0], tmp_path)
    wal = os.path.join(root, "service.wal.jsonl")
    lines = open(wal, "rb").read().split(b"\n")
    i = next(k for k, line in enumerate(lines) if b'"algo":"tpe"' in line)
    lines[i] = lines[i].replace(b'"algo":"tpe"', b'"algo":"tpf"', 1)  # parses, checksum fails
    open(wal, "wb").write(b"\n".join(lines))
    got, want = scrub.scan_store(root), ref_scrub.scan_store(root)
    drop = ("ts", "scan_sec", "records_per_sec")
    for key in set(got) | set(want):
        if key in drop:
            continue
        if key == "wals":
            assert [{k: v for k, v in w.items() if k != "scan_sec"} for w in got[key]] == \
                   [{k: v for k, v in w.items() if k != "scan_sec"} for w in want[key]]
        else:
            assert got[key] == want[key], key
    assert not got["clean"] and got["wals"][0]["counts"]["corrupt"] == 1
    assert scrub.main([root, "--json"]) == ref_scrub.main([root, "--json"]) == 2


# -- the WAL, record for record ----------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_wal_records_match_the_reference_field_for_field(written, kind):
    def recs(pkg):
        path = os.path.join(written[pkg, kind][0], "service.wal.jsonl")
        return [json.loads(line) for line in open(path) if line.strip()]

    ref, port = recs("ref"), recs("port")
    strip = [{k: v for k, v in r.items() if k not in ("ts", "trace", "c")} for r in ref]
    assert [{k: v for k, v in r.items() if k not in ("ts", "trace", "c")} for r in port] \
        == strip
    kinds = {r["kind"] for r in strip}
    assert kinds == ({"snapshot"} if kind == "compacted" else {"admit", "ask", "tell"})
    if kind != "compacted":
        assert any(r.get("algo") == "void" for r in strip)
    # each file's lines verify under the other package's verify_obj
    for lines, verify in ((port, ref_integrity.verify_obj), (ref, integrity.verify_obj)):
        assert all(verify(dict(r)) == "ok" for r in lines)


# -- cross-resume ------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_root_resumes_in_the_other_package(written, tmp_path, writer, reader, kind):
    pristine, state, continuation = written[writer, kind]
    root = _copy(pristine, tmp_path)
    sched = PKGS[reader].scheduler(**_sched_kw(root, kind))
    stats = sched.last_resume
    assert stats["errors"] == stats["seed_mismatches"] == stats["quarantined"] == 0
    assert {sid: _study_state(sched, sid) for sid in sched._studies} == state
    assert sched._studies["s1"].n_pending == 1  # the untold ask
    _assert_parity(_continue(sched), continuation)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_resume_twice_is_idempotent_and_skips_a_duplicate_tell(written, tmp_path, writer):
    pristine, state, continuation = written[writer, "wal_only"]
    root = _copy(pristine, tmp_path)
    wal = os.path.join(root, "service.wal.jsonl")
    tell = next(json.loads(line) for line in open(wal) if '"tell"' in line)
    tell.pop("c")
    j = StudyJournal(wal)  # the same tell journaled twice (a retried tell)
    j.append(tell)
    j.close()
    readers = {}
    for name in ("ref", "port"):
        first = PKGS[name].scheduler(**_sched_kw(root, "wal_only"))
        assert first.last_resume["duplicate_tells"] == 1
        readers[name] = {sid: _study_state(first, sid) for sid in first._studies}
        first.journal.close()
        again = PKGS[name].scheduler(**_sched_kw(root, "wal_only"))
        assert {sid: _study_state(again, sid) for sid in again._studies} == readers[name]
    assert readers["ref"] == readers["port"] == state


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_corrupt_segment_quarantines_the_same_study(written, tmp_path, writer):
    out = {}
    for name in ("ref", "port"):
        root = _copy(written[writer, "store_wal"][0], tmp_path / name)
        wal = os.path.join(root, "service.wal.jsonl")
        lines = open(wal).read().split("\n")
        i = next(k for k, line in enumerate(lines) if '"sid":"s2"' in line and '"ask"' in line)
        lines[i] = lines[i].replace('"algo":"', '"algo":"x', 1)  # parses, checksum fails
        open(wal, "w").write("\n".join(lines))
        sched = PKGS[name].scheduler(**_sched_kw(root, "store_wal"))
        assert os.path.exists(wal + ".quarantined")
        status = sched.studies_status()
        out[name] = (status["quarantined"].keys(),
                     {sid: _study_state(sched, sid) for sid in sched._studies
                      if sid not in sched._quarantined})
        again = PKGS[name].scheduler(**_sched_kw(root, "store_wal"))  # resume twice
        assert set(again._quarantined) == {"s2"}
    assert set(out["ref"][0]) == set(out["port"][0]) == {"s2"}
    assert out["ref"][1] == out["port"][1]


# -- the compile plane's census ----------------------------------------------

def test_census_is_the_reference_census_and_warms_the_top_cohort(tmp_path):
    from hyperopt_tpu.service.compile_plane import SignatureCensus as RefCensus
    from hyperopt_tpu_torch.service.compile_plane import (CompilePlane, SignatureCensus,
                                                          census_path_for)

    cfg = {"gamma": 0.25, "n_EI_candidates": 24, "prior_weight": 1.0}
    files = {}
    for name, census in (("port", SignatureCensus), ("ref", RefCensus)):
        c = census(str(tmp_path / f"{name}.jsonl"))
        for i in range(9):  # milestones 1 and 8
            c.note({"zoo": "branin"}, cfg, 16, 4, 1)
            c.note({"space": CHOICE_SPEC}, cfg, 32, 2, 1)
        c.note(None, cfg, 16, 1, 1)  # a direct-API study: uncountable
        files[name] = [{k: v for k, v in json.loads(line).items() if k not in ("ts", "c")}
                       for line in open(c.path)]
        assert all(integrity.verify_obj(json.loads(line)) == "ok" for line in open(c.path))
    assert files["port"] == files["ref"] and len(files["port"]) == 4
    ref_read = RefCensus(str(tmp_path / "port.jsonl")).read()
    port_read = SignatureCensus(str(tmp_path / "ref.jsonl")).read()
    assert [(r["spec"], r["count"]) for r in ref_read] == \
        [(r["spec"], r["count"]) for r in port_read]
    # a scheduler with the plane armed counts its ticks and never serves
    # the warming floor
    root = str(tmp_path / "root")
    plane = CompilePlane(census_path=census_path_for(root), device="cpu")
    sched = PKGS["port"].scheduler(store_root=root, compile_plane=plane)
    sid = sched.create_study(PKGS["port"].space({"zoo": "quadratic1"}), seed=1,
                             space_spec={"zoo": "quadratic1"}, n_startup_jobs=1)
    for _ in range(3):
        (a,) = sched.ask(sid)
        assert "warming" not in a and "degraded" not in a
        sched.tell(sid, a["tid"], 1.0)
    assert [r["count"] for r in SignatureCensus(plane.census.path).read()] == [1]
    assert CompilePlane(census_path=plane.census.path, device="cpu").warm_from_census(
        top_n=1) == (1, 0)
    assert sched.studies_status()["compile"]["warming_studies"] == 0


def test_a_waves_startup_asks_are_served_as_one_at_a_time(tmp_path):
    """``ask_many`` draws a wave's startup asks in one batch per space;
    the answers and the WAL equal the reference's, which serves them one
    by one, also for a study asked twice in a wave (its second ask sees
    the first's doc) and across its move from startup to TPE."""
    got = {}
    for name, pkg in PKGS.items():
        wal = str(tmp_path / f"{name}.jsonl")
        sched = pkg.scheduler(wal=wal)
        for i, (w, seed) in enumerate(STUDIES):
            sched.create_study(pkg.space(w), seed=seed, study_id=f"s{i}", space_spec=w,
                               n_startup_jobs=3)
        answers = []
        for _ in range(3):
            wave = sched.ask_many([("s0", 1), ("s2", 2), ("s0", 1), ("s3", 1)])
            for sid in sorted(wave):
                for a in wave[sid]:
                    answers.append((sid, a["tid"], a.get("wave"), a["params"]))
                    sched.tell(sid, a["tid"], _loss(a["params"]))
        sched.journal.sync()
        recs = [{k: v for k, v in json.loads(line).items() if k not in ("ts", "trace", "c")}
                for line in open(wal)]
        got[name] = answers, recs
    (pa, prec), (ra, rrec) = got["port"], got["ref"]
    assert prec == rrec
    _assert_parity([(s, t, p) for s, t, _, p in pa], [(s, t, p) for s, t, _, p in ra])
    assert [w for _, _, w, _ in pa] == [w for _, _, w, _ in ra]


@pytest.mark.parametrize("name", ["branin", "hpob_surrogate", "many_dists"])
def test_suggest_many_gives_each_ask_the_docs_of_suggest(name):
    from hyperopt_tpu_torch import Trials, zoo
    from hyperopt_tpu_torch.algos import rand
    from hyperopt_tpu_torch.base import Domain

    asks = [([2 * s, 2 * s + 1] if s % 2 else [s], Domain(None, zoo.ZOO[name].space),
             Trials(device="cpu"), 1000 + 7919 * s + (s << 33)) for s in range(5)]
    many = rand.suggest_many(asks)
    for docs, ask in zip(many, asks):
        one = rand.suggest(*ask)
        assert [d["tid"] for d in docs] == [d["tid"] for d in one]
        assert [d["misc"]["vals"] for d in docs] == [d["misc"]["vals"] for d in one]


@pytest.mark.parametrize("rec", [
    {"kind": "admit", "sid": "study-f1b5f801ebf7", "seed": 5, "kwargs": {"n_startup_jobs": 1},
     "spec": {"space": {"x": {"dist": "uniform", "args": [-5, 5]}}}, "ts": 1792287302.07},
    {"algo": "tpe", "kind": "ask", "req": "6c54f66720957bcd", "seed": 1728730614,
     "sid": "study-f1b5f801ebf7", "tids": [1], "trace": "6d86af8997766119da1ec0e56f2f2024",
     "ts": 1792287302.119059},
    {"kind": "tell", "loss": 0.25, "sid": "study-f1b5f801ebf7", "status": None, "tid": 0},
], ids=["admit", "ask", "tell"])
def test_every_single_bit_flip_of_a_sealed_line_is_detected(rec, tmp_path):
    """Queue 3, item 17: a flip in the seal's key turned a record into an
    unsealed one (``unchecked``), and an upper-cased checksum digit
    verified; the STORE gate's scrub count missed both.  Every flipped bit
    of a sealed line, mid-file or at the tail, is now ``corrupt``."""
    line = (integrity.seal(rec) + "\n").encode()
    tail = (integrity.seal({"kind": "close", "sid": "s"}) + "\n").encode()
    path = tmp_path / "w.jsonl"
    missed = []
    for pos in range((len(line) - 1) * 8):
        flipped = bytearray(line)
        flipped[pos // 8] ^= 1 << (pos % 8)
        for body, at in ((bytes(flipped) + tail, 0), (tail + bytes(flipped), 1)):
            path.write_bytes(body)
            got = [c.status for c in integrity.iter_checked_jsonl(str(path))][at]
            if got not in (integrity.CORRUPT, integrity.TORN if at else integrity.CORRUPT):
                missed.append((pos, at, got))
    assert not missed
    path.write_bytes(line + tail)
    assert [c.status for c in integrity.iter_checked_jsonl(str(path))] == ["ok", "ok"]
