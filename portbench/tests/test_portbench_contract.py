"""``BENCHMARK.json`` keeps to the benchmark's contract: its keys, names,
units and lengths, every configuration used and found with its objective
and plain reference beside it, every traffic mix, the entry module it
names and every metric found by name, every
cell reporting ``setup_s``, another end-to-end metric and a per-layer
metric, and a run length that fits a full check of 24 cells."""

import json
import re

import pytest

from conftest import BENCH, REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    rs = SPEC["run_seconds"]
    assert 2 * (rs + 60) + 24 * (14 * (rs + 60) + 2 * 90) + 1200 <= 43200


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_config(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
    assert c["file"] == f"portbench/configs/{c['name']}.json"
    cfg = json.loads((REPO / c["file"]).read_text())
    src = (BENCH / "configs" / f"{c['name']}.py").read_text()
    assert "\ndef fn(" in src and "\ndef objective(" in src
    assert sorted(c["reduced"]) == sorted(cfg["reduced"])
    assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    assert any(w["config"] == c["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
    assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
    mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    src = (BENCH / "entries" / f"{mix['entry']}.py").read_text()
    assert "\nclass Entry" in src and "\ndef judge(" in src
    e2e = [m["name"] for m in SPEC["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(w["name"] in m.get("workloads", [w["name"]]) for m in SPEC["per_layer"])


def test_metrics():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in SPEC["end_to_end"]} >= {"setup_s"}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        assert set(m.get("workloads", [])) <= cells and TEXT.match(m["layer"])
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
