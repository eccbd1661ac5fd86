"""The device loop's chunk-cycle metrics (``chunk_gap_ms.loop``,
``chunk_host_ms.loop``, ``replay_share.loop``) on the CPU at tiny sizes:
a traced run of the loop cell reads them from the program's counters,
the batch cell, which runs no device loop, reports none of them, and a
program that keeps no such counters gives nothing to read and no
error."""

import importlib.util

import pytest

from conftest import BENCH, run_harness

CYCLE = ("chunk_gap_ms.loop", "chunk_host_ms.loop", "replay_share.loop")


def _traced(root, cell):
    rc, out, err = run_harness(root, ["--workload", cell, "--seed", "4000000017", "--seconds",
                                      "0.5", "--trace", "1"])
    assert rc == 0, err[-3000:]
    assert out["correct"] is True
    return out["metrics"]


def test_traced_loop_cell_reports_the_chunk_cycle(tiny):
    m = _traced(tiny, "branin.device_loop")
    assert set(CYCLE) <= set(m)
    assert {m[k]["unit"] for k in CYCLE} == {"ms", "%"}
    assert 0 < m["chunk_host_ms.loop"]["value"] < m["chunk_gap_ms.loop"]["value"]
    assert 0 < m["replay_share.loop"]["value"] < 100


def test_traced_batch_cell_reports_no_chunk_cycle(tiny):
    assert not set(CYCLE) & set(_traced(tiny, "lcbench.batch10240"))


@pytest.mark.parametrize("name", CYCLE)
def test_a_program_without_the_counters_gives_nothing(monkeypatch, name):
    from hyperopt_tpu_torch.obs import metrics

    monkeypatch.setattr(metrics, "_REGISTRIES", {})
    spec = importlib.util.spec_from_file_location(name, BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.read({}) is None
