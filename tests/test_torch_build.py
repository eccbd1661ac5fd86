"""The name of a kernel's built library covers everything its build reads:
the ``.cu`` source, every ``csrc/*.cuh`` header and the ``nvcc`` flags, so
an edit to any of them builds anew.  Names only: no ``nvcc`` is needed."""

import pytest

from hyperopt_tpu_torch import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that the build reads instead of the package's."""
    copy = tmp_path / "csrc"
    copy.mkdir()
    for f in _build.CSRC.iterdir():
        (copy / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def _edit_source(csrc, monkeypatch, stem):
    with open(csrc / f"{stem}.cu", "a") as f:
        f.write("\n// edited\n")


def _edit_header(csrc, monkeypatch, stem):
    with open(csrc / "mixture_lse.cuh", "a") as f:
        f.write("\n// edited\n")


def _add_header(csrc, monkeypatch, stem):
    (csrc / "extra.cuh").write_text("#pragma once\n")


def _change_flags(csrc, monkeypatch, stem):
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))


@pytest.mark.parametrize("stem", sorted(_build._SIGNATURES))
@pytest.mark.parametrize("edit", [_edit_source, _edit_header, _add_header, _change_flags],
                         ids=["source", "header", "new_header", "flags"])
def test_library_name_follows_what_the_build_reads(csrc, monkeypatch, stem, edit):
    src, before = _build._target(stem)
    assert src == csrc / f"{stem}.cu"
    assert before.name.startswith(f"lib{stem}_") and before.suffix == ".so"
    assert _build._target(stem)[1] == before  # stable while nothing changes
    edit(csrc, monkeypatch, stem)
    assert _build._target(stem)[1] != before


def test_build_all_reads_back_the_kept_log(csrc, monkeypatch, tmp_path):
    """A library built earlier is not rebuilt; its compiler output (the
    registers and shared memory ``-Xptxas -v`` printed) comes from the log
    kept beside it."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.BUILD_DIR.mkdir()
    for stem in _build._SIGNATURES:
        _build._target(stem)[1].write_bytes(b"")
    kept = "ptxas info    : Used 40 registers, 10240 bytes smem"
    _build._target("ei_diff")[1].with_suffix(".log").write_text(kept)
    assert _build.build_all() == {"ei_diff": kept, "fused_sample_ei": "", "q_mass": ""}
