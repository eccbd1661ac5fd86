"""The port's public surface is the JAX package's: every name in the
``__all__`` of every JAX-package module exists in the port's counterpart
module, or stands in ``NO_COUNTERPART`` with the reason (or the port name
that does its work).  The names ported for this check are held against
the live reference: ``utils``' host-only helpers of upstream hyperopt,
``fmin.PhaseTimings`` and ``fmin.partial``, ``megakernel.ei_diff_reference``
and ``megakernel.pallas_available``."""

import ast
import functools
import importlib
import os
import pathlib

import numpy as np
import pytest
import torch

import hyperopt_tpu
import hyperopt_tpu_torch
from hyperopt_tpu import megakernel as ref_megakernel, utils as ref_utils
from hyperopt_tpu_torch import megakernel, pallas_ei, utils

# the packages re-export the ``fmin`` function under the module's name
ref_fmin = importlib.import_module("hyperopt_tpu.fmin")
port_fmin = importlib.import_module("hyperopt_tpu_torch.fmin")

REF = pathlib.Path(hyperopt_tpu.__file__).resolve().parent

#: (port module, name) -> why the port has no such name, or which port name
#: does its work
NO_COUNTERPART = {
    ("hyperopt_tpu_torch._env", "forced_cpu_env"):
        "builds a child environment that pins JAX to its CPU platform; the port's "
        "processes take --device cpu / device='cpu'",
    ("hyperopt_tpu_torch._env", "enable_persistent_compilation_cache"):
        "XLA's persistent compile cache; the port compiles its two kernels with nvcc "
        "into _build's directory (_build.set_build_dir, fmin(compile_cache=))",
    ("hyperopt_tpu_torch._env", "parse_pallas"):
        "HYPEROPT_TPU_PALLAS picks Mosaic or the interpreter; _env.KNOBS lists the knob "
        "with no counterpart (a CUDA tensor launches the kernel)",
    ("hyperopt_tpu_torch.algos.tpe", "build_suggest_batched_wide"):
        "the widened cohort is the grouped cohort with the fused route off "
        "(build_suggest_batched(..., fused=False); tpe.widened_profile picks the spaces)",
    ("hyperopt_tpu_torch.algos.tpe", "cohort_key_wide"):
        "one positional program per widened profile shares a compile in XLA; the port "
        "keys widened cohorts with cohort_key(..., fused=False)",
    ("hyperopt_tpu_torch.algos.tpe", "widened_params"):
        "the runtime parameters of the positional slot layout, which exists only to "
        "share a compiled program; tpe.widened_profile",
    ("hyperopt_tpu_torch.algos.tpe", "build_propose_wide"):
        "the positional proposal step of the widened program; the port proposes a "
        "widened slot through the grouped step (tpe.widened_profile)",
    ("hyperopt_tpu_torch.algos.tpe", "jit_cache_stats"):
        "counts XLA's single-study jit programs; torch compiles none "
        "(tpe.cohort_cache_stats counts the cohort LRU)",
    ("hyperopt_tpu_torch.megakernel", "fallback_count"):
        "counts Mosaic lowerings that disarmed to jnp; the port never falls back (a CUDA "
        "tensor launches the kernel or raises)",
    ("hyperopt_tpu_torch.obs.health", "cost_analysis_summary"):
        "reads XLA's cost analysis; megakernel.ei_cost / fused_cost count the kernels' "
        "work analytically",
    ("hyperopt_tpu_torch.obs.health", "capture_jit_cost"):
        "records XLA's cost analysis of a jitted program; megakernel.ei_cost / fused_cost",
}


def _modules_with_all():
    """``(reference module, port module)`` for every JAX-package source that
    assigns ``__all__``."""
    out = []
    for path in sorted(REF.rglob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        if not any(isinstance(n, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in n.targets)
                for n in tree.body):
            continue
        parts = list(path.relative_to(REF).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append((".".join(["hyperopt_tpu", *parts]),
                    ".".join(["hyperopt_tpu_torch", *parts])))
    return out


MODULES = _modules_with_all()


def test_the_reference_exports_many_modules():
    assert len(MODULES) > 40
    assert ("hyperopt_tpu.utils", "hyperopt_tpu_torch.utils") in MODULES


@pytest.mark.parametrize("ref_name,port_name", MODULES, ids=[m[1] for m in MODULES])
def test_every_public_name_is_ported_or_listed(ref_name, port_name):
    ref_mod = importlib.import_module(ref_name)
    port_mod = importlib.import_module(port_name)
    missing = [n for n in ref_mod.__all__
               if not hasattr(port_mod, n) and (port_name, n) not in NO_COUNTERPART]
    assert not missing, f"{port_name} lacks {missing}"


def test_no_counterpart_rows_are_live():
    """Every row names a module of the port that really lacks the name and
    a name the reference really exports."""
    for (port_name, name), why in NO_COUNTERPART.items():
        assert why
        assert not hasattr(importlib.import_module(port_name), name), (port_name, name)
        ref_name = port_name.replace("hyperopt_tpu_torch", "hyperopt_tpu", 1)
        assert name in importlib.import_module(ref_name).__all__, (ref_name, name)


def test_import_tokens_and_json_call_match_the_reference():
    for tokens in (["math", "sqrt"], ["os", "path", "join"]):
        assert utils.import_tokens(tokens) is ref_utils.import_tokens(tokens)
    for spec, args, kwargs in (("math.sqrt", (9.0,), None), (("math.pow", [2.0, 3.0]), (), None),
                               (("builtins.dict", [], {"b": 2}), (), {"a": 1})):
        assert utils.json_call(spec, args, kwargs) == ref_utils.json_call(spec, args, kwargs)
    with pytest.raises(TypeError):
        utils.json_call(3)
    with pytest.raises(TypeError):
        ref_utils.json_call(3)


def test_get_most_recent_inds_and_fast_isin_match_the_reference():
    rng = np.random.default_rng(0)
    docs = [{"_id": int(i), "version": int(v)}
            for i, v in zip(rng.integers(0, 6, 40), rng.integers(0, 9, 40))]
    np.testing.assert_array_equal(utils.get_most_recent_inds(docs),
                                  ref_utils.get_most_recent_inds(docs))
    assert len(utils.get_most_recent_inds(docs[:1])) == 1
    X, Y = rng.integers(0, 20, 50), rng.integers(0, 20, 7)
    np.testing.assert_array_equal(utils.fast_isin(X, Y), ref_utils.fast_isin(X, Y))


def test_path_helpers_match_the_reference(tmp_path):
    (tmp_path / "a" / "b").mkdir(parents=True)
    for p in (str(tmp_path / "a" / "b" / "c" / "d"), "/", "rel/x/y", str(tmp_path)):
        assert utils.path_split_all(p) == ref_utils.path_split_all(p)
    target = str(tmp_path / "a" / "b" / "c" / "d")
    assert utils.get_closest_dir(target) == ref_utils.get_closest_dir(target)


@pytest.mark.parametrize("erase_after,with_sentinel", [(False, True), (True, True),
                                                       (True, False)])
def test_temp_dir_and_working_dir_match_the_reference(tmp_path, erase_after, with_sentinel):
    seen = {}
    for name, mod in (("port", utils), ("ref", ref_utils)):
        d = str(tmp_path / name / "t")
        with mod.temp_dir(d, erase_after=erase_after, with_sentinel=with_sentinel) as got:
            assert got == d
            seen[name] = sorted(os.listdir(d))
            cwd = os.getcwd()
            with mod.working_dir(d) as w:
                assert w == d and os.path.samefile(os.getcwd(), d)
            assert os.getcwd() == cwd
        seen[name + "_after"] = os.path.exists(d)
    assert seen["port"] == seen["ref"]
    assert seen["port_after"] == seen["ref_after"]


def test_fmin_phase_timings_and_partial_are_the_reference_names():
    assert port_fmin.partial is functools.partial is ref_fmin.partial
    assert port_fmin.PhaseTimings is hyperopt_tpu_torch.obs.PhaseTimings
    got, want = port_fmin.PhaseTimings(), ref_fmin.PhaseTimings()
    assert type(got).__name__ == type(want).__name__ and isinstance(got, dict)
    assert set(got) == set(want) and got == want


def test_ei_diff_reference_matches_the_reference():
    rng = np.random.default_rng(3)
    n, m = 33, 9
    x = rng.normal(size=n).astype(np.float32)
    tabs = [rng.uniform(0.0, 1.0, m), rng.normal(size=m), rng.uniform(0.2, 2.0, m),
            rng.uniform(0.0, 1.0, m), rng.normal(size=m), rng.uniform(0.2, 2.0, m)]
    tabs = [t.astype(np.float32) for t in tabs]
    tabs[0][2] = 0.0  # a dead component
    want = np.asarray(ref_megakernel.ei_diff_reference(x, *tabs))
    got = megakernel.ei_diff_reference(torch.from_numpy(x)[None],
                                       *[torch.from_numpy(t)[None] for t in tabs])
    np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-5, atol=1e-6)
    assert pallas_ei.ei_diff_reference is megakernel.ei_diff_reference


def test_pallas_available_answers_for_this_machine():
    # the JAX package answers whether Mosaic lowers (a TPU), the port whether
    # the CUDA kernel can launch (a card): on a box with neither, both say no
    assert pallas_ei.pallas_available is megakernel.pallas_available
    assert isinstance(megakernel.pallas_available(), bool)
    assert isinstance(ref_megakernel.pallas_available(), bool)
    if not torch.cuda.is_available():
        assert megakernel.pallas_available() is False
        assert ref_megakernel.pallas_available() is False
