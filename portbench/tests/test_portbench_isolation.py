"""Nothing under ``portbench/`` imports JAX or the JAX package, and the
plain reference (``reference/``, the configurations' objectives) imports
nothing of the program either; names are compared by their whole
top-level part, since the port's name begins with the JAX package's."""

import ast

import pytest

from conftest import BENCH

JAX = {"jax", "jaxlib", "flax", "hyperopt_tpu"}
PROGRAM = "hyperopt_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & JAX


@pytest.mark.parametrize("path", [p for p in SOURCES if p.parent.name in ("reference", "configs")],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_the_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in set(_imports(path))


def test_the_run_compares_whole_top_level_names():
    import run

    mods = ["hyperopt_tpu_torch", "hyperopt_tpu_torch.algos.tpe", "jaxtyping", "flaxen"]
    assert not {m.split(".")[0] for m in mods} & run.FORBIDDEN
    assert {"jax.numpy".split(".")[0], "hyperopt_tpu.fmin".split(".")[0]} <= run.FORBIDDEN
