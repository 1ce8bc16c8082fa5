"""No module of the benchmark imports JAX or the JAX package: each import's
top-level name (before the first dot) is compared whole, since the port's
name, ``spark_examples_tpu_torch``, begins with the JAX package's."""

import ast
import os

import pytest

from benchmark.tests.conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "spark_examples_tpu"}


def _modules():
    for dirpath, _, files in os.walk(BENCH):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_import(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    for name in ("reference.py", "check.py", "cohort.py", "roofline.py"):
        found = top_level_imports(os.path.join(BENCH, name))
        assert not found & (FORBIDDEN | {"spark_examples_tpu_torch"})


def test_run_refuses_a_process_with_jax_loaded(monkeypatch):
    import sys
    import types

    from benchmark import run

    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "spark_examples_tpu_torch_x",
                        types.ModuleType("spark_examples_tpu_torch_x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert run.forbidden_modules() == ["jax"]
