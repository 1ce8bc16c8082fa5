"""The PyTorch port imports neither jax nor the JAX package.

Every module of ``spark_examples_tpu_torch`` is imported in a fresh
interpreter with ``jax`` blocked; no module of ``spark_examples_tpu`` may
load. The sources (and ``chip_smoke.py``) are also searched for imports of
either, so a lazy import inside a function cannot slip past.
"""

import os
import pkgutil
import re
import subprocess
import sys

import pytest

import spark_examples_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(spark_examples_tpu_torch.__file__)


def _port_modules():
    return sorted(
        m.name
        for m in pkgutil.walk_packages(
            [PKG_DIR], prefix="spark_examples_tpu_torch."
        )
    )


def _port_sources():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG_DIR):
        paths.extend(
            os.path.join(dirpath, f) for f in files if f.endswith(".py")
        )
    return sorted(paths)


def test_every_module_imports_without_jax():
    modules = _port_modules()
    assert "spark_examples_tpu_torch.ops.scatter_kernel" in modules
    assert "spark_examples_tpu_torch.models.pca" in modules
    script = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'spark_examples_tpu'\n"
        "             or m.startswith('spark_examples_tpu.')\n"
        "             or m == 'jax' and sys.modules[m] is not None)\n"
        "print('LOADED', bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", script],
        cwd=ROOT,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: os.path.relpath(p, ROOT)
)
def test_source_names_neither_jax_nor_the_jax_package(path):
    with open(path, encoding="utf-8") as f:
        text = f.read()
    assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M), path
    assert "spark_examples_tpu." not in text, path
