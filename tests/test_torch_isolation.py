"""The PyTorch port imports neither jax nor the JAX package.

Every module of ``spark_examples_tpu_torch`` is imported in a fresh
interpreter with ``jax`` blocked; no module of ``spark_examples_tpu`` may
load. The sources (and ``chip_smoke.py``) are also searched for imports of
either, so a lazy import inside a function cannot slip past. Every source
of the port, its ``csrc/`` too, is searched for the JAX package's native
library and its environment switches: the port builds and loads its own
host core and reads no environment variable for it. No source names the
JAX package's soft-deadline variable: the port reads its own. No source
names the JAX package's process-group variables: the port's process group
reads the standard ``torch.distributed`` launcher variables. No source
names the JAX package's collective-check variable: the pod's check reads
the port's own, and the pod modules import with jax blocked.
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


def _port_sources(exts=(".py",)):
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, dirs, files in os.walk(PKG_DIR):
        dirs[:] = [d for d in dirs if d not in ("_build", "__pycache__")]
        paths.extend(
            os.path.join(dirpath, f) for f in files if f.endswith(exts)
        )
    return sorted(paths)


def test_every_module_imports_without_jax():
    modules = _port_modules()
    for name in (
        "arrays.blocks",
        "arrays.feed",
        "bridge",
        "bridge.backend",
        "cli.main",
        "genomics.auth",
        "genomics.datasets",
        "genomics.fixtures",
        "genomics.grpc_transport",
        "genomics.hashing",
        "genomics.mirror",
        "genomics.oauth",
        "genomics.service",
        "genomics.sources",
        "genomics.wire",
        "models.pairhmm",
        "models.pca",
        "models.search_reads",
        "models.search_variants",
        "native",
        "obs",
        "obs.flightrec",
        "obs.manifest",
        "obs.metrics",
        "obs.session",
        "obs.tracer",
        "ops.delta",
        "ops.fused",
        "ops.gramian",
        "ops.pairhmm",
        "ops.reads_ops",
        "ops.scatter_kernel",
        "ops.sketch",
        "parallel",
        "parallel.distributed",
        "parallel.mesh",
        "parallel.podstream",
        "parallel.sharded",
        "resilience",
        "resilience.breaker",
        "resilience.faults",
        "resilience.policy",
        "serving",
        "serving.deltas",
        "serving.engine",
        "serving.jobs",
        "serving.journal_schema",
        "serving.queue",
        "serving.replica",
        "serving.tier",
        "store",
        "store.local",
        "tools.ingest_workers",
        "utils.checkpoint",
        "utils.collectivecheck",
        "utils.concurrency",
        "utils.elastic",
        "utils.lockcheck",
        "utils.softcancel",
        "utils.stats",
        "utils.tracing",
        "utils.watchdog",
    ):
        assert f"spark_examples_tpu_torch.{name}" in modules
    for path in ("genomics/grpc_transport.py", "genomics/mirror.py",
                 "native/__init__.py", "bridge/__init__.py",
                 "bridge/backend.py", "utils/checkpoint.py",
                 "utils/softcancel.py", "parallel/__init__.py",
                 "parallel/distributed.py", "parallel/mesh.py",
                 "parallel/podstream.py", "parallel/sharded.py",
                 "utils/collectivecheck.py", "utils/elastic.py"):
        assert os.path.join(PKG_DIR, *path.split("/")) in _port_sources()
    assert os.path.join(PKG_DIR, "csrc", "genomics_native.cpp") in (
        _port_sources(_CSRC_EXTS)
    )
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


_CSRC_EXTS = (".py", ".cu", ".cpp")
# The JAX package's native library, its loader's path and its environment
# switches (the library override, the kill switch, the parse threads).
_JAX_NATIVE_NAMES = (
    "spark_examples_tpu/native",
    "_genomics_native.so",
    "SPARK_EXAMPLES_TPU_NO_NATIVE",
    "SPARK_EXAMPLES_TPU_NATIVE_SO",
    "SPARK_EXAMPLES_TPU_PARSE_THREADS",
)


def test_the_native_loader_imports_with_jax_blocked():
    script = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from spark_examples_tpu_torch import native\n"
        "lib = native.load()\n"
        "assert lib.cohort_csr_abi_version() == native.COHORT_CSR_ABI\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'spark_examples_tpu'\n"
        "             or m.startswith('spark_examples_tpu.'))\n"
        "print('LOADED', bad, lib._name)\n"
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
    assert os.path.join("spark_examples_tpu_torch", "_build") in out.stdout


@pytest.mark.parametrize(
    "path", _port_sources(_CSRC_EXTS),
    ids=lambda p: os.path.relpath(p, ROOT),
)
def test_no_source_names_the_jax_packages_native_core(path):
    with open(path, encoding="utf-8") as f:
        text = f.read()
    for name in _JAX_NATIVE_NAMES:
        assert name not in text, (path, name)


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: os.path.relpath(p, ROOT)
)
def test_source_names_neither_jax_nor_the_jax_package(path):
    with open(path, encoding="utf-8") as f:
        text = f.read()
    assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M), path
    assert "spark_examples_tpu." not in text, path


# The JAX package's run-deadline variable (its utils/softcancel.py): a
# deadline exported for a JAX run must never cancel a port run.
_JAX_SOFT_DEADLINE = "SPARK_EXAMPLES_TPU" + "_SOFT_DEADLINE"


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: os.path.relpath(p, ROOT)
)
def test_no_source_names_the_jax_packages_soft_deadline(path):
    with open(path, encoding="utf-8") as f:
        assert _JAX_SOFT_DEADLINE not in f.read(), path


def test_the_soft_deadline_modules_import_with_jax_blocked():
    script = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from spark_examples_tpu_torch.utils import checkpoint, softcancel\n"
        "from spark_examples_tpu_torch import bridge\n"
        "assert softcancel.SOFT_DEADLINE_ENV == "
        "'SPARK_EXAMPLES_TPU_TORCH_SOFT_DEADLINE'\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'spark_examples_tpu'\n"
        "             or m.startswith('spark_examples_tpu.'))\n"
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


# The JAX package's process-group variables (its parallel/distributed.py):
# a coordinator exported for a JAX run must never pull a port run into a
# group.
_JAX_GROUP_VARIABLES = (
    "JAX_COORDINATOR_ADDRESS",
    "JAX_NUM_PROCESSES",
    "JAX_PROCESS_ID",
    "SPARK_EXAMPLES_TPU" + "_MULTIHOST",
)


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: os.path.relpath(p, ROOT)
)
def test_no_source_names_the_jax_packages_group_variables(path):
    with open(path, encoding="utf-8") as f:
        text = f.read()
    for name in _JAX_GROUP_VARIABLES:
        assert name not in text, (path, name)


def test_the_parallel_modules_import_with_jax_blocked():
    script = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from spark_examples_tpu_torch.parallel import (\n"
        "    distributed, make_mesh, mesh, sharded)\n"
        "m = make_mesh('data:2,model:2', device='cpu')\n"
        "assert m.shape == {'data': 2, 'model': 2}\n"
        "assert not distributed.initialize_from_env('cpu')\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'spark_examples_tpu'\n"
        "             or m.startswith('spark_examples_tpu.'))\n"
        "print('LOADED', bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "MASTER_ADDR"}
    out = subprocess.run(
        [sys.executable, "-c", script],
        cwd=ROOT,
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


# The JAX package's collective-check switch (its utils/collectivecheck.py):
# a check turned on for a JAX pod must never change a port pod's protocol.
_JAX_COLLECTIVE_CHECK = "SPARK_EXAMPLES_TPU" + "_COLLECTIVE_CHECK"


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: os.path.relpath(p, ROOT)
)
def test_no_source_names_the_jax_packages_collective_check(path):
    with open(path, encoding="utf-8") as f:
        assert _JAX_COLLECTIVE_CHECK not in f.read(), path


def test_the_pod_modules_import_with_jax_blocked():
    script = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from spark_examples_tpu_torch.parallel import podstream\n"
        "from spark_examples_tpu_torch.utils import collectivecheck\n"
        "assert collectivecheck.COLLECTIVE_CHECK_ENV == "
        "'SPARK_EXAMPLES_TPU_TORCH_COLLECTIVE_CHECK'\n"
        "assert podstream.PodWindowExchange.open() is None\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'spark_examples_tpu'\n"
        "             or m.startswith('spark_examples_tpu.'))\n"
        "print('LOADED', bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "MASTER_ADDR"}
    out = subprocess.run(
        [sys.executable, "-c", script],
        cwd=ROOT,
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_the_elastic_and_sketch_mesh_modules_import_with_jax_blocked():
    """The last slice's modules: the elastic lanes (the JAX package's
    ``utils/elastic.py`` copied, not imported) and the sketch's mesh half,
    with jax blocked and nothing of the JAX package loaded."""
    script = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from spark_examples_tpu_torch.utils import elastic\n"
        "from spark_examples_tpu_torch.parallel.sharded import (\n"
        "    sharded_sketch_finish, sharded_sketch_panel, sketch_tsqr)\n"
        "assert elastic.unit_ranges(5, 2) == [(0, 2), (2, 4), (4, 5)]\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'spark_examples_tpu'\n"
        "             or m.startswith('spark_examples_tpu.'))\n"
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
