"""The port's ``pca --pca-mode sparse`` end to end against the JAX package's.

Both drivers run the same seeded fixture on the CPU with a density
threshold that sends some windows to the scatter route and some to the
dense route. G must be bit-identical; coordinates within 1e-4 (the JAX
package's fused-vs-stream bar); the "Non zero rows" print identical; the
TSV identical in names, dataset column and line count.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from spark_examples_tpu.genomics.fixtures import (
    synthetic_cohort as jax_synthetic_cohort,
)
from spark_examples_tpu.models.pca import VariantsPcaDriver as JaxDriver
from spark_examples_tpu.utils.config import PcaConfig as JaxConfig
from spark_examples_tpu_torch.arrays.blocks import windows_from_calls
from spark_examples_tpu_torch.genomics.fixtures import (
    DEFAULT_VARIANT_SET_ID,
    synthetic_cohort,
)
from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
from spark_examples_tpu_torch.ops import scatter_kernel
from spark_examples_tpu_torch.ops.sparse import window_route
from spark_examples_tpu_torch.utils.config import PcaConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# 3 populations, common variants: a well-separated top-2 eigenbasis. With
# 64-variant windows and a 0.6 threshold, 4 windows scatter and 9 go dense.
N, V, SEED = 64, 800, 3
COHORT = dict(seed=SEED, population_structure=3)
SETTINGS = dict(
    variant_set_ids=[DEFAULT_VARIANT_SET_ID],
    pca_mode="sparse",
    block_variants=64,
    sparse_density_threshold=0.6,
)
FINISHES = {
    "fused": {},
    "dense-eigh": {"dense_eigh_limit": 8},
    "precise": {"precise": True},
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _run_port(tmp_path, capsys, **kw):
    conf = PcaConfig(
        device="cpu", output_path=str(tmp_path / "port"), **SETTINGS, **kw
    )
    driver = VariantsPcaDriver(conf, synthetic_cohort(N, V, **COHORT))
    result = driver.run()
    return driver, result, capsys.readouterr().out


def _run_jax(tmp_path, capsys, **kw):
    conf = JaxConfig(output_path=str(tmp_path / "jax"), **SETTINGS, **kw)
    driver = JaxDriver(conf, jax_synthetic_cohort(N, V, **COHORT))
    result = driver.run()
    out = capsys.readouterr().out
    g = JaxDriver(conf, jax_synthetic_cohort(N, V, **COHORT)).ingest_gramian()
    capsys.readouterr()
    return np.asarray(g), result, out


def _nonzero_line(out):
    return [line for line in out.splitlines() if "Non zero rows" in line]


def test_cohort_takes_both_routes():
    src = synthetic_cohort(N, V, **COHORT)
    conf = PcaConfig(device="cpu", **SETTINGS)
    driver = VariantsPcaDriver(conf, src)
    routes = [
        window_route(lens, N, conf.sparse_density_threshold)
        for _, lens in windows_from_calls(
            driver.get_calls_fused(), conf.block_variants
        )
    ]
    assert routes.count("scatter") == 4 and routes.count("dense") == 9


@pytest.mark.parametrize("finish", sorted(FINISHES))
def test_driver_matches_the_jax_driver(finish, tmp_path, capsys):
    kw = FINISHES[finish]
    driver, result, out = _run_port(tmp_path, capsys, **kw)
    want_g, want, want_out = _run_jax(tmp_path, capsys, **kw)

    assert driver.g.dtype == torch.float32
    np.testing.assert_array_equal(driver.g.numpy(), want_g)
    assert [r[0] for r in result] == [r[0] for r in want]
    got = np.array([r[1:] for r in result])
    ref = np.array([r[1:] for r in want])
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-4
    assert _nonzero_line(out) and _nonzero_line(out) == _nonzero_line(
        want_out
    )
    for line in ("Matrix size: 64", "# of variants read: 800"):
        assert line in out and line in want_out

    port_tsv = (tmp_path / "port-pca.tsv").read_text().splitlines()
    jax_tsv = (tmp_path / "jax-pca.tsv").read_text().splitlines()
    assert len(port_tsv) == len(jax_tsv) == N
    assert [(r.split("\t")[0], r.split("\t")[3]) for r in port_tsv] == [
        (r.split("\t")[0], r.split("\t")[3]) for r in jax_tsv
    ]
    port_rows = [l for l in out.splitlines() if l.count("\t") == 3]
    jax_rows = [l for l in want_out.splitlines() if l.count("\t") == 3]
    assert [r.split("\t")[:2] for r in port_rows] == [
        r.split("\t")[:2] for r in jax_rows
    ]


def test_debug_datasets_staged_path_gives_the_same_g(capsys):
    fused_driver = VariantsPcaDriver(
        PcaConfig(device="cpu", **SETTINGS), synthetic_cohort(N, V, **COHORT)
    )
    staged_driver = VariantsPcaDriver(
        PcaConfig(device="cpu", debug_datasets=True, **SETTINGS),
        synthetic_cohort(N, V, **COHORT),
    )
    np.testing.assert_array_equal(
        fused_driver.ingest_gramian().numpy(),
        staged_driver.ingest_gramian().numpy(),
    )
    assert "17: (" in capsys.readouterr().out  # the debug print


def test_cpu_run_launches_no_kernel(tmp_path, capsys):
    before = scatter_kernel.SCATTER_KERNEL_LAUNCHES
    _run_port(tmp_path, capsys)
    assert scatter_kernel.SCATTER_KERNEL_LAUNCHES == before


@pytest.mark.parametrize(
    "kw,match",
    [
        ({"pca_mode": "auto"}, "item 1"),
        ({"pca_mode": "fused"}, "item 1"),
        ({"pca_mode": "stream"}, "item 1"),
        ({"pca_mode": "sketch"}, "item 2"),
        ({"mesh_shape": "data:2"}, "item 5"),
        ({"checkpoint_dir": "/nonexistent"}, "item 6"),
        ({"variant_set_ids": ["a", "b"]}, "item 8"),
    ],
    ids=["auto", "fused", "stream", "sketch", "mesh", "checkpoint", "multi"],
)
def test_unported_options_raise_before_ingest(kw, match):
    settings = {**SETTINGS, **kw}
    with pytest.raises(NotImplementedError, match=match):
        VariantsPcaDriver(PcaConfig(device="cpu", **settings), None)


def test_driver_refuses_without_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VariantsPcaDriver(
            PcaConfig(**SETTINGS), synthetic_cohort(4, 4, **COHORT)
        )


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "spark_examples_tpu_torch.cli.main", "pca",
         *args],
        cwd=ROOT,
        capture_output=True,
        text=True,
        timeout=300,
    )


def test_cli_pca_on_the_cpu(tmp_path):
    out = _cli(
        "--fixture-samples", "48", "--fixture-variants", "300",
        "--pca-mode", "sparse", "--sparse-density-threshold", "0.6",
        "--block-variants", "64", "--device", "cpu",
        "--output-path", str(tmp_path / "cli"),
    )
    assert out.returncode == 0, out.stderr
    assert "Non zero rows in matrix: 48 / 48." in out.stdout
    assert sum(l.count("\t") == 3 for l in out.stdout.splitlines()) == 48
    assert len((tmp_path / "cli-pca.tsv").read_text().splitlines()) == 48


def test_cli_refuses_unported_sources():
    out = _cli("--api-url", "http://localhost:1", "--device", "cpu",
               "--pca-mode", "sparse")
    assert out.returncode != 0
    assert "NotImplementedError" in out.stderr and "item 8" in out.stderr
