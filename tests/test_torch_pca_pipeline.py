"""The port's ``pca`` driver end to end against the JAX package's.

``--pca-mode sparse``: both drivers run the same seeded fixture on the CPU
with a density threshold that sends some windows to the scatter route and
some to the dense route. ``auto``/``fused``/``stream``: both drivers take
the dense-blockwise route on the JAX package's fused-vs-stream cohort
(``tests/test_pca_pipeline.py::TestFusedPcaMode``). G must be
bit-identical; coordinates within 1e-4 (the JAX package's fused-vs-stream
bar); the "Non zero rows" print identical; the TSV identical in names,
dataset column and line count.
"""

import os
import subprocess
import sys
import warnings

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
from spark_examples_tpu_torch.models import pca as port_pca
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
        ({"mesh_shape": "data:2", "pca_mode": "sketch"}, "item 7"),
        ({"pca_mode": "auto", "checkpoint_dir": "/nonexistent",
          "elastic_checkpoint": True}, "item 8"),
    ],
    ids=["mesh", "checkpoint"],
)
def test_unported_options_raise_before_ingest(kw, match):
    """Options the port does not serve yet raise naming their item: of
    the mesh routes the sketch under a mesh (``--mesh-shape`` itself runs:
    ``tests/test_torch_parallel_pipeline.py``), and of the checkpoint
    options only ``--elastic-checkpoint`` (``--checkpoint-dir`` itself
    runs: ``test_checkpointed_driver_matches_the_jax_driver``)."""
    settings = {**SETTINGS, **kw}
    with pytest.raises(NotImplementedError, match=match):
        VariantsPcaDriver(PcaConfig(device="cpu", **settings), None)


@pytest.mark.parametrize("mode", ["auto", "fused", "stream"])
def test_checkpointed_driver_matches_the_jax_driver(mode, tmp_path, capsys):
    """``--checkpoint-dir`` runs: G bit-identical to the uncheckpointed
    run and to the JAX package's checkpointed run, coordinates within
    1e-4 of the JAX driver's."""
    settings = {**SETTINGS, "pca_mode": mode, "checkpoint_every": 2,
                "bases_per_partition": 20_000}
    port = VariantsPcaDriver(
        PcaConfig(device="cpu", checkpoint_dir=str(tmp_path / "p"),
                  **settings),
        synthetic_cohort(N, V, **COHORT),
    )
    result = port.run()
    plain = VariantsPcaDriver(
        PcaConfig(device="cpu", **settings),
        synthetic_cohort(N, V, **COHORT),
    )
    plain.run()
    jax_driver = JaxDriver(
        JaxConfig(checkpoint_dir=str(tmp_path / "j"), **settings),
        jax_synthetic_cohort(N, V, **COHORT),
    )
    jax_result = jax_driver.run()
    np.testing.assert_array_equal(port.g.numpy(), plain.g.numpy())
    np.testing.assert_array_equal(
        port.g.numpy(), np.asarray(jax_driver.ingest_gramian())
    )
    assert os.path.exists(tmp_path / "p" / "gramian_snapshot.npz")
    np.testing.assert_allclose(
        np.array([r[1:] for r in result]),
        np.array([r[1:] for r in jax_result]),
        atol=1e-4,
    )


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
    # grpc:// is served now: a dead endpoint fails loudly after its one
    # attempt, as the JAX CLI does, and names the transport's status.
    out = _cli("--api-url", "grpc://localhost:1", "--device", "cpu",
               "--pca-mode", "sparse", "--rpc-retries", "1")
    assert out.returncode != 0
    assert "NotImplementedError" not in out.stderr
    assert "ListCallsets: UNAVAILABLE" in out.stderr


# -- the dense-blockwise modes: auto, fused, stream --------------------------

# The JAX package's fused-vs-stream cohort: 2 populations, a clean top-2
# eigenbasis, 400 variants in 7 blocks of 64 (the last one ragged).
DENSE_N, DENSE_V = 48, 400
DENSE_COHORT = dict(population_structure=2, seed=3)
DENSE_SETTINGS = dict(
    variant_set_ids=[DEFAULT_VARIANT_SET_ID], block_variants=64
)
DENSE_MODES = ("auto", "fused", "stream")


def _dense_port(mode, **kw):
    conf = PcaConfig(device="cpu", pca_mode=mode, **DENSE_SETTINGS, **kw)
    return VariantsPcaDriver(
        conf, synthetic_cohort(DENSE_N, DENSE_V, **DENSE_COHORT)
    )


def _dense_jax(mode, **kw):
    conf = JaxConfig(pca_mode=mode, **DENSE_SETTINGS, **kw)
    return JaxDriver(
        conf, jax_synthetic_cohort(DENSE_N, DENSE_V, **DENSE_COHORT)
    )


def _coords(result):
    return np.array([r[1:] for r in result])


@pytest.mark.parametrize("mode", DENSE_MODES)
def test_dense_modes_match_the_jax_driver(mode, tmp_path, capsys):
    driver = _dense_port(mode, output_path=str(tmp_path / "port"))
    result = driver.run()
    out = capsys.readouterr().out
    jax_driver = _dense_jax(mode, output_path=str(tmp_path / "jax"))
    want = jax_driver.run()
    want_out = capsys.readouterr().out
    want_g = np.asarray(_dense_jax(mode).ingest_gramian())
    capsys.readouterr()

    assert not driver._sparse_selected()
    assert driver.g.dtype == torch.float32
    np.testing.assert_array_equal(driver.g.numpy(), want_g)
    assert [r[0] for r in result] == [r[0] for r in want]
    got = _coords(result)
    assert np.isfinite(got).all()
    assert np.abs(got - _coords(want)).max() <= 1e-4
    assert _nonzero_line(out) and _nonzero_line(out) == _nonzero_line(
        want_out
    )
    port_tsv = (tmp_path / "port-pca.tsv").read_text().splitlines()
    jax_tsv = (tmp_path / "jax-pca.tsv").read_text().splitlines()
    assert len(port_tsv) == len(jax_tsv) == DENSE_N
    assert [(r.split("\t")[0], r.split("\t")[3]) for r in port_tsv] == [
        (r.split("\t")[0], r.split("\t")[3]) for r in jax_tsv
    ]
    port_rows = [l for l in out.splitlines() if l.count("\t") == 3]
    jax_rows = [l for l in want_out.splitlines() if l.count("\t") == 3]
    assert sorted(r.split("\t")[0] for r in port_rows) == [
        r.split("\t")[0] for r in port_rows
    ]
    assert [r.split("\t")[:2] for r in port_rows] == [
        r.split("\t")[:2] for r in jax_rows
    ]


def test_fused_and_stream_agree(capsys):
    fused = _dense_port("fused").run()
    stream = _dense_port("stream").run()
    capsys.readouterr()
    assert [r[0] for r in fused] == [r[0] for r in stream]
    assert np.abs(_coords(fused) - _coords(stream)).max() <= 1e-4


# 8192 bases per shard cut the cohort's BRCA1 range into 10 shards, so
# four extraction threads really run in parallel.
MANY_SHARDS = dict(bases_per_partition=8192)


@pytest.mark.parametrize("depth", [1, 3])
def test_ingest_workers_and_depth_leave_g_unchanged(depth, capsys):
    serial = _dense_port("auto", ingest_workers=1).ingest_gramian()
    parallel_driver = _dense_port(
        "auto", ingest_workers=4, prefetch_depth=depth, **MANY_SHARDS
    )
    assert len(parallel_driver._manifest()) > 4
    parallel = parallel_driver.ingest_gramian()
    capsys.readouterr()
    np.testing.assert_array_equal(serial.numpy(), parallel.numpy())


@pytest.mark.parametrize(
    "kw", [{"ingest_workers": 1}, {"ingest_workers": 4},
           {"ingest_workers": 1, **MANY_SHARDS}],
    ids=["one-thread", "one-shard", "one-thread-many-shards"],
)
def test_one_extraction_thread_streams_each_shard(kw, capsys):
    """With one extraction thread the first carrier list reaches the
    block builder before its shard has been read to the end."""
    driver = _dense_port("auto", **kw)
    produced = []
    carrying = driver.source.stream_carrying

    def counted(*args, **kwargs):
        for calls in carrying(*args, **kwargs):
            produced.append(1)
            yield calls

    driver.source.stream_carrying = counted
    calls = driver.get_calls_fused()
    next(calls)
    assert len(produced) == 1
    rest = sum(1 for _ in calls)
    capsys.readouterr()
    assert 1 + rest == len(produced) > 1


def test_parallel_extraction_matches_the_jax_order(capsys):
    """Four threads over 10 shards yield the JAX driver's carrier lists
    in the same order."""
    port = _dense_port("auto", ingest_workers=4, **MANY_SHARDS)
    want = _dense_jax("auto", ingest_workers=4, **MANY_SHARDS)
    got_calls = [list(c) for c in port.get_calls_fused()]
    want_calls = [list(c) for c in want.get_calls_fused()]
    capsys.readouterr()
    assert got_calls == want_calls and len(got_calls) > 0


def test_ingest_workers_auto_is_cores_capped_at_16(monkeypatch):
    monkeypatch.setattr(os, "cpu_count", lambda: 64)
    assert _dense_port("auto")._ingest_workers() == 16
    monkeypatch.setattr(os, "cpu_count", lambda: 3)
    assert _dense_port("auto")._ingest_workers() == 3
    assert _dense_port("auto", ingest_workers=5)._ingest_workers() == 5


def test_fused_eligibility_routes_as_the_jax_driver(capsys):
    g = np.eye(4, dtype=np.float32)
    table = []
    for mode in ("auto", "fused", "stream", "sparse"):
        for precise in (False, True):
            if mode == "fused" and precise:
                continue  # refused before ingest, below
            for limit in (8, 8192):
                kw = dict(precise=precise, dense_eigh_limit=limit)
                got = _dense_port(mode, **kw)._pca_fused_eligible()
                want = _dense_jax(mode, **kw)._pca_fused_eligible(g)
                assert got == want, (mode, precise, limit)
                table.append(got)
    capsys.readouterr()
    assert True in table and False in table


@pytest.mark.parametrize(
    "kw,match",
    [
        ({"pca_mode": "fused", "precise": True}, "pca-mode fused"),
        ({"prefetch_depth": 0}, "prefetch-depth"),
        ({"ingest_workers": -1}, "ingest-workers"),
    ],
    ids=["fused-precise", "prefetch-depth-0", "ingest-workers-negative"],
)
def test_bad_dense_options_raise_before_ingest(kw, match):
    settings = {"pca_mode": "auto", **kw}
    with pytest.raises(ValueError, match=match):
        VariantsPcaDriver(PcaConfig(device="cpu", **DENSE_SETTINGS,
                                    **settings), None)
    with pytest.raises(ValueError, match=match):
        JaxDriver(JaxConfig(**DENSE_SETTINGS, **settings), None)


def _collapse(*args, **kwargs):
    raise FloatingPointError("fused eigendecomposition produced NaN")


def test_forced_fused_reraises_a_collapsed_finish(monkeypatch, capsys):
    monkeypatch.setattr(port_pca, "fused_finish", _collapse)
    with pytest.raises(FloatingPointError, match="NaN"):
        _dense_port("fused").run()
    capsys.readouterr()


def test_auto_falls_back_to_dense_eigh_on_a_collapsed_finish(
    monkeypatch, capsys
):
    stream = _dense_port("stream").run()
    monkeypatch.setattr(port_pca, "fused_finish", _collapse)
    with pytest.warns(UserWarning, match="falling back"):
        auto = _dense_port("auto").run()
    capsys.readouterr()
    np.testing.assert_array_equal(_coords(auto), _coords(stream))


def test_default_mode_is_auto_and_launches_no_scatter(capsys):
    driver = VariantsPcaDriver(
        PcaConfig(device="cpu", **DENSE_SETTINGS),
        synthetic_cohort(DENSE_N, DENSE_V, **DENSE_COHORT),
    )
    before = scatter_kernel.SCATTER_KERNEL_LAUNCHES
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        driver.run()
    out = capsys.readouterr().out
    assert driver.conf.pca_mode == "auto" and not driver._sparse_selected()
    assert scatter_kernel.SCATTER_KERNEL_LAUNCHES == before
    # The fused finish ran, and did not fall back to dense eigh.
    assert "fused eig residual" in out
    assert not [w for w in caught if "falling back" in str(w.message)]


def test_cli_default_command_on_the_cpu(tmp_path):
    out = _cli(
        "--fixture-samples", "48", "--fixture-variants", "300",
        "--block-variants", "64", "--device", "cpu",
        "--output-path", str(tmp_path / "cli"),
    )
    assert out.returncode == 0, out.stderr
    assert "Non zero rows in matrix: 48 / 48." in out.stdout
    assert "fused eig residual" in out.stdout  # the auto route's finish
    assert sum(l.count("\t") == 3 for l in out.stdout.splitlines()) == 48
    assert len((tmp_path / "cli-pca.tsv").read_text().splitlines()) == 48


# -- rank-deficient panels: p = N -------------------------------------------
#
# At N = 2 the double-centered G has rank 1 and the panel has p = N = 2
# columns. The JAX package's Cholesky returns NaN there, so its finish
# collapses: `auto` warns and falls back to dense eigh, forced `fused`
# raises. The port's jittered Cholesky factorizes the same panel, and the
# dropped direction comes back as a zero Ritz vector; the finish must call
# that a collapse too. At N = 3 and 5 the two packages may take different
# routes, but the coordinates must agree.


def _tiny_run(driver_cls, conf_cls, cohort_fn, n, v, seed, mode, **kw):
    conf = conf_cls(
        variant_set_ids=[DEFAULT_VARIANT_SET_ID], pca_mode=mode, **kw
    )
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        result = driver_cls(conf, cohort_fn(n, v, seed=seed)).run()
    fell_back = any("falling back" in str(w.message) for w in caught)
    return _coords(result), fell_back


@pytest.mark.parametrize(
    "n,v,seed", [(2, 50, 1), (3, 60, 1), (5, 60, 2)],
    ids=["n2", "n3", "n5"],
)
def test_rank_deficient_auto_matches_the_jax_driver(n, v, seed, capsys):
    got, port_fell_back = _tiny_run(
        VariantsPcaDriver, PcaConfig, synthetic_cohort, n, v, seed, "auto",
        device="cpu",
    )
    want, jax_fell_back = _tiny_run(
        JaxDriver, JaxConfig, jax_synthetic_cohort, n, v, seed, "auto"
    )
    capsys.readouterr()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-4
    if n == 2:
        # The reference collapses here; so must the port.
        assert jax_fell_back and port_fell_back


def test_rank_deficient_forced_fused_raises_as_the_jax_driver(capsys):
    with pytest.raises(FloatingPointError):
        _tiny_run(JaxDriver, JaxConfig, jax_synthetic_cohort, 2, 50, 1,
                  "fused")
    with pytest.raises(FloatingPointError, match="non-finite"):
        _tiny_run(VariantsPcaDriver, PcaConfig, synthetic_cohort, 2, 50, 1,
                  "fused", device="cpu")
    capsys.readouterr()
