"""The port's meshed ``pca`` driver, CLI, engine and bridge against the
JAX package's on the same mesh shape.

The port's mesh repeats the CPU device; the JAX package's takes the 8
virtual CPU devices (``tests/conftest.py``). On the same seeded cohorts:

- the driver in ``auto``, ``stream`` and ``sparse``, with and without
  ``--sample-sharded``, on ``data:4,model:2``: G (a tile grid) is
  bit-identical to the JAX driver's and to the meshless G; the route
  (sparse or dense) is the JAX driver's; coordinates are within 1e-4 of
  the JAX driver's and of the host float64 oracle;
- the CLI (``pca --device cpu --mesh-shape data:4,model:2``) prints the
  JAX CLI's rows within 1e-4;
- what a mesh refuses (``fused``, a restricted cohort) and what runs now:
  the sketch under a mesh, forced or by ``auto``'s flip, and a checkpoint
  in a multi-process run (each rank's ``host-<p>`` snapshot), held to the
  JAX driver;
- checkpointed ingest on a mesh resumes bit for bit;
- a meshed analysis-engine job and a meshed bridge call give the meshless
  and the JAX package's rows within 1e-4.
"""

import numpy as np
import pytest
import torch

from spark_examples_tpu.bridge import TpuPcaBackend
from spark_examples_tpu.cli import main as jax_cli
from spark_examples_tpu.genomics.fixtures import (
    synthetic_cohort as jax_synthetic_cohort,
)
from spark_examples_tpu.models.pca import VariantsPcaDriver as JaxDriver
from spark_examples_tpu.parallel import make_mesh as jax_make_mesh
from spark_examples_tpu.serving import AnalysisEngine as JaxEngine
from spark_examples_tpu.utils.config import PcaConfig as JaxConfig
from spark_examples_tpu_torch.bridge import TorchPcaBackend
from spark_examples_tpu_torch.cli import main as cli
from spark_examples_tpu_torch.genomics.fixtures import (
    DEFAULT_VARIANT_SET_ID,
    synthetic_cohort,
)
from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
from spark_examples_tpu_torch.obs import get_registry
from spark_examples_tpu_torch.ops.pcoa import (
    mllib_principal_components_reference,
)
from spark_examples_tpu_torch.parallel import (
    ShardedGramian,
    distributed,
    make_mesh,
)
from spark_examples_tpu_torch.serving import AnalysisEngine
from spark_examples_tpu_torch.utils.config import PcaConfig

SPEC = "data:4,model:2"
# 3 populations, common variants: a well-separated top-2 eigenbasis; with
# 64-variant windows and a 0.6 threshold, some windows scatter and some go
# dense (tests/test_torch_pca_pipeline.py's cohort).
N, V = 64, 800
COHORT = dict(seed=3, population_structure=3)
SETTINGS = dict(
    variant_set_ids=[DEFAULT_VARIANT_SET_ID],
    block_variants=64,
    sparse_density_threshold=0.6,
)
COORD_TOL = 1e-4
CLI_ARGS = ["pca", "--fixture-samples", "24", "--fixture-variants", "300",
            "--fixture-seed", "5", "--bases-per-partition", "20000",
            "--block-variants", "32", "--mesh-shape", SPEC]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _coords(result):
    return np.array([r[1:] for r in result])


@pytest.fixture(scope="module")
def meshless():
    driver = VariantsPcaDriver(
        PcaConfig(device="cpu", pca_mode="stream", **SETTINGS),
        synthetic_cohort(N, V, **COHORT),
    )
    result = driver.run()
    g = driver.g.numpy()
    oracle, _ = mllib_principal_components_reference(g, 2)
    return g, result, oracle


@pytest.mark.parametrize("sharded", [None, True, False],
                         ids=["auto-shard", "sample-sharded", "replicated"])
@pytest.mark.parametrize("mode", ["auto", "stream", "sparse"])
def test_meshed_driver_matches_the_jax_driver(mode, sharded, meshless,
                                              capsys):
    g_ref, plain_result, oracle = meshless
    kw = dict(pca_mode=mode, sample_sharded=sharded, **SETTINGS)
    port = VariantsPcaDriver(
        PcaConfig(device="cpu", **kw), synthetic_cohort(N, V, **COHORT),
        mesh=make_mesh(SPEC, device="cpu"),
    )
    result = port.run()
    jmesh = jax_make_mesh(SPEC)
    jax_driver = JaxDriver(JaxConfig(**kw), jax_synthetic_cohort(N, V, **COHORT),
                           mesh=jmesh)
    jax_result = jax_driver.run()
    jax_g = JaxDriver(JaxConfig(**kw), jax_synthetic_cohort(N, V, **COHORT),
                      mesh=jmesh).ingest_gramian()
    capsys.readouterr()
    assert port._sparse_selected() == jax_driver._sparse_selected()
    assert port._sparse_selected() == (
        mode == "sparse" or (mode == "auto" and bool(sharded)))
    assert isinstance(port.g, ShardedGramian)
    g = port.g.full().numpy()
    np.testing.assert_array_equal(g, np.asarray(jax_g))
    np.testing.assert_array_equal(g, g_ref)
    assert [r[0] for r in result] == [r[0] for r in jax_result]
    assert np.abs(_coords(result) - _coords(jax_result)).max() <= COORD_TOL
    assert np.abs(_coords(result) - oracle).max() <= COORD_TOL
    assert np.abs(_coords(result) - _coords(plain_result)).max() <= COORD_TOL


@pytest.mark.parametrize("mode", ["stream", "sparse"])
def test_an_on_disk_cohort_on_a_mesh(mode, meshless, tmp_path, capsys):
    """The CSR sidecar tier feeds a mesh its bit-packed blocks (rows padded
    to the tile grid as zero bytes) or its windows: G bit-identical."""
    from spark_examples_tpu_torch.genomics.sources import JsonlSource

    g_ref, _, oracle = meshless
    synthetic_cohort(N, V, **COHORT).dump(str(tmp_path))
    driver = VariantsPcaDriver(
        PcaConfig(device="cpu", pca_mode=mode, **SETTINGS),
        JsonlSource(str(tmp_path)), mesh=make_mesh("data:3", device="cpu"),
    )
    assert driver._fused_csr_possible()
    result = driver.run()
    capsys.readouterr()
    assert driver.g.n_padded == 66
    np.testing.assert_array_equal(driver.g.full().numpy(), g_ref)
    assert np.abs(_coords(result) - oracle).max() <= COORD_TOL


def test_meshed_randomized_finish_meets_the_bar(meshless, capsys):
    """Above ``--dense-eigh-limit`` a meshed run finishes by randomized
    subspace iteration on the tiles, noted in the stage report."""
    _, _, oracle = meshless
    port = VariantsPcaDriver(
        PcaConfig(device="cpu", pca_mode="stream", dense_eigh_limit=8,
                  eig_tol=1e-7, **SETTINGS),
        synthetic_cohort(N, V, **COHORT), mesh=make_mesh(SPEC, device="cpu"),
    )
    result = port.run()
    assert "randomized eig:" in capsys.readouterr().out
    assert np.abs(_coords(result) - oracle).max() <= COORD_TOL


def _tsv_rows(out):
    return [line.split("\t") for line in out.splitlines()
            if line.count("\t") == 3]


@pytest.mark.parametrize(
    "extra",
    [["--pca-mode", "auto"], ["--pca-mode", "auto", "--sample-sharded"],
     ["--pca-mode", "stream", "--no-sample-sharded"],
     ["--pca-mode", "sparse", "--sparse-density-threshold", "0.5"]],
    ids=["auto", "auto-sample-sharded", "stream", "sparse"],
)
def test_cli_mesh_prints_the_jax_clis_rows(extra, capsys):
    assert cli.main([*CLI_ARGS, *extra, "--device", "cpu"]) == 0
    port = _tsv_rows(capsys.readouterr().out)
    assert jax_cli.main([*CLI_ARGS, *extra]) == 0
    jax = _tsv_rows(capsys.readouterr().out)
    assert len(port) == 24
    assert [(r[0], r[1]) for r in port] == [(r[0], r[1]) for r in jax]
    for a, b in zip(port, jax):
        assert abs(float(a[2]) - float(b[2])) <= COORD_TOL
        assert abs(float(a[3]) - float(b[3])) <= COORD_TOL


def test_the_mesh_flags_keep_the_jax_names_and_defaults():
    for argv in (["pca"], ["serve-cohort"], ["pca-bridge"]):
        port = vars(cli.build_parser().parse_args(argv))
        jax = vars(jax_cli.build_parser().parse_args(argv))
        for name in ("mesh_shape", "sample_sharded", "sample_shard_threshold",
                     "collective_timeout", "num_reduce_partitions"):
            assert port[name] == jax[name], (argv, name)
    args = cli.build_parser().parse_args(
        ["pca", "--sample-sharded", "--collective-timeout", "30",
         "--num-reduce-partitions", "4"])
    assert (args.sample_sharded, args.collective_timeout,
            args.num_reduce_partitions) == (True, 30.0, 4)


@pytest.mark.parametrize(
    "kw,error,match",
    [
        (dict(pca_mode="sketch"), None, None),
        (dict(pca_mode="fused"), ValueError, "fused requires"),
        (dict(samples=["x"]), ValueError, "meshless"),
    ],
    ids=["sketch", "fused", "restricted"],
)
def test_what_a_mesh_refuses_before_ingest(kw, error, match):
    """``fused`` and a restricted cohort are refused on a mesh; the sketch
    (``error`` None) runs, its rows within 1e-4 of the JAX driver's on its
    mesh of the same shape."""
    conf = PcaConfig(device="cpu", **{**SETTINGS, **kw})
    if error is not None:
        with pytest.raises(error, match=match):
            VariantsPcaDriver(conf, None, mesh=make_mesh(SPEC, device="cpu"))
        return
    rows = VariantsPcaDriver(
        conf, synthetic_cohort(N, V, **COHORT),
        mesh=make_mesh(SPEC, device="cpu"),
    ).run()
    jax_rows = JaxDriver(
        JaxConfig(**{**SETTINGS, **kw}), jax_synthetic_cohort(N, V, **COHORT),
        mesh=jax_make_mesh(SPEC),
    ).run()
    assert [r[0] for r in rows] == [r[0] for r in jax_rows]
    assert np.abs(_coords(rows) - _coords(jax_rows)).max() <= COORD_TOL


def test_auto_flipping_to_the_sketch_under_a_mesh_raises(monkeypatch):
    """``auto``'s flip past the G budget runs the sketch on the mesh (the
    JAX driver's flip, the same rows within 1e-4); the window route of
    the serving engine still serves meshless runs only."""
    monkeypatch.setattr(VariantsPcaDriver, "SKETCH_AUTO_G_BYTES", 0)
    monkeypatch.setattr(JaxDriver, "SKETCH_AUTO_G_BYTES", 0)
    driver = VariantsPcaDriver(
        PcaConfig(device="cpu", pca_mode="auto", **SETTINGS),
        synthetic_cohort(N, V, **COHORT), mesh=make_mesh(SPEC, device="cpu"),
    )
    assert driver.sketch_selected()
    rows = driver.run()
    assert driver.g.mesh is not None
    jax_rows = JaxDriver(
        JaxConfig(pca_mode="auto", **SETTINGS),
        jax_synthetic_cohort(N, V, **COHORT), mesh=jax_make_mesh(SPEC),
    ).run()
    assert np.abs(_coords(rows) - _coords(jax_rows)).max() <= COORD_TOL
    with pytest.raises(ValueError, match="meshless"):
        driver.ingest_gramian_windows()


def test_a_checkpoint_in_a_process_group_raises(monkeypatch, tmp_path):
    """A checkpoint in a process group runs: each rank snapshots its own
    manifest slice into ``host-<p>`` under the JAX driver's ``|host=p/P``
    digest, and the partials sum to the one-process G and the JAX
    package's (the group is simulated one rank at a time: the merge is
    recorded in place of the all-reduce). The JAX package's loader reads
    each rank's snapshot under the JAX digest."""
    from spark_examples_tpu.genomics.shards import (
        manifest_digest as jax_manifest_digest,
    )
    from spark_examples_tpu.utils.checkpoint import (
        load_snapshot as jax_load_snapshot,
    )

    settings = dict(SETTINGS, pca_mode="auto", checkpoint_every=2,
                    bases_per_partition=20_000)
    partials = []
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    monkeypatch.setattr(distributed, "allreduce_gramian",
                        lambda g: partials.append(g.clone()) or g)
    for rank in (0, 1):
        monkeypatch.setattr(distributed, "process_index", lambda r=rank: r)
        driver = VariantsPcaDriver(
            PcaConfig(device="cpu", checkpoint_dir=str(tmp_path), **settings),
            synthetic_cohort(N, V, **COHORT),
        )
        driver.ingest_gramian()
        shards = driver._manifest()
        digest = (f"{jax_manifest_digest(shards)}|{DEFAULT_VARIANT_SET_ID}"
                  f"|af=None|host={rank}/2")
        ck = jax_load_snapshot(str(tmp_path / f"host-{rank}"), digest, N)
        assert ck is not None and ck.shards_done == len(shards)
        np.testing.assert_array_equal(ck.g, partials[-1].numpy())
    monkeypatch.undo()
    g = (partials[0] + partials[1]).numpy()
    plain = dict(settings)
    del plain["checkpoint_every"]
    np.testing.assert_array_equal(g, VariantsPcaDriver(
        PcaConfig(device="cpu", **plain), synthetic_cohort(N, V, **COHORT)
    ).ingest_gramian().numpy())
    np.testing.assert_array_equal(g, np.asarray(JaxDriver(
        JaxConfig(**plain), jax_synthetic_cohort(N, V, **COHORT)
    ).ingest_gramian()))


def test_mesh_footprint_counts_every_tile():
    driver = VariantsPcaDriver(
        PcaConfig(device="cpu", **SETTINGS), synthetic_cohort(13, 20),
        mesh=make_mesh(SPEC, device="cpu"),
    )
    jax_driver = JaxDriver(JaxConfig(**SETTINGS), jax_synthetic_cohort(13, 20),
                           mesh=jax_make_mesh(SPEC))
    assert driver._sparse_host_g_bytes() == jax_driver._sparse_host_g_bytes()
    assert driver._sparse_host_g_bytes() == 16 * 16 * 4


def test_checkpointed_ingest_on_a_mesh_resumes(meshless, tmp_path, capsys):
    g_ref = meshless[0]
    kw = dict(pca_mode="auto", checkpoint_dir=str(tmp_path),
              checkpoint_every=2, bases_per_partition=20_000, **SETTINGS)

    def run():
        driver = VariantsPcaDriver(
            PcaConfig(device="cpu", **kw), synthetic_cohort(N, V, **COHORT),
            mesh=make_mesh(SPEC, device="cpu"),
        )
        return driver, driver.run()

    first, result = run()
    assert (tmp_path / "gramian_snapshot.npz").exists()
    again, result2 = run()
    assert "shards done." in capsys.readouterr().out
    for d in (first, again):
        assert isinstance(d.g, ShardedGramian)
        np.testing.assert_array_equal(d.g.full().numpy(), g_ref)
    assert result == result2


def test_merged_io_gauges_are_set(capsys):
    VariantsPcaDriver(
        PcaConfig(device="cpu", **SETTINGS), synthetic_cohort(13, 20),
        mesh=make_mesh("data:2", device="cpu"),
    ).run()
    capsys.readouterr()
    text = get_registry().to_prometheus()
    assert "genomics_io_merged_variants_read" in text


def test_a_meshed_engine_job_matches(meshless):
    _, plain_result, _ = meshless
    conf = PcaConfig(device="cpu", pca_mode="auto", **SETTINGS)
    engine = AnalysisEngine(
        synthetic_cohort(N, V, **COHORT), mesh=make_mesh(SPEC, device="cpu"),
        delta_max_samples=16, device="cpu",
    )
    assert engine.delta_stats() is None  # the delta tier is off on a mesh
    rows = engine.run(conf)
    jax_rows = JaxEngine(
        jax_synthetic_cohort(N, V, **COHORT), mesh=jax_make_mesh(SPEC),
    ).run(JaxConfig(pca_mode="auto", **SETTINGS))
    plain = VariantsPcaDriver(
        PcaConfig(device="cpu", **SETTINGS), synthetic_cohort(N, V, **COHORT)
    ).collect_result(plain_result)
    for other in (jax_rows, plain):
        assert [(r[0], r[3]) for r in rows] == [(r[0], r[3]) for r in other]
        np.testing.assert_allclose(
            np.array([r[1:3] for r in rows]),
            np.array([r[1:3] for r in other]), atol=COORD_TOL,
        )


def test_a_meshed_bridge_call_matches():
    rng = np.random.default_rng(2)
    groups = rng.integers(0, 3, size=40)
    af = rng.beta(0.4, 1.2, size=(3, 600))
    x = rng.random((40, 600)) < af[groups]
    calls = [list(np.nonzero(x[:, v])[0]) for v in range(600)]
    calls = [c for c in calls if c]
    got, vals = TorchPcaBackend(
        mesh=make_mesh(SPEC, device="cpu"), block_variants=128, device="cpu"
    ).compute(calls, 40, 2)
    plain, _ = TorchPcaBackend(block_variants=128, device="cpu").compute(
        calls, 40, 2)
    ref, _ = TpuPcaBackend(mesh=jax_make_mesh(SPEC),
                           block_variants=128).compute(calls, 40, 2)
    assert got.shape == (40, 2) and vals.shape == (2,)
    assert np.abs(got - plain).max() <= COORD_TOL
    assert np.abs(got - np.asarray(ref)).max() <= COORD_TOL
