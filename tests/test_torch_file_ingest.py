"""``pca --input-path``: the port's driver over an on-disk cohort against the
JAX package's driver over the same directory.

One seeded cohort (64 samples, 800 common variants, 3 populations) is
dumped once; both drivers read it through their own ``JsonlSource`` and CSR
sidecar, in 9 shards. In ``sparse``, ``auto``, ``fused`` and ``stream`` G
must be bit-identical to the JAX driver's and to the port's own
fixture-source run, coordinates within 1e-4 (the reference's parity bar);
``sketch`` within 1e-4 of the JAX sketch driver and within the reference's
top-k bar of the exact route. Cohort restriction gives the unrestricted
G's submatrix bit for bit, whatever the order of the sample list;
``--ingest-order`` and ``--ingest-workers`` never change G.
"""

import contextlib
import io
import os
import shutil

import numpy as np
import pytest
import torch

from spark_examples_tpu.genomics.sources import JsonlSource as JaxJsonl
from spark_examples_tpu.models.pca import VariantsPcaDriver as JaxDriver
from spark_examples_tpu.utils.config import PcaConfig as JaxConfig
from spark_examples_tpu_torch.cli import main as cli
from spark_examples_tpu_torch.genomics.fixtures import (
    DEFAULT_VARIANT_SET_ID,
    synthetic_cohort,
)
from spark_examples_tpu_torch.genomics.sources import (
    SIDECAR_BASENAME,
    JsonlSource,
)
from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
from spark_examples_tpu_torch.ops.sketch import (
    SKETCH_TOPK_ATOL,
    SketchPanel,
)
from spark_examples_tpu_torch.ops.sparse import window_route
from spark_examples_tpu_torch.utils.config import PcaConfig

N, V = 64, 800
COHORT = dict(seed=3, population_structure=3)
SETTINGS = dict(
    variant_set_ids=[DEFAULT_VARIANT_SET_ID],
    block_variants=64,
    sparse_density_threshold=0.6,
    bases_per_partition=10_000,
)
EXACT_MODES = ("sparse", "auto", "fused", "stream")
COORD_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def cohort_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cohort"))
    synthetic_cohort(N, V, **COHORT).dump(root)
    return root


def _quiet(fn):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        value = fn()
    return value, out.getvalue()


def _port(root, mode="auto", source=None, **kw):
    conf = PcaConfig(device="cpu", pca_mode=mode, **{**SETTINGS, **kw})
    driver = VariantsPcaDriver(conf, source or JsonlSource(root))
    result, out = _quiet(driver.run)
    return driver, result, out


_JAX = {}


def _jax(root, mode):
    """The JAX driver's G (or panel) and result over ``root``, once per
    mode."""
    if mode not in _JAX:
        conf = JaxConfig(pca_mode=mode, **SETTINGS)
        driver = JaxDriver(conf, JaxJsonl(root))
        result, out = _quiet(driver.run)
        g, _ = _quiet(JaxDriver(conf, JaxJsonl(root)).ingest_gramian)
        _JAX[mode] = (g, result, out)
    return _JAX[mode]


def _coords(result):
    return np.array([[pc1, pc2] for _, pc1, pc2 in result])


def _g(driver):
    g = driver.g
    return g.y if isinstance(g, SketchPanel) else g.numpy()


def _nonzero(out):
    return [line for line in out.splitlines() if "Non zero rows" in line]


@pytest.mark.parametrize("mode", EXACT_MODES)
def test_input_path_matches_the_jax_driver(cohort_dir, mode):
    driver, result, out = _port(cohort_dir, mode)
    want_g, want, want_out = _jax(cohort_dir, mode)
    assert np.array_equal(driver.g.numpy(), np.asarray(want_g))
    assert [r[0] for r in result] == [r[0] for r in want]
    assert np.abs(_coords(result) - _coords(want)).max() <= COORD_TOL
    assert _nonzero(out) and _nonzero(out) == _nonzero(want_out)
    assert os.path.exists(os.path.join(cohort_dir, SIDECAR_BASENAME))


@pytest.mark.parametrize("mode", EXACT_MODES + ("sketch",))
def test_input_path_equals_the_fixture_source_run(cohort_dir, mode):
    disk, disk_result, _ = _port(cohort_dir, mode)
    mem, mem_result, _ = _port(
        cohort_dir, mode, source=synthetic_cohort(N, V, **COHORT)
    )
    assert np.array_equal(_g(disk), _g(mem))
    assert disk_result == mem_result


@pytest.mark.parametrize("power_iters", [0, 2])
def test_sketch_over_input_path_matches_the_jax_sketch_driver(
    cohort_dir, power_iters
):
    driver, result, out = _port(
        cohort_dir, "sketch", sketch_power_iters=power_iters
    )
    conf = JaxConfig(
        pca_mode="sketch", sketch_power_iters=power_iters, **SETTINGS
    )
    want, want_out = _quiet(
        JaxDriver(conf, JaxJsonl(cohort_dir)).run
    )
    assert isinstance(driver.g, SketchPanel)
    assert np.abs(_coords(result) - _coords(want)).max() <= COORD_TOL
    assert _nonzero(out) == _nonzero(want_out)
    if power_iters == 2:
        _, exact, _ = _port(cohort_dir, "stream")
        assert (
            np.abs(_coords(result) - _coords(exact)).max()
            <= SKETCH_TOPK_ATOL
        )


def test_sidecar_windows_equal_the_fixture_windows(cohort_dir):
    def windows(source):
        conf = PcaConfig(device="cpu", pca_mode="sparse", **SETTINGS)
        driver = VariantsPcaDriver(conf, source)
        return driver, list(driver._cohort_windows())

    disk, disk_windows = windows(JsonlSource(cohort_dir))
    mem, mem_windows = windows(synthetic_cohort(N, V, **COHORT))
    assert disk._fused_csr_possible() and not mem._fused_csr_possible()
    assert len(disk_windows) == len(mem_windows) == -(-V // 64)
    for (a_idx, a_lens), (b_idx, b_lens) in zip(disk_windows, mem_windows):
        assert np.array_equal(a_idx, b_idx) and np.array_equal(a_lens, b_lens)
    routes = {
        window_route(lens, N, SETTINGS["sparse_density_threshold"])
        for _, lens in disk_windows
    }
    assert routes == {"scatter", "dense"}


def _ids(root):
    src = JsonlSource(root)
    return [c.id for c in src.list_callsets(DEFAULT_VARIANT_SET_ID)]


RESTRICTIONS = {
    "samples": lambda ids: dict(samples=ids[5:45]),
    "exclude": lambda ids: dict(exclude_samples=ids[::3]),
    "both": lambda ids: dict(samples=ids[:50], exclude_samples=ids[10:20]),
}


@pytest.mark.parametrize("mode", ["auto", "sparse", "stream"])
@pytest.mark.parametrize("restriction", sorted(RESTRICTIONS))
def test_restriction_is_the_unrestricted_submatrix(
    cohort_dir, mode, restriction
):
    ids = _ids(cohort_dir)
    kw = RESTRICTIONS[restriction](ids)
    full, _, _ = _port(cohort_dir, mode)
    sub, result, out = _port(cohort_dir, mode, **kw)
    keep = set(kw.get("samples", ids)) - set(kw.get("exclude_samples", ()))
    rows = [full.index.indexes[c] for c in ids if c in keep]
    assert sub.cohort.size == len(rows) < full.index.size
    assert np.array_equal(
        sub.g.numpy(), full.g.numpy()[np.ix_(rows, rows)]
    )
    assert len(result) == len(rows)
    assert f"/ {len(rows)}." in _nonzero(out)[0]
    conf = JaxConfig(pca_mode=mode, **SETTINGS, **kw)
    want_g, _ = _quiet(
        JaxDriver(conf, JaxJsonl(cohort_dir)).ingest_gramian
    )
    assert np.array_equal(sub.g.numpy(), np.asarray(want_g))


@pytest.mark.parametrize("source", ["jsonl", "fixture"])
def test_restriction_ignores_the_order_of_the_sample_list(
    cohort_dir, source
):
    ids = _ids(cohort_dir)
    picked = ids[3:40]
    shuffled = list(np.random.default_rng(0).permutation(picked))

    def run(samples):
        src = (
            JsonlSource(cohort_dir)
            if source == "jsonl"
            else synthetic_cohort(N, V, **COHORT)
        )
        return _port(cohort_dir, "auto", source=src, samples=samples)

    a, a_result, _ = run(picked)
    b, b_result, _ = run(shuffled)
    assert np.array_equal(a.g.numpy(), b.g.numpy())
    assert a_result == b_result


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(samples=["nobody"]), "unknown sample"),
        (dict(exclude_samples=["nobody"]), "unknown sample"),
        (dict(samples=[]), "leaves no samples"),
        ("all-excluded", "leaves no samples"),
        (dict(samples=["x"], checkpoint_dir="/nonexistent"), "checkpoint"),
        (dict(samples=["x"], mesh_shape="data:2"), "meshless"),
    ],
)
def test_restriction_errors_are_loud(cohort_dir, kw, match):
    if kw == "all-excluded":
        kw = dict(exclude_samples=_ids(cohort_dir))
    conf = PcaConfig(device="cpu", **SETTINGS, **kw)
    with pytest.raises(ValueError, match=match):
        VariantsPcaDriver(conf, JsonlSource(cohort_dir))


def test_restrict_window_equals_the_jax_driver(cohort_dir):
    ids = _ids(cohort_dir)
    kw = dict(samples=ids[::2], exclude_samples=ids[:8:4])
    port = VariantsPcaDriver(
        PcaConfig(device="cpu", **SETTINGS, **kw), JsonlSource(cohort_dir)
    )
    jax = JaxDriver(JaxConfig(**SETTINGS, **kw), JaxJsonl(cohort_dir))
    rng = np.random.default_rng(1)
    lens = rng.integers(0, 9, size=50)
    idx = rng.integers(0, N, size=int(lens.sum()))
    for got, want in zip(
        port._restrict_window((idx, lens)), jax._restrict_window((idx, lens))
    ):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("order", ["manifest", "completion"])
@pytest.mark.parametrize("workers", [1, 4])
def test_ingest_order_and_workers_keep_g_bit_identical(
    cohort_dir, order, workers
):
    ref, ref_result, _ = _port(
        cohort_dir, "auto", ingest_order="manifest", ingest_workers=1
    )
    got, result, _ = _port(
        cohort_dir, "auto", ingest_order=order, ingest_workers=workers
    )
    assert np.array_equal(got.g.numpy(), ref.g.numpy())
    assert result == ref_result


@pytest.mark.parametrize("order", ["manifest", "completion"])
def test_completion_order_hands_shards_on_as_they_finish(
    cohort_dir, monkeypatch, order
):
    import threading

    src = JsonlSource(cohort_dir)
    release = threading.Event()

    def extract(vsid, shard, *a):
        # Under completion order the manifest's first shard is held until
        # the consumer has received another shard.
        if order == "completion" and shard.start == manifest[0].start:
            assert release.wait(10)
        return shard

    conf = PcaConfig(
        device="cpu", ingest_order=order, ingest_workers=4, **SETTINGS
    )
    driver = VariantsPcaDriver(conf, src)
    manifest = driver._manifest()
    monkeypatch.setattr(src, "stream_carrying_csr", extract)
    stream = driver.get_csr_fused()
    first = next(stream)
    release.set()
    arrived = [first] + list(stream)
    assert sorted(s.start for s in arrived) == [s.start for s in manifest]
    if order == "manifest":
        assert arrived == manifest
    else:
        assert first != manifest[0]


def test_ingest_order_is_validated(cohort_dir):
    conf = PcaConfig(device="cpu", ingest_order="fastest", **SETTINGS)
    with pytest.raises(ValueError, match="ingest_order"):
        VariantsPcaDriver(conf, JsonlSource(cohort_dir))


def test_staged_route_reads_records_through_the_line_index(cohort_dir):
    driver, result, out = _port(cohort_dir, "auto", debug_datasets=True)
    assert not driver._fused_ingest_possible()
    assert any(": (" in line and "ref=" in line for line in out.splitlines())
    fused, fused_result, _ = _port(cohort_dir, "auto")
    assert np.array_equal(driver.g.numpy(), fused.g.numpy())
    assert result == fused_result


def test_gzipped_cohort_matches_the_plain_one(cohort_dir, tmp_path):
    import gzip

    root = str(tmp_path / "gz")
    os.makedirs(root)
    shutil.copy(os.path.join(cohort_dir, "callsets.json"), root)
    with open(os.path.join(cohort_dir, "variants.jsonl"), "rb") as fin:
        with gzip.open(os.path.join(root, "variants.jsonl.gz"), "wb") as f:
            shutil.copyfileobj(fin, f)
    plain, plain_result, _ = _port(cohort_dir, "sparse")
    gz, gz_result, _ = _port(root, "sparse")
    assert np.array_equal(gz.g.numpy(), plain.g.numpy())
    assert gz_result == plain_result


def _cli(argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = cli.main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("mode", ["auto", "sparse"])
def test_cli_input_path_in_process(cohort_dir, mode):
    rc, out = _cli(
        [
            "pca", "--input-path", cohort_dir, "--device", "cpu",
            "--pca-mode", mode, "--block-variants", "64",
            "--sparse-density-threshold", "0.6",
            "--bases-per-partition", "10000",
        ]
    )
    assert rc == 0
    rows = [line.split("\t") for line in out.splitlines()
            if line.count("\t") == 3]
    _, result, _ = _port(cohort_dir, mode)
    driver_rows = sorted(
        (name, cid.split("-")[0], pc1, pc2)
        for (cid, pc1, pc2), name in zip(
            result,
            [VariantsPcaDriver(
                PcaConfig(device="cpu", **SETTINGS), JsonlSource(cohort_dir)
            ).index.names[r[0]] for r in result],
        )
    )
    assert [tuple(r[:2]) for r in rows] == [r[:2] for r in driver_rows]
    got = np.array([[float(r[2]), float(r[3])] for r in rows])
    want = np.array([[r[2], r[3]] for r in driver_rows])
    assert np.abs(got - want).max() == 0.0


def test_cli_samples_flag_restricts_the_cohort(cohort_dir):
    ids = _ids(cohort_dir)
    rc, out = _cli(
        [
            "pca", "--input-path", cohort_dir, "--device", "cpu",
            "--samples", ",".join(ids[:20]) + ",",
            "--exclude-samples", ids[0],
            "--bases-per-partition", "10000",
        ]
    )
    assert rc == 0
    assert sum(line.count("\t") == 3 for line in out.splitlines()) == 19
    assert "Non zero rows in matrix:" in out and "/ 19." in out


def test_cli_api_url_still_raises_naming_the_network_tier(cohort_dir,
                                                         monkeypatch):
    # Both network tiers are served now: the directory behind the port's
    # gRPC server gives the --input-path run's lines byte for byte.
    from spark_examples_tpu_torch.genomics.grpc_transport import (
        GrpcGenomicsServer,
    )

    monkeypatch.delenv("GENOMICS_APPLICATION_CREDENTIALS", raising=False)
    argv = ["pca", "--device", "cpu", "--bases-per-partition", "10000"]
    rc, want = _cli([*argv, "--input-path", cohort_dir])
    assert rc == 0
    server = GrpcGenomicsServer(JsonlSource(cohort_dir)).start()
    try:
        rc, got = _cli(
            [*argv, "--api-url", f"grpc://127.0.0.1:{server.port}"])
    finally:
        server.stop()
    assert rc == 0

    def results(out):
        return [line for line in out.splitlines() if line.count("\t") == 3]

    assert results(got) == results(want) and len(results(got)) == N


def test_cli_without_a_source_names_input_path():
    with pytest.raises(SystemExit, match="--input-path"):
        cli.main(["pca", "--device", "cpu"])
