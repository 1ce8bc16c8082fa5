"""The port's sharded Gramians and eig against the JAX package's.

The JAX mesh of the same shape comes from the 8 virtual CPU devices
(``tests/conftest.py``); the port's mesh repeats the CPU device. On the
same seeded inputs:

- ``sharded_gramian_blockwise`` (packed and unpacked) and
  ``sparse_sharded_gramian_blockwise`` give a G bit-identical to the JAX
  package's on the same mesh shape and to the port's meshless G, at
  ``data:1``, ``data:2``, ``data:4``, ``data:2,model:2`` and
  ``data:4,model:2``, at a divisible and a non-divisible N (13, 50);
- float blocks compute in float; a block of another dtype raises;
- the ring reduction equals the psum and the JAX package's;
- ``topk_eig_randomized`` / ``sharded_pcoa`` meet the randomized bar —
  coordinates within 1e-4 of dense ``eigh`` and of the JAX package's on
  the realistic spectra of ``tests/test_parallel.py`` (its starting panel
  is numpy-seeded, so the two packages agree to the bar, not bit for
  bit); ``tol=0`` with ``iters`` a chunk multiple equals the fixed path
  bit for bit; the spectral-gap warning fires as the JAX package's does
  (``tests/test_parallel.py:79-120, 189, 210-290, 314-384``).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from spark_examples_tpu.arrays.blocks import (
    restrict_window_to_sample_range as jax_restrict,
)
from spark_examples_tpu.ops import gramian as jax_gramian
from spark_examples_tpu.parallel import (
    SpectralGapWarning as JaxGapWarning,
    gramian_variant_parallel as jax_variant_parallel,
    gramian_variant_parallel_ring as jax_ring,
    make_mesh as jax_make_mesh,
    sample_bounds_of_indices as jax_bounds,
    sharded_gramian_blockwise as jax_sharded_blockwise,
    sharded_pcoa as jax_sharded_pcoa,
    sparse_sharded_gramian_blockwise as jax_sparse_sharded,
    topk_eig_randomized as jax_topk,
)
from spark_examples_tpu_torch import obs
from spark_examples_tpu_torch.arrays.blocks import (
    restrict_window_to_sample_range,
    windows_from_calls,
)
from spark_examples_tpu_torch.ops import scatter_kernel
from spark_examples_tpu_torch.ops.centering import double_center
from spark_examples_tpu_torch.ops.gramian import gramian_blockwise
from spark_examples_tpu_torch.ops.pcoa import principal_components
from spark_examples_tpu_torch.ops.sparse import (
    sparse_gramian_blockwise,
    window_route,
)
from spark_examples_tpu_torch.parallel import (
    ShardedGramian,
    SpectralGapWarning,
    addressable_sample_bounds,
    gramian_variant_parallel,
    gramian_variant_parallel_ring,
    make_mesh,
    sample_bounds_of_indices,
    sharded_gramian_blockwise,
    sharded_pcoa,
    sparse_sharded_gramian_blockwise,
    topk_eig_randomized,
)
from spark_examples_tpu_torch.parallel.sharded import _tile_operands
from spark_examples_tpu_torch.utils.tracing import StageTimer

SHAPES = ["data:1", "data:2", "data:4", "data:2,model:2", "data:4,model:2"]
SIZES = [13, 50]
V = 160
BLOCK = 48
THRESHOLD = 0.3
COORD_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cohort(n, seed=0):
    """(N, V) 0/1 int8 with rare variants (1–2 carriers: scatter windows
    at THRESHOLD) in the first half and common ones (dense windows) in
    the second."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, V), np.int8)
    for v in range(V // 2):
        x[rng.choice(n, size=rng.integers(1, 3), replace=False), v] = 1
    x[:, V // 2:] = rng.random((n, V - V // 2)) < 0.5
    return x


def _blocks(x):
    return [x[:, i:i + BLOCK] for i in range(0, x.shape[1], BLOCK)]


def _windows(x):
    calls = [np.nonzero(x[:, v])[0] for v in range(x.shape[1])]
    return list(windows_from_calls(iter(calls), BLOCK))


def _port_mesh(spec):
    return make_mesh(spec, device="cpu")


def _window_telemetry(run):
    """``run()``'s result with its window telemetry: the
    ``sparse_gramian_windows_total`` counts by route and the number of
    ``gramian.sparse.window`` spans."""
    with obs.telemetry_session() as session:
        out = run()
        counters = session.registry.snapshot()["counters"]
        events = session.tracer.to_chrome()["traceEvents"]
    counts = {k: v for k, v in counters.items()
              if k.startswith("sparse_gramian_windows_total") and v}
    spans = sum(e["name"] == "gramian.sparse.window" for e in events)
    return out, (counts, spans)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("spec", SHAPES)
@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_blockwise_is_the_jax_and_the_meshless_g(spec, n, packed):
    x = _cohort(n)
    got = sharded_gramian_blockwise(
        _blocks(x), n, _port_mesh(spec), packed=packed
    )
    assert isinstance(got, ShardedGramian) and got.shape == (n, n)
    ref = jax_sharded_blockwise(
        _blocks(x), n, jax_make_mesh(spec), packed=packed
    )
    meshless = gramian_blockwise(_blocks(x), n, packed=packed, device="cpu")
    np.testing.assert_array_equal(got.full().numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.full().numpy(), meshless.numpy())


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("spec", SHAPES)
def test_sparse_is_the_jax_and_the_meshless_g(spec, n):
    x = _cohort(n, seed=1)
    windows = _windows(x)
    routes = {window_route(lens, n, THRESHOLD) for _, lens in windows}
    assert routes == {"scatter", "dense"}
    mesh = _port_mesh(spec)
    before = scatter_kernel.SCATTER_KERNEL_LAUNCHES
    got, grid_windows = _window_telemetry(
        lambda: sparse_sharded_gramian_blockwise(
            iter(windows), n, mesh, density_threshold=THRESHOLD,
            block_variants=BLOCK,
        )
    )
    # CPU tiles take the plain version: no kernel launch.
    assert scatter_kernel.SCATTER_KERNEL_LAUNCHES == before
    ref = jax_sparse_sharded(
        iter(windows), n, jax_make_mesh(spec), density_threshold=THRESHOLD,
        block_variants=BLOCK,
    )
    meshless, meshless_windows = _window_telemetry(
        lambda: sparse_gramian_blockwise(
            iter(windows), n, density_threshold=THRESHOLD,
            block_variants=BLOCK, device="cpu",
        )
    )
    # One window step for both layouts: the same routes counted, the same
    # window spans, at least one window of each route.
    assert grid_windows == meshless_windows
    counts, spans = grid_windows
    assert spans == len(windows) == sum(counts.values())
    assert set(counts) == {
        f'sparse_gramian_windows_total{{route="{r}"}}'
        for r in ("scatter", "dense")
    }
    np.testing.assert_array_equal(got.full().numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.full().numpy(), meshless.numpy())
    np.testing.assert_array_equal(got.full().numpy(), x.astype(np.float32)
                                  @ x.T.astype(np.float32))


def test_tile_layout_is_the_jax_sharding():
    """Tile (i, j) holds the JAX shard of device (i, j): the padded N,
    the tile shape and every tile's contents."""
    n, spec = 13, "data:4,model:2"
    x = _cohort(n)
    got = sharded_gramian_blockwise(_blocks(x), n, _port_mesh(spec))
    assert (got.n_padded, got.tile_rows, got.tile_cols) == (16, 4, 8)
    padded = np.zeros((16, 16), np.float32)
    padded[:n, :n] = x.astype(np.float32) @ x.T.astype(np.float32)
    for (i, j), tile in np.ndenumerate(got.tiles):
        r0, c0 = got.tile_origin(i, j)
        np.testing.assert_array_equal(
            tile.numpy(), padded[r0:r0 + 4, c0:c0 + 8]
        )
    np.testing.assert_array_equal(
        got.row_sums().numpy(), padded[:n, :n].sum(axis=1)
    )
    again = ShardedGramian.from_full(got.full(), got.mesh)
    np.testing.assert_array_equal(again.full().numpy(), got.full().numpy())
    np.testing.assert_array_equal(
        again.add_(got).full().numpy(), 2 * padded[:n, :n]
    )


def test_float_blocks_compute_in_float():
    xb = np.full((8, 16), 0.5, np.float32)
    for spec in ("data:4,model:2", "data:1"):
        g = sharded_gramian_blockwise([xb], 8, _port_mesh(spec))
        np.testing.assert_array_equal(
            g.full().numpy(), np.full((8, 8), 4.0, np.float32)
        )
    ref = jax_sharded_blockwise([xb], 8, jax_make_mesh("data:4,model:2"))
    np.testing.assert_array_equal(g.full().numpy(), np.asarray(ref))


def test_a_block_of_another_dtype_raises():
    blocks = [np.ones((8, 4), np.int8), np.ones((8, 4), np.float32)]
    with pytest.raises(ValueError, match="dtype changed mid-stream"):
        sharded_gramian_blockwise(blocks, 8, _port_mesh("data:2"))


@pytest.mark.parametrize("spec", ["data:8", "data:4,model:2", "data:1"])
def test_ring_reduction_matches_psum(spec):
    rng = np.random.default_rng(21)
    x = (rng.random((16, 256)) < 0.3).astype(np.int8)
    mesh = _port_mesh(spec)
    ring = gramian_variant_parallel_ring(x, mesh).numpy()
    psum = gramian_variant_parallel(x, mesh).numpy()
    np.testing.assert_array_equal(ring, psum)
    np.testing.assert_array_equal(ring, x.astype(np.float32)
                                  @ x.T.astype(np.float32))
    jmesh = jax_make_mesh(spec)
    np.testing.assert_array_equal(
        ring, np.asarray(jax_ring(jnp.asarray(x), jmesh))
    )
    np.testing.assert_array_equal(
        psum, np.asarray(jax_variant_parallel(jnp.asarray(x), jmesh))
    )


def test_ring_canonicalizes_float_sums_to_device_0():
    """Float X: the ring's result is device 0's rotated-order sum
    (g_0 + g_7 + g_6 + … + g_1), not the psum's order."""
    rng = np.random.default_rng(21)
    xf = rng.random((16, 256)).astype(np.float32)
    mesh = _port_mesh("data:8")
    parts = [
        torch.from_numpy(xf[:, k * 32:(k + 1) * 32])
        @ torch.from_numpy(xf[:, k * 32:(k + 1) * 32]).T
        for k in range(8)
    ]
    want = parts[0]
    for k in range(7, 0, -1):
        want = want + parts[k]
    got = gramian_variant_parallel_ring(xf, mesh)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(
        got.numpy(), gramian_variant_parallel_ring(xf, mesh).numpy()
    )
    with pytest.raises(ValueError, match="do not divide"):
        gramian_variant_parallel(xf[:, :250], mesh)


def test_sample_bounds_and_window_restriction_are_the_jax_ones():
    slices = [(slice(0, 4), slice(8, 16)), (slice(4, 8), slice(None, 4))]
    assert sample_bounds_of_indices(slices, 16) == jax_bounds(slices, 16)
    assert sample_bounds_of_indices([], 16) == jax_bounds([], 16) == (0, 16)
    assert addressable_sample_bounds(_port_mesh("data:4,model:2"), 16) == (
        0, 16)
    rng = np.random.default_rng(3)
    lens = rng.integers(0, 5, size=40)
    idx = rng.integers(0, 50, size=int(lens.sum()))
    for lo, hi in ((0, 50), (10, 30), (0, 10), (45, 50)):
        for got, want in zip(restrict_window_to_sample_range(idx, lens, lo, hi),
                             jax_restrict(idx, lens, lo, hi)):
            np.testing.assert_array_equal(got, want)


def test_tile_operands_rebase_as_the_jax_tile_scatter():
    """``_tile_scatter``'s rule (JAX ``parallel/sharded.py:705-710``):
    in-tile indices shift to the tile's frame, the rest become the
    tile's row/column count."""
    idx = torch.tensor([[0, 3, 4, 9, 16], [7, 8, 12, 15, 16]],
                       dtype=torch.int32)
    li, lj = _tile_operands(idx, 4, 4, 8, 8)
    np.testing.assert_array_equal(
        li.numpy(), [[4, 4, 0, 4, 4], [3, 4, 4, 4, 4]])
    np.testing.assert_array_equal(
        lj.numpy(), [[8, 8, 8, 1, 8], [8, 0, 4, 7, 8]])
    assert li.dtype == lj.dtype == torch.int32


# -- the eig ----------------------------------------------------------------


def _structured_c(n=1024, v=8192, seed=0):
    """The realistic spectrum of ``tests/test_parallel.py``: a
    three-population cohort's centered Gramian."""
    rng = np.random.default_rng(seed)
    groups = rng.integers(0, 3, size=n)
    af = rng.beta(0.4, 1.2, size=(3, v))
    x = (rng.random((n, v)) < af[groups]).astype(np.float32)
    g = (x @ x.T).astype(np.float64)
    return (g - g.mean(axis=1, keepdims=True) - g.mean(axis=0, keepdims=True)
            + g.mean()).astype(np.float32)


@pytest.fixture(scope="module")
def structured_c():
    return _structured_c()


def _dense_coords(c, k=2):
    coords, _ = principal_components(torch.from_numpy(
        c.astype(np.float64)), k)
    return coords.numpy()


def test_randomized_meets_the_bar_on_a_realistic_spectrum(structured_c):
    c = structured_c
    exact = _dense_coords(c)
    got, vals = topk_eig_randomized(torch.from_numpy(c), 2, iters=15)
    ref, _ = jax_topk(jnp.asarray(c), 2, iters=15)
    assert got.shape == (1024, 2) and vals.shape == (2,)
    assert np.abs(got.numpy() - exact).max() < COORD_TOL
    assert np.abs(got.numpy() - np.asarray(ref)).max() < COORD_TOL


def test_randomized_on_a_tile_grid(structured_c):
    """The tile-wise ``C @ Q`` gives the whole matrix's result, on every
    grid shape, within the bar."""
    c = torch.from_numpy(structured_c[:512, :512].copy())
    exact = _dense_coords(structured_c[:512, :512])
    for spec in ("data:4,model:2", "data:2"):
        grid = ShardedGramian.from_full(c, _port_mesh(spec))
        got, _ = topk_eig_randomized(grid, 2, iters=20)
        assert np.abs(got.numpy() - exact).max() < COORD_TOL


def test_adaptive_tol_zero_is_the_fixed_path():
    c = torch.from_numpy(_structured_c(n=256, v=2048))
    fixed_v, fixed_w = topk_eig_randomized(c, 2, iters=20)
    adapt_v, adapt_w = topk_eig_randomized(
        c, 2, iters=20, tol=0.0, check_every=5
    )
    assert torch.equal(fixed_v, adapt_v)
    assert torch.equal(fixed_w, adapt_w)


def test_adaptive_converges_early_and_meets_the_bar(structured_c):
    exact = _dense_coords(structured_c)
    timer = StageTimer()
    got, _ = topk_eig_randomized(
        torch.from_numpy(structured_c), 2, iters=60, tol=1e-6, timer=timer
    )
    assert np.abs(got.numpy() - exact).max() < COORD_TOL
    notes = [n for ns in timer.notes.values() for n in ns
             if "randomized eig" in n]
    assert len(notes) == 1
    used = int(notes[0].split(":")[1].split("/")[0])
    assert used < 60


def test_sharded_pcoa_threads_eig_tol():
    rng = np.random.default_rng(3)
    groups = rng.integers(0, 3, size=96)
    af = rng.beta(0.4, 1.2, size=(3, 2048))
    x = (rng.random((96, 2048)) < af[groups]).astype(np.float32)
    g = torch.from_numpy(x @ x.T)
    mesh = _port_mesh("data:4,model:2")
    exact, _ = sharded_pcoa(g, 2, mesh, dense_eigh_limit=1024)
    approx, _ = sharded_pcoa(g, 2, mesh, dense_eigh_limit=8, eig_tol=1e-7)
    assert np.abs(approx - exact).max() < COORD_TOL
    ref, _ = jax_sharded_pcoa(
        jnp.asarray(g.numpy()), 2, jax_make_mesh("data:4,model:2"),
        dense_eigh_limit=8, eig_tol=1e-7,
    )
    assert np.abs(approx - np.asarray(ref)).max() < COORD_TOL


@pytest.fixture
def x_small():
    rng = np.random.default_rng(0)
    return (rng.random((32, 256)) < 0.3).astype(np.int8)


def test_sharded_pcoa_dense_path(x_small):
    mesh = _port_mesh("data:4,model:2")
    g = sharded_gramian_blockwise(_blocks(x_small), 32, mesh)
    coords, _ = sharded_pcoa(g, 2, mesh)
    golden, _ = principal_components(
        double_center(torch.from_numpy(x_small.astype(np.float32)
                                       @ x_small.T.astype(np.float32))), 2)
    np.testing.assert_allclose(coords, golden.numpy(), atol=COORD_TOL)
    jmesh = jax_make_mesh("data:4,model:2")
    ref, _ = jax_sharded_pcoa(
        jax_sharded_blockwise(_blocks(x_small), 32, jmesh), 2, jmesh
    )
    np.testing.assert_allclose(coords, np.asarray(ref), atol=COORD_TOL)


def test_sharded_pcoa_randomized_path(x_small):
    """A flat random spectrum: rotation-fragile by design, so 1e-2 on
    absolute values, as the JAX package's test compares."""
    mesh = _port_mesh("data:4,model:2")
    g = torch.from_numpy(np.array(jax_gramian(x_small)))
    coords, _ = sharded_pcoa(g, 2, mesh, dense_eigh_limit=8)
    golden, _ = principal_components(double_center(g), 2)
    np.testing.assert_allclose(
        np.abs(coords), np.abs(golden.numpy()), atol=1e-2
    )


def _matrix_with_spectrum(w, seed=3):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.random((len(w), len(w))))
    return torch.from_numpy(((q * w) @ q.T).astype(np.float32))


def test_degenerate_gap_warns():
    c = _matrix_with_spectrum(np.array([10.0, 5.0, 4.999] + [0.01] * 29))
    with pytest.warns(SpectralGapWarning, match=r"\|λ3\|/\|λ2\|"):
        topk_eig_randomized(c, 2, iters=40)


def test_separated_gap_is_silent_and_lands_in_the_report():
    c = _matrix_with_spectrum(np.array([10.0, 5.0, 1.0] + [0.01] * 29))
    timer = StageTimer()
    with warnings.catch_warnings():
        warnings.simplefilter("error", SpectralGapWarning)
        with timer.stage("pca"):
            topk_eig_randomized(c, 2, iters=40, timer=timer)
    assert "spectral gap" in timer.report()
    assert "0.2" in timer.notes["pca"][0]  # |λ3|/|λ2| = 1/5


def test_the_dense_branch_also_detects_degeneracy():
    rng = np.random.default_rng(3)
    a = rng.random((32, 32))
    a -= a.mean(axis=0, keepdims=True)  # columns ⊥ ones
    q, _ = np.linalg.qr(a)
    w = np.array([10.0, 5.0, 4.999] + [0.01] * 28)
    c = ((q[:, :31] * w) @ q[:, :31].T).astype(np.float32)
    mesh = _port_mesh("data:4,model:2")
    with pytest.warns(SpectralGapWarning):
        sharded_pcoa(ShardedGramian.from_full(c, mesh), 2, mesh)
    jmesh = jax_make_mesh("data:4,model:2")
    with pytest.warns(JaxGapWarning):
        jax_sharded_pcoa(
            jax.device_put(c, NamedSharding(jmesh, P("data", "model"))),
            2, jmesh,
        )
