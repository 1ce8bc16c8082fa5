"""The implicitly centred tile grid: ``CenteredGramian`` applies C = H·G·H
to a panel from the tiles' ``G @ Q`` and G's row sums, and never forms C.

On a 2×2 mesh of CPU devices:

- C·Q equals ``ops/centering.double_center`` of the gathered G times Q to
  float32 rounding, at an odd N that is no multiple of 4 (padded rows),
  for panels of width 10 and 1, with the row sums read or passed in;
- ``sharded_pcoa`` leaves G's tiles bit for bit as they were, on its
  dense and its randomized route;
- a job over a ``ukb200k``-shaped cohort drawn by ``benchmark/cohort.py``
  (N = 3,001, the randomized route) gives coordinates within 1e-6 of the
  float64 matrix-free reference and G's row sums exactly;
- the grid's ``matmul`` (widths 10 and 1) and ``row_sums``, which launch
  every tile's work before gathering any result, equal bit for bit the
  loop that copies, computes and gathers one tile at a time (kept here as
  the reference), on the 2×2 grid and on a 1×4 grid, where the order of
  the additions shows; a grid on one device counts no overlapped product.

Marked ``card``: on the visible CUDA cards, over an N whose tile holds at
least 1 GB, ``sharded_pcoa`` allocates no tile-sized tensor beside G's
tiles (each card's peak stays under one tile plus 5 %); on two cards or
more, one centred product takes under 1.5 times one tile's GEMM (the
tiles multiply at the same time), equals the one-tile-at-a-time loop bit
for bit and counts one overlapped product. Run them on a host with cards:
``python -m pytest --noconftest -m card tests/test_torch_centered_tiles.py``.
"""

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from spark_examples_tpu_torch import obs
from spark_examples_tpu_torch.ops.centering import double_center
from spark_examples_tpu_torch.parallel import ShardedGramian, make_mesh
from spark_examples_tpu_torch.parallel.sharded import (
    CenteredGramian,
    sharded_pcoa,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

MESH = "data:2,model:2"
DENSE = 'sparse_gramian_windows_total{route="dense"}'
OVERLAPPED = "sharded_overlapped_products_total"


def _gramian(n, v=96, seed=0):
    """(n, n) float32 G = X·Xᵀ of a 0/1 X with three groups of samples."""
    rng = np.random.default_rng(seed)
    groups = rng.integers(0, 3, size=n)
    af = rng.beta(0.4, 1.2, size=(3, v))
    x = (rng.random((n, v)) < af[groups]).astype(np.float32)
    return torch.from_numpy(x @ x.T)


def _tiles(g):
    return [t.clone() for _, t in g.local_tiles()]


def _counter(name):
    return obs.get_registry().snapshot()["counters"].get(name, 0)


def _tile_by_tile_matmul(g, q):
    """``G @ q`` one tile at a time: copy the tile's slab, multiply,
    gather the result, then the next tile."""
    dev = q.device
    qp = torch.zeros((g.n_padded, q.shape[1]), dtype=q.dtype, device=dev)
    qp[: g.n] = q
    out = torch.zeros_like(qp)
    for (i, j), tile in g.local_tiles():
        r0, c0 = g.tile_origin(i, j)
        slab = qp[c0:c0 + g.tile_cols].to(tile.device)
        out[r0:r0 + g.tile_rows] += (tile @ slab).to(dev)
    return out[: g.n]


def _tile_by_tile_row_sums(g):
    sums = torch.zeros(g.n_padded, dtype=g.dtype, device=g.device)
    for (i, j), tile in g.local_tiles():
        r0, _ = g.tile_origin(i, j)
        sums[r0:r0 + g.tile_rows] += tile.sum(dim=1).to(sums.device)
    return sums[: g.n]


@pytest.mark.parametrize("spec", [MESH, "data:1,model:4"])
@pytest.mark.parametrize("op,width", [("matmul", 10), ("matmul", 1),
                                      ("row_sums", None)],
                         ids=["matmul-10", "matmul-1", "row_sums"])
def test_launching_every_tile_first_changes_no_bit(op, width, spec):
    n = 203  # odd, no multiple of 4: the grid pads it to 204
    g = _gramian(n)
    # Fractions: across the 1×4 grid's four tiles the order of the
    # additions shows in the bits.
    g += torch.from_numpy(np.random.default_rng(2).standard_normal(
        (n, n)).astype(np.float32))
    grid = ShardedGramian.from_full(g, make_mesh(spec, device="cpu"))
    before = _counter(OVERLAPPED)
    if op == "matmul":
        q = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (n, width)).astype(np.float32))
        got, want = grid.matmul(q), _tile_by_tile_matmul(grid, q)
    else:
        got, want = grid.row_sums(), _tile_by_tile_row_sums(grid)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert _counter(OVERLAPPED) == before


@pytest.mark.parametrize("width", [10, 1])
@pytest.mark.parametrize("passed", [False, True], ids=["read", "passed"])
def test_centred_product_is_the_dense_one(width, passed):
    n = 203  # odd, no multiple of 4: the grid pads it to 204
    g = _gramian(n)
    grid = ShardedGramian.from_full(g, make_mesh(MESH, device="cpu"))
    assert grid.n_padded == 204
    q = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (n, width)).astype(np.float32))
    op = CenteredGramian(grid, g.sum(dim=1) if passed else None)
    assert op.shape == (n, n) and op.dtype == torch.float32
    got = op.matmul(q)
    want = double_center(g).double() @ q.double()
    assert got.dtype == torch.float32 and got.shape == (n, width)
    scale = (g.double().abs() @ q.double().abs()).max()
    assert (got.double() - want).abs().max() <= 4 * n * 2.0**-24 * scale
    assert op.products == 1


@pytest.mark.parametrize("limit", [1024, 8], ids=["dense", "randomized"])
def test_sharded_pcoa_leaves_the_tiles_as_they_were(limit):
    n = 203
    g = ShardedGramian.from_full(_gramian(n), make_mesh(MESH, device="cpu"))
    before = _tiles(g)
    coords, vals = sharded_pcoa(g, 2, g.mesh, dense_eigh_limit=limit)
    assert coords.shape == (n, 2) and np.isfinite(coords).all()
    for was, (_, now) in zip(before, g.local_tiles()):
        assert torch.equal(was, now)


def _ukb200k_shaped(n=3001, sites=2048):
    """``ukb200k`` at n samples: its groups at their shares (largest
    remainder), carriers log-uniform on [1, 48], so that every site, and
    so every window, stays under the 0.02 density threshold and takes the
    tile scatter, as at the full N."""
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "ukb200k.json")) as f:
        cfg = json.load(f)
    sizes = np.array([p["size"] for p in cfg["populations"]], dtype=float)
    raw = sizes * n / sizes.sum()
    scaled = np.floor(raw).astype(int)
    scaled[np.argsort(scaled - raw)[:n - scaled.sum()]] += 1
    for p, size in zip(cfg["populations"], scaled):
        p["size"] = int(size)
    cfg["samples"], cfg["sites"] = n, sites
    cfg["carriers"]["max"] = 48
    return cfg


def test_a_ukb200k_shaped_job_meets_the_matrix_free_reference(tmp_path):
    from benchmark import cohort as cohort_mod
    from benchmark import jobs as jobs_mod
    from benchmark import reference
    from spark_examples_tpu_torch.cli.main import build_parser
    from spark_examples_tpu_torch.genomics.sources import JsonlSource
    from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
    from spark_examples_tpu_torch.utils.config import pca_config_from_args

    cfg = _ukb200k_shaped()
    with open(os.path.join(ROOT, "benchmark", "traffic", "mesh.json")) as f:
        mix = json.load(f)
    seed = 2**31 + 21
    cohort = cohort_mod.draw(cfg, mix, seed)
    root = str(tmp_path / "cohort")
    cohort_mod.write_jsonl(cohort, root, seed)
    (job,) = jobs_mod.plan(cfg, mix, cohort, root, seed, device="cpu")
    args = build_parser().parse_args(job.argv + ["--dense-eigh-limit",
                                                 "1024"])
    driver = VariantsPcaDriver(pca_config_from_args(args),
                               JsonlSource(args.input_path))
    dense_before = obs.get_registry().snapshot()["counters"].get(DENSE, 0)
    with contextlib.redirect_stdout(io.StringIO()):
        rows = driver.run()
    assert isinstance(driver.g, ShardedGramian)
    assert driver.g.tiles.shape == (2, 2) and cohort.n < driver.g.n_padded
    windows = obs.get_registry().snapshot()["counters"]
    assert windows.get(DENSE, 0) == dense_before
    sums = driver.g.row_sums().double().numpy()
    assert np.array_equal(sums, reference.row_sums(cohort, job.lo, job.hi))
    index = {cid: i for i, cid in enumerate(cohort.ids)}
    got = np.zeros((cohort.n, 2))
    for cid, pc1, pc2 in rows:
        got[index[cid]] = (pc1, pc2)
    want = reference.coordinates_matrix_free(cohort, job.lo, job.hi, 2,
                                             seed)
    gap = max(min(np.abs(got[:, j] - want[:, j]).max(),
                  np.abs(got[:, j] + want[:, j]).max()) for j in range(2))
    assert gap < 1e-6


def _card_mesh():
    cards = torch.cuda.device_count()
    if cards >= 4:
        return make_mesh(MESH, devices=[torch.device("cuda", i)
                                        for i in range(4)])
    return make_mesh("data:1", devices=[torch.device("cuda", 0)])


@pytest.mark.card
def test_centring_allocates_no_second_tile_on_the_cards():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mesh = _card_mesh()
    n = 16384 * mesh.shape["data"] + 1  # a 1 GB tile or more, padded rows
    g = ShardedGramian.zeros(n, mesh)
    assert g.tile_rows * g.tile_cols * 4 >= 1 << 30
    # G = X·Xᵀ of three groups, written tile by tile into the tiles.
    rng = np.random.default_rng(7)
    groups = rng.integers(0, 3, size=g.n_padded)
    af = rng.beta(0.4, 1.2, size=(3, 64))
    x = (rng.random((g.n_padded, 64)) < af[groups]).astype(np.float32)
    x[n:] = 0
    for (i, j), tile in g.local_tiles():
        r0, c0 = g.tile_origin(i, j)
        xr = torch.from_numpy(x[r0:r0 + g.tile_rows]).to(tile.device)
        xc = torch.from_numpy(x[c0:c0 + g.tile_cols]).to(tile.device)
        torch.matmul(xr, xc.T, out=tile)
    cards = sorted({t.device.index for _, t in g.local_tiles()})
    for card in cards:
        torch.cuda.synchronize(card)
        torch.cuda.reset_peak_memory_stats(card)
    tile_bytes = g.tile_rows * g.tile_cols * 4
    coords, _ = sharded_pcoa(g, 2, mesh, dense_eigh_limit=n - 1)
    for card in cards:
        torch.cuda.synchronize(card)
        peak = torch.cuda.max_memory_allocated(card)
        assert peak < 1.05 * tile_bytes, (card, peak, tile_bytes)
    # The coordinates are the left singular vectors of H·X.
    xc64 = torch.from_numpy(x[:n]).double()
    u, _, _ = torch.linalg.svd(xc64 - xc64.mean(0), full_matrices=False)
    want = u[:, :2].numpy()
    gap = max(min(np.abs(coords[:, j] - want[:, j]).max(),
                  np.abs(coords[:, j] + want[:, j]).max()) for j in range(2))
    assert gap < 1e-4


@pytest.mark.card
def test_the_tile_products_overlap_across_the_cards(monkeypatch):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards or more")
    cards = torch.cuda.device_count()
    mesh = make_mesh(
        MESH if cards >= 4 else "data:2",
        devices=[torch.device("cuda", i) for i in range(min(cards, 4))],
    )
    # 17 GB tiles or more, padded rows: the GEMM, not the copies of the
    # 10-column panels and the float64 corrections, sets a product's time,
    # as on a 40 GB tile of a 200,643-sample G.
    n = 65536 * mesh.shape["data"] + 1
    g = ShardedGramian.zeros(n, mesh)
    tile_bytes = g.tile_rows * g.tile_cols * 4
    assert tile_bytes >= 1 << 30
    for k, (_, tile) in enumerate(g.local_tiles()):
        tile.normal_(
            generator=torch.Generator(device=tile.device).manual_seed(k))
    devices = sorted({t.device.index for _, t in g.local_tiles()})
    assert len(devices) >= 2
    q = torch.randn((n, 10), device=g.device,
                    generator=torch.Generator(device=g.device).manual_seed(9))
    op = CenteredGramian(g)

    def timed(fn, repeats=5):
        """Median milliseconds of ``fn()`` by events on the first card,
        after one untimed call; returns (ms, the last result)."""
        out = fn()
        times = []
        for _ in range(repeats):
            for d in devices:
                torch.cuda.synchronize(d)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(g.device))
            out = fn()
            end.record(torch.cuda.current_stream(g.device))
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times)), out

    tile0 = g.local_tiles()[0][1]
    gemm_ms, _ = timed(lambda: tile0 @ q[: g.tile_cols])
    grid_ms, _ = timed(lambda: g.matmul(q))
    for d in devices:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    before, products = _counter(OVERLAPPED), op.products
    product_ms, got = timed(lambda: op.matmul(q))
    overlapped, counted = _counter(OVERLAPPED) - before, op.products - products
    peaks = {d: torch.cuda.max_memory_allocated(d) for d in devices}
    monkeypatch.setattr(ShardedGramian, "matmul", _tile_by_tile_matmul)
    serial_ms, want = timed(lambda: op.matmul(q))
    print(f"{tile_bytes / 1e9:.2f} GB tiles on {len(devices)} cards: one "
          f"tile's GEMM {gemm_ms:.3f} ms; G·Q {grid_ms:.3f} ms; centred "
          f"product {product_ms:.3f} ms, tile by tile {serial_ms:.3f} ms")
    assert overlapped == counted == 6  # one a product
    for d, peak in peaks.items():
        assert peak < 1.05 * tile_bytes, (d, peak, tile_bytes)
    assert product_ms < 1.5 * gemm_ms, (product_ms, gemm_ms)
    assert torch.equal(got, want)
