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
  float64 matrix-free reference and G's row sums exactly.

Marked ``card``: on the visible CUDA cards, over an N whose tile holds at
least 1 GB, ``sharded_pcoa`` allocates no tile-sized tensor beside G's
tiles (each card's peak stays under one tile plus 5 %). Run it on a host
with cards: ``python -m pytest --noconftest -m card
tests/test_torch_centered_tiles.py``.
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


def _gramian(n, v=96, seed=0):
    """(n, n) float32 G = X·Xᵀ of a 0/1 X with three groups of samples."""
    rng = np.random.default_rng(seed)
    groups = rng.integers(0, 3, size=n)
    af = rng.beta(0.4, 1.2, size=(3, v))
    x = (rng.random((n, v)) < af[groups]).astype(np.float32)
    return torch.from_numpy(x @ x.T)


def _tiles(g):
    return [t.clone() for _, t in g.local_tiles()]


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
