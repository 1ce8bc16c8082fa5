"""Sharded Gramian + PCoA over a single-controller mesh.

The port of the JAX package's ``parallel/sharded.py`` for a mesh of one
process's own devices (:mod:`spark_examples_tpu_torch.parallel.mesh`).
Two layouts, as there:

- **Variant-parallel.** Each device of the "data" axis holds a slice of
  the variant axis, computes its partial ``X_loc @ X_loc.T``, and the
  partials are summed (:func:`gramian_variant_parallel`, and
  :func:`gramian_variant_parallel_ring` with the sum scheduled as a ring).
- **Sample-sharded.** G lives as a grid of tiles laid out ``P(data,
  model)`` — tile (i, j) holds rows ``i·t_r …`` and columns ``j·t_c …``
  on the device at grid position (i, j) — in a :class:`ShardedGramian`.
  Dense blocks add ``X[rows_i] · X[cols_j]ᵀ`` to each tile
  (:func:`sharded_gramian_blockwise`); rare CSR windows re-base their
  carrier matrix into each tile's frame and launch the scatter kernel
  once per tile (:func:`sparse_sharded_gramian_blockwise`). The top-k
  eigenvectors come from dense ``eigh`` of the gathered centered matrix
  or, above ``dense_eigh_limit``, from randomized subspace iteration
  whose only O(N²) op is the tile-wise ``C @ Q``
  (:func:`topk_eig_randomized`, :func:`sharded_pcoa`).

Where the JAX package has GSPMD or a ``psum``, this module has an explicit
copy (``.to(device)``) or sum. Every Gramian here adds exact integer
counts, so G is bit-identical to the meshless G at any mesh shape.
Axes other than "data" and "model" would hold replicas of the tiles; the
port keeps one copy, on the devices at index 0 of those axes.
"""

from __future__ import annotations

import itertools
from typing import Iterable, Optional

import numpy as np
import torch

from spark_examples_tpu_torch import obs
from spark_examples_tpu_torch.arrays.blocks import (
    DEFAULT_BLOCK_VARIANTS,
    _check_indices,
    _densify_window,
    restrict_window_to_sample_range,
    round_up_multiple,
)
from spark_examples_tpu_torch.arrays.feed import device_prefetch
from spark_examples_tpu_torch.ops.gramian import (
    mxu_cross_product,
    mxu_cross_product_pair,
    pack_indicator_block,
    unpack_indicator_block,
)
from spark_examples_tpu_torch.ops.pcoa import (
    DEFAULT_RANDOMIZED_OVERSAMPLE,
    SpectralGapWarning,
    check_spectral_gap,
    normalize_eigvec_signs,
    principal_components,
    randomized_panel_width,
    topk_with_gap_check,
)
from spark_examples_tpu_torch.ops.scatter_kernel import scatter_pairs
from spark_examples_tpu_torch.ops.sparse import (
    DEFAULT_SPARSE_DENSITY_THRESHOLD,
    _note_window,
    _pad_rows_for_scan,
    dense_panel_width,
    padded_carrier_matrix,
    window_route,
)
from spark_examples_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from spark_examples_tpu_torch.utils.tracing import GRAMIAN_ACCUMULATE

__all__ = [
    "ShardedGramian",
    "SpectralGapWarning",
    "addressable_sample_bounds",
    "gramian_variant_parallel",
    "gramian_variant_parallel_ring",
    "sample_bounds_of_indices",
    "sharded_gramian_blockwise",
    "sharded_pcoa",
    "sparse_sharded_gramian_blockwise",
    "topk_eig_randomized",
]


def _mesh_axes(mesh: Mesh):
    has_model = MODEL_AXIS in mesh.axis_names
    return DATA_AXIS, (MODEL_AXIS if has_model else None)


def _axis_product(mesh: Mesh, spec) -> int:
    """Devices a partition spec (a tuple of axis names, tuples of names or
    None) splits a dimension over."""
    total = 1
    for entry in spec:
        if entry is None:
            continue
        for name in entry if isinstance(entry, tuple) else (entry,):
            total *= mesh.shape[name]
    return total


def _grid_device(mesh: Mesh, i: int, j: int) -> torch.device:
    """The device at data index ``i``, model index ``j`` (index 0 on any
    other axis)."""
    d_axis, m_axis = _mesh_axes(mesh)
    index = [0] * len(mesh.axis_names)
    index[mesh.axis_names.index(d_axis)] = i
    if m_axis is not None:
        index[mesh.axis_names.index(m_axis)] = j
    return mesh.devices[tuple(index)]


def _grid_shape(mesh: Mesh):
    d_axis, m_axis = _mesh_axes(mesh)
    if d_axis not in mesh.axis_names:
        raise ValueError(
            f"a sharded Gramian needs a {d_axis!r} mesh axis, got "
            f"{mesh.axis_names}"
        )
    return mesh.shape[d_axis], (mesh.shape[m_axis] if m_axis else 1)


class ShardedGramian:
    """An (n, n) float32 Gramian as a tile grid laid out ``P(data,
    model)``.

    N is padded to ``n_padded``, a multiple of the grid's device count
    (the JAX package's rule), so every tile is ``(tile_rows, tile_cols)``;
    the padded rows and columns are zero and lie outside the logical
    (n, n) matrix. ``tiles[i, j]`` lives on the device at grid position
    (i, j).
    """

    def __init__(self, tiles: np.ndarray, n: int, mesh: Mesh):
        self.tiles = tiles
        self.n = n
        self.mesh = mesh
        self.tile_rows, self.tile_cols = tiles[0, 0].shape
        self.n_padded = self.tile_rows * tiles.shape[0]

    @classmethod
    def zeros(cls, n: int, mesh: Mesh, dtype=torch.float32):
        rows, cols = _grid_shape(mesh)
        n_padded = round_up_multiple(n, rows * cols)
        tiles = np.empty((rows, cols), dtype=object)
        for i, j in np.ndindex(rows, cols):
            tiles[i, j] = torch.zeros(
                (n_padded // rows, n_padded // cols),
                dtype=dtype,
                device=_grid_device(mesh, i, j),
            )
        return cls(tiles, n, mesh)

    @classmethod
    def from_full(cls, g, mesh: Mesh):
        """Lay an (n, n) tensor or array out over ``mesh``: one copy per
        tile."""
        g = torch.as_tensor(g)
        out = cls.zeros(g.shape[0], mesh, g.dtype)
        out.add_(g)
        return out

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.tiles[0, 0].dtype

    @property
    def device(self) -> torch.device:
        """The first tile's device, where gathers and panels land."""
        return self.tiles[0, 0].device

    def tile_origin(self, i: int, j: int):
        """Row and column offset of tile (i, j) in the padded matrix."""
        return i * self.tile_rows, j * self.tile_cols

    def add_(self, g) -> "ShardedGramian":
        """Add an (n, n) tensor or array, or a tile grid of the same
        layout, into the tiles, in place."""
        if isinstance(g, ShardedGramian):
            for tile, other in zip(self.tiles.flat, g.tiles.flat):
                tile += other.to(tile.device)
            return self
        g = torch.as_tensor(g)
        for (i, j), tile in np.ndenumerate(self.tiles):
            r0, c0 = self.tile_origin(i, j)
            part = g[r0:r0 + self.tile_rows, c0:c0 + self.tile_cols]
            tile[: part.shape[0], : part.shape[1]] += part.to(
                tile.device, tile.dtype
            )
        return self

    def full(self) -> torch.Tensor:
        """Gather the tiles onto the first tile's device and trim to
        (n, n)."""
        rows = [
            torch.cat([t.to(self.device) for t in row], dim=1)
            for row in self.tiles
        ]
        return torch.cat(rows, dim=0)[: self.n, : self.n].contiguous()

    def row_sums(self) -> torch.Tensor:
        """Σ_j G[i, j] for the n rows, on the first tile's device."""
        sums = [
            sum(t.sum(dim=1).to(self.device) for t in row)
            for row in self.tiles
        ]
        return torch.cat(sums)[: self.n]

    def matmul(self, q: torch.Tensor) -> torch.Tensor:
        """``G @ q`` for an (n, p) panel on the first tile's device: each
        tile multiplies its column slab of q on its own device."""
        dev = q.device
        qp = torch.zeros(
            (self.n_padded, q.shape[1]), dtype=q.dtype, device=dev
        )
        qp[: self.n] = q
        out = torch.zeros_like(qp)
        for (i, j), tile in np.ndenumerate(self.tiles):
            r0, c0 = self.tile_origin(i, j)
            slab = qp[c0:c0 + self.tile_cols].to(tile.device)
            out[r0:r0 + self.tile_rows] += (tile @ slab).to(dev)
        return out[: self.n]


def gramian_variant_parallel(x, mesh: Mesh, compute_dtype=None):
    """``G = Σ_devices X_loc @ X_loc.T`` with X variant-sharded over the
    "data" axis.

    ``x``: (N, V) with V divisible by the data-axis size. Each data-axis
    device multiplies its column slice; the partials are summed on the
    first device in axis order (the JAX package's ``psum``). Returns G
    there.
    """
    parts = _variant_parallel_partials(x, mesh, compute_dtype)
    dev = parts[0].device
    g = parts[0]
    for part in parts[1:]:
        g = g + part.to(dev)
    return g


def _variant_parallel_partials(x, mesh: Mesh, compute_dtype):
    x = torch.as_tensor(x)
    n_dev = mesh.shape[DATA_AXIS]
    if x.shape[1] % n_dev:
        raise ValueError(
            f"{x.shape[1]} variant columns do not divide over the "
            f"{n_dev}-device {DATA_AXIS!r} axis"
        )
    width = x.shape[1] // n_dev
    return [
        mxu_cross_product(
            x[:, k * width:(k + 1) * width].to(_grid_device(mesh, k, 0)),
            torch.float32,
            compute_dtype,
        )
        for k in range(n_dev)
    ]


def gramian_variant_parallel_ring(x, mesh: Mesh, compute_dtype=None):
    """Variant-parallel Gramian with the reduction scheduled as a ring.

    Same math as :func:`gramian_variant_parallel`, but each of the n−1
    steps passes every device's running buffer to its ring neighbour,
    which adds it to its own sum. The devices add the same partials in
    rotated orders, so for float-valued X their sums differ in the last
    bits; every replica is canonicalized to device 0's sum, as the JAX
    package does (its ``:403-411``). Returns that sum, on device 0.
    """
    parts = _variant_parallel_partials(x, mesh, compute_dtype)
    n_dev = len(parts)
    acc = list(parts)
    buf = list(parts)
    for _ in range(n_dev - 1):
        # Device j+1 receives device j's buffer (ppermute j -> j+1).
        buf = [buf[(j - 1) % n_dev].to(acc[j].device) for j in range(n_dev)]
        acc = [a + b for a, b in zip(acc, buf)]
    return acc[0]


def _accumulate_tiles(g: ShardedGramian, x: torch.Tensor, compute_dtype):
    """Add ``X[rows_i] · X[cols_j]ᵀ`` to every tile (i, j) of ``g``; ``x``
    is one (n_padded, V) block, copied slab by slab to each tile's
    device."""
    for (i, j), tile in np.ndenumerate(g.tiles):
        r0, c0 = g.tile_origin(i, j)
        rows = x[r0:r0 + g.tile_rows].to(tile.device)
        if (r0, g.tile_rows) == (c0, g.tile_cols):
            cols = rows
        else:
            cols = x[c0:c0 + g.tile_cols].to(tile.device)
        tile += mxu_cross_product_pair(
            rows, cols, tile.dtype, compute_dtype
        )


def sharded_gramian_blockwise(
    blocks: Iterable[np.ndarray],
    n_samples: int,
    mesh: Mesh,
    accum_dtype=torch.float32,
    compute_dtype=None,
    packed: bool = False,
    prepacked: bool = False,
    prefetch_depth: int = 2,
) -> ShardedGramian:
    """Stream variant blocks into a mesh-sharded Gramian accumulator.

    G is laid out ``P(data, model)`` — a 2-D tile grid when the mesh has a
    model axis, row slabs otherwise; each block reaches the tiles through
    the double-buffered feed on the first tile's device, and each tile
    takes its row and column slabs of it. The sample axis is padded to the
    grid (zero rows are inert in X·Xᵀ). ``packed`` (0/1 indicator blocks
    only) bit-packs each padded block on the host, 8× fewer bytes through
    the feed, and the tiles unpack it on the device; ``prepacked`` blocks
    already are packed bytes (their rows are padded with zero bytes).
    Unpacked blocks resolve the product's dtype from the first block's: a
    float dosage block computes in float, never truncated to int8, and a
    later block of another dtype raises. Returns a
    :class:`ShardedGramian`.
    """
    g = ShardedGramian.zeros(n_samples, mesh, accum_dtype)
    n_padded = g.n_padded
    if packed or prepacked:
        x_dtype = np.dtype(np.int8)
    else:
        blocks = iter(blocks)
        first = next(blocks, None)
        x_dtype = (
            np.dtype(np.int8) if first is None else np.asarray(first).dtype
        )
        if first is not None:
            blocks = itertools.chain((first,), blocks)
    if compute_dtype is None:
        compute_dtype = (
            torch.int8 if x_dtype == np.int8 else torch.float32
        )

    def padded_blocks():
        for block in blocks:
            xb = np.asarray(block)
            if not (packed or prepacked) and xb.dtype != x_dtype:
                raise ValueError(
                    f"block dtype changed mid-stream: {xb.dtype} after the "
                    f"stream was resolved as {x_dtype}; every block must "
                    "share one dtype"
                )
            if n_padded != n_samples:
                xb = np.pad(xb, ((0, n_padded - n_samples), (0, 0)))
            if packed and not prepacked:
                xb = pack_indicator_block(xb)
            yield xb

    stream = device_prefetch(
        padded_blocks(), depth=prefetch_depth, device=g.device
    )
    for b, xb in enumerate(stream):
        with obs.span(GRAMIAN_ACCUMULATE, block=b, sharded=True):
            if packed or prepacked:
                xb = unpack_indicator_block(xb, 8 * xb.shape[1])
            _accumulate_tiles(g, xb, compute_dtype)
    return g


def sample_bounds_of_indices(index_slices, n: int):
    """``(lo, hi)`` union of the sample ranges a tile set touches.

    ``index_slices`` are per-tile ``(row_slice, col_slice)`` pairs over
    the (n, n) Gramian: a host whose tiles cover rows R and columns C
    only ever reads carrier indices inside ``R ∪ C``; every pair with an
    endpoint outside lands in a tile another host owns.
    """
    lo, hi = n, 0
    for row_sl, col_sl in index_slices:
        for sl in (row_sl, col_sl):
            start = sl.start if sl.start is not None else 0
            stop = sl.stop if sl.stop is not None else n
            lo, hi = min(lo, start), max(hi, stop)
    if hi <= lo:
        return 0, n
    return lo, hi


def addressable_sample_bounds(mesh: Mesh, n: int):
    """This process's sample-range bounds for an (n, n) Gramian laid out
    over ``mesh``: every tile of a single-controller mesh is this
    process's, so this is the full range."""
    rows, cols = _grid_shape(mesh)
    t_r, t_c = n // rows, n // cols
    return sample_bounds_of_indices(
        (
            (slice(i * t_r, (i + 1) * t_r), slice(j * t_c, (j + 1) * t_c))
            for i, j in np.ndindex(rows, cols)
        ),
        n,
    )


def _tile_operands(idx: torch.Tensor, r0: int, tile_rows: int, c0: int,
                   tile_cols: int):
    """Re-base a global carrier matrix into one tile's frame: indices
    inside the tile's rows (columns) become row (column) offsets, every
    other index the out-of-tile sentinel ``tile_rows`` (``tile_cols``),
    whose pairs the scatter drops. Tiles partition the (i, j) pair space,
    so the union over tiles is exactly one +1 per co-occurring pair."""
    li = torch.where(
        (idx >= r0) & (idx < r0 + tile_rows), idx - r0, tile_rows
    ).to(torch.int32).contiguous()
    lj = torch.where(
        (idx >= c0) & (idx < c0 + tile_cols), idx - c0, tile_cols
    ).to(torch.int32).contiguous()
    return li, lj


def _tile_scatter(g: ShardedGramian, idx: np.ndarray) -> None:
    """One scatter window into every tile: one :func:`~spark_examples_tpu_
    torch.ops.scatter_kernel.scatter_pairs` call per tile (the kernel on
    a CUDA tile, its plain version on a CPU one), on rebased operands."""
    on_device = {}
    for (i, j), tile in np.ndenumerate(g.tiles):
        if tile.device not in on_device:
            on_device[tile.device] = torch.from_numpy(idx).to(tile.device)
        r0, c0 = g.tile_origin(i, j)
        li, lj = _tile_operands(
            on_device[tile.device], r0, g.tile_rows, c0, g.tile_cols
        )
        scatter_pairs(tile, li, lj)


def sparse_sharded_gramian_blockwise(
    windows,
    n_samples: int,
    mesh: Mesh,
    accum_dtype=torch.float32,
    density_threshold: Optional[float] = None,
    block_variants: Optional[int] = None,
    compute_dtype=None,
) -> ShardedGramian:
    """Stream CSR carrier windows into a mesh-sharded (tiled) Gramian.

    Each window is routed by density
    (:func:`~spark_examples_tpu_torch.ops.sparse.window_route`): a rare
    window's padded carrier matrix (sentinel ``n_padded``) is copied to
    every tile's device, re-based into each tile's frame and scattered
    there; a dense window is densified, bit-packed and added to every
    tile as an int8 product. Both routes add exact integer counts, so G
    is bit-identical to the meshless engine's at any mesh shape and
    window order. Ingest first drops carriers outside this process's
    sample-range bounds (:func:`addressable_sample_bounds`), the full
    range on a single-controller mesh.
    """
    if density_threshold is None:
        density_threshold = DEFAULT_SPARSE_DENSITY_THRESHOLD
    width = block_variants or DEFAULT_BLOCK_VARIANTS
    g = ShardedGramian.zeros(n_samples, mesh, accum_dtype)
    n_padded = g.n_padded
    if compute_dtype is None:
        compute_dtype = torch.int8
    lo, hi = addressable_sample_bounds(mesh, n_padded)
    with obs.span("gramian.sparse.accumulate", n=n_samples, sharded=True):
        for window_idx, lens in windows:
            lens = np.asarray(lens)
            _check_indices(np.asarray(window_idx), n_samples)
            window_idx, lens = restrict_window_to_sample_range(
                window_idx, lens, lo, hi
            )
            route = window_route(lens, n_samples, density_threshold)
            nnz = int(lens.sum())
            with obs.span(
                "gramian.sparse.window",
                route=route,
                nnz=nnz,
                variants=int(lens.size),
            ):
                if route == "scatter":
                    _tile_scatter(g, padded_carrier_matrix(
                        window_idx,
                        lens,
                        sentinel=n_padded,
                        n_rows=_pad_rows_for_scan(lens.size),
                    ))
                else:
                    xb = _densify_window(
                        window_idx,
                        lens,
                        n_samples,
                        dense_panel_width(int(lens.size), width),
                    )
                    if n_padded != n_samples:
                        xb = np.pad(xb, ((0, n_padded - n_samples), (0, 0)))
                    xp = torch.from_numpy(pack_indicator_block(xb))
                    _accumulate_tiles(
                        g,
                        unpack_indicator_block(
                            xp.to(g.device), 8 * xp.shape[1]
                        ),
                        compute_dtype,
                    )
            _note_window(route, nnz)
    return g


def double_center_tiles(g: ShardedGramian) -> ShardedGramian:
    """The centered matrix ``C = G − rowmean − colmean + grandmean`` as a
    tile grid (the port's ``ops/centering.py`` tile by tile): the means
    are over the n real rows and columns, and C's padded rows and columns
    stay zero, so C's spectrum is the trimmed matrix's plus zeros."""
    n, dev = g.n, g.device
    rows = torch.zeros(g.n_padded, dtype=torch.float32, device=dev)
    cols = torch.zeros_like(rows)
    for (i, j), tile in np.ndenumerate(g.tiles):
        r0, c0 = g.tile_origin(i, j)
        t = tile.to(torch.float32)
        rows[r0:r0 + g.tile_rows] += t.sum(dim=1).to(dev)
        cols[c0:c0 + g.tile_cols] += t.sum(dim=0).to(dev)
    grand = rows.sum() / (n * n)
    rowmean, colmean = rows / n, cols / n
    real = torch.zeros_like(rows)
    real[:n] = 1.0
    tiles = np.empty(g.tiles.shape, dtype=object)
    for (i, j), tile in np.ndenumerate(g.tiles):
        r0, c0 = g.tile_origin(i, j)
        rs = slice(r0, r0 + g.tile_rows)
        cs = slice(c0, c0 + g.tile_cols)
        d = tile.device
        c = (
            tile.to(torch.float32)
            - rowmean[rs, None].to(d)
            - colmean[None, cs].to(d)
            + grand.to(d)
        )
        tiles[i, j] = c * (real[rs, None] * real[None, cs]).to(d)
    return ShardedGramian(tiles, n, g.mesh)


def _symmetric_eigh(b: torch.Tensor):
    """Eigenpairs of a small symmetric matrix ordered by |λ| descending
    (stable, as ``jnp.argsort``); both triangles are averaged first, as
    ``jnp.linalg.eigh`` does."""
    w, u = torch.linalg.eigh((b + b.T) / 2)
    order = torch.argsort(-w.abs(), stable=True)
    return w[order], u[:, order]


def topk_eig_randomized(
    c,
    k: int,
    oversample: int = DEFAULT_RANDOMIZED_OVERSAMPLE,
    iters: int = 30,
    seed: int = 0,
    mesh: Optional[Mesh] = None,
    timer=None,
    gap_warn_ratio: float = 0.95,
    tol: Optional[float] = None,
    check_every: int = 5,
):
    """Top-|λ| eigenpairs of symmetric C by randomized subspace iteration.

    ``c`` is an (n, n) tensor or a :class:`ShardedGramian` tile grid; the
    only O(n²) op is ``C @ Q`` against an (n, k+p) panel, tile by tile on
    a grid, and the QR of the panel runs on the first device. Returns
    ``(vecs (n, k), vals (k,))`` ordered by |λ| descending, signs
    normalized, on that device.

    The starting panel is ``default_rng(seed).standard_normal`` (the JAX
    package draws it from ``jax.random``, whose stream the port cannot
    reproduce), so coordinates agree with the JAX package's and with
    dense ``eigh`` to the randomized bar (1e-4 on population-structure
    spectra), not bit for bit.

    A :class:`SpectralGapWarning` fires when the (k+1)-th Ritz value's
    ratio to the k-th exceeds ``gap_warn_ratio``. ``tol`` (opt-in) makes
    the iteration count adaptive: the sweep runs in chunks of
    ``check_every``, stopping once every top-k Ritz pair's relative
    residual ``‖C·v − λ·v‖/|λ|`` drops below ``tol`` or at ``iters``
    (rounded up to a whole chunk); the count used lands in the stage
    report. The chunked sweep applies the fixed path's operations in its
    order, so ``tol=0`` with ``iters`` a chunk multiple gives the fixed
    path's result bit for bit.
    """
    n = c.shape[0]
    p = randomized_panel_width(n, k, oversample)
    q = torch.from_numpy(
        np.random.default_rng(seed).standard_normal((n, p)).astype(
            np.float32
        )
    ).to(c.device, c.dtype)
    product = c.matmul if isinstance(c, ShardedGramian) else c.__matmul__

    def sweep(q, length):
        for _ in range(length):
            q, _ = torch.linalg.qr(product(q))
        return q

    if tol is None:
        q = sweep(q, iters)
        vals, u = _symmetric_eigh(q.T @ product(q))
    else:
        chunk = max(1, min(check_every, iters))
        tiny = torch.finfo(c.dtype).tiny
        used, converged = 0, False
        b = torch.zeros((p, p), dtype=c.dtype, device=q.device)
        while not converged and used < iters:
            q = sweep(q, chunk)
            y = product(q)  # reused: the residual and the final Ritz matrix
            b = q.T @ y
            w, u = _symmetric_eigh(b)
            uk, wk = u[:, :k], w[:k]
            rk = y @ uk - (q @ uk) * wk
            rel = (
                torch.linalg.norm(rk, dim=0) / wk.abs().clamp_min(tiny)
            ).max()
            used += chunk
            converged = bool(rel < tol)
        vals, u = _symmetric_eigh(b)
        if timer is not None:
            timer.note(
                f"randomized eig: {used}/{iters} iterations (tol={tol:g})"
            )
    vecs = q @ u
    check_spectral_gap(vals.cpu().numpy(), k, gap_warn_ratio, timer)
    return normalize_eigvec_signs(vecs[:, :k]), vals[:k]


def sharded_pcoa(
    g,
    k: int,
    mesh: Mesh,
    dense_eigh_limit: int = 8192,
    timer=None,
    eig_tol: Optional[float] = None,
):
    """Center + top-k eigenvectors of a mesh-sharded Gramian.

    ``g`` is a :class:`ShardedGramian` (a tensor or array is laid out over
    ``mesh`` first). The tile grid is double-centered in place of the
    whole matrix; for n ≤ ``dense_eigh_limit`` the centered matrix is
    gathered and dense ``eigh`` runs with the spectral-gap check on one
    extra eigenpair, above it randomized subspace iteration runs on the
    tiles. Returns host ``(coords (n, k), vals (k,))`` arrays.
    """
    if not isinstance(g, ShardedGramian):
        g = ShardedGramian.from_full(g, mesh)
    c = double_center_tiles(g)
    n = g.n
    if n <= dense_eigh_limit:
        cf = c.full()

        def dense(kk):
            coords, vals = principal_components(cf, kk)
            return coords.cpu().numpy(), vals.cpu().numpy()

        return topk_with_gap_check(dense, k, n, timer=timer)
    coords, vals = topk_eig_randomized(
        c, k, mesh=mesh, timer=timer, tol=eig_tol
    )
    return coords.cpu().numpy(), vals.cpu().numpy()
