"""Sharded Gramian + PCoA over a mesh: the single-controller and the pod
regimes.

The port of the JAX package's ``parallel/sharded.py``. Two layouts, as
there:

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
  eigenvectors come from dense ``eigh`` of the gathered, centered matrix
  or, above ``dense_eigh_limit``, from randomized subspace iteration
  whose only O(N²) op is the tile-wise ``G @ Q``, centred by rank-one
  corrections so that C is never formed (:class:`CenteredGramian`,
  :func:`topk_eig_randomized`, :func:`sharded_pcoa`).

A mesh that spans processes (the pod regime,
:func:`~spark_examples_tpu_torch.parallel.mesh.mesh_spans_processes`)
gives each rank only the tiles at its own grid positions; ``.full()``,
``.row_sums()`` and ``.matmul()`` of such a grid are collectives every
rank calls. Each rank feeds its own slice of the manifest, and every
accumulation step is agreed across the pod first, so a failure on one
rank raises on every rank at the same step:

- dense blocks through :func:`_synced_block_stream` (a header of ``[width,
  dtype.num, rows]`` all-gathered through the process group) into a
  replicated G (:func:`gramian_blockwise_global`: each rank adds its own
  blocks, one all-reduce at the end) or a tile grid
  (:func:`sharded_gramian_blockwise_global`: the ranks' packed blocks
  all-gathered along the variant axis each step);
- CSR windows through :func:`_synced_carrier_stream`, the pipelined host
  exchange of :mod:`~spark_examples_tpu_torch.parallel.podstream`, into a
  tile grid; on a square grid each off-diagonal pair of tiles computes
  half of itself (the mirror slabs) and :func:`_mirror_fill` swaps and
  transposes the halves at the end.

The sketch engine's mesh half is here too: :func:`sharded_sketch_panel`
streams CSR windows into a replicated (N, k+p) panel (on a pod through the
synced carrier stream, its dense steps one all-reduce of each rank's own
columns' contribution) and :func:`sharded_sketch_finish` factors it with
the two-level TSQR of :func:`sketch_tsqr` over the mesh's row blocks.

Two transports: payloads on the card use the process group (NCCL on
cards, gloo on the CPU); the sparse stream's host agreement uses the pod
exchange's TCP mesh. Only the consumer (main) thread calls
``torch.distributed``, in the same order on every rank.

Where the JAX package has GSPMD or a ``psum``, this module has an explicit
copy (``.to(device)``), sum or collective. Every Gramian here adds exact
integer counts, so G is bit-identical to the meshless G at any mesh shape
and world size. Axes other than "data" and "model" would hold replicas of
the tiles; the port keeps one copy, on the devices at index 0 of those
axes.
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
    pcoa,
    randomized_panel_width,
    topk_with_gap_check,
)
from spark_examples_tpu_torch.ops.scatter_kernel import scatter_pairs
from spark_examples_tpu_torch.ops.sparse import (
    DEFAULT_POD_COALESCE_VARIANTS,
    DEFAULT_SPARSE_DENSITY_THRESHOLD,
    _accumulate_windows,
    _carrier_bucket,
    _dense_operand,
    _note_pod_gang,
    _note_pod_sync,
    _note_window,
    _pad_rows_for_scan,
    dense_panel_width,
    padded_carrier_matrix,
    window_route,
)
from spark_examples_tpu_torch.parallel import distributed
from spark_examples_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    mesh_spans_processes,
)
from spark_examples_tpu_torch.utils.tracing import (
    GRAMIAN_ACCUMULATE,
    PCOA_TILES_PRODUCT,
    PCOA_TILES_SUMS,
)

__all__ = [
    "CenteredGramian",
    "ShardedGramian",
    "SpectralGapWarning",
    "addressable_sample_bounds",
    "gramian_blockwise_global",
    "gramian_variant_parallel",
    "gramian_variant_parallel_ring",
    "sample_bounds_of_indices",
    "sharded_gramian_blockwise",
    "sharded_gramian_blockwise_global",
    "sharded_pcoa",
    "sharded_sketch_finish",
    "sharded_sketch_panel",
    "sketch_tsqr",
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


def _grid_index(mesh: Mesh, i: int, j: int):
    """The mesh index of data index ``i``, model index ``j`` (index 0 on
    any other axis)."""
    d_axis, m_axis = _mesh_axes(mesh)
    index = [0] * len(mesh.axis_names)
    index[mesh.axis_names.index(d_axis)] = i
    if m_axis is not None:
        index[mesh.axis_names.index(m_axis)] = j
    return tuple(index)


def _grid_device(mesh: Mesh, i: int, j: int) -> torch.device:
    """The device at data index ``i``, model index ``j``."""
    return mesh.devices[_grid_index(mesh, i, j)]


def _grid_owner(mesh: Mesh, i: int, j: int) -> int:
    """The rank that owns tile (i, j)."""
    return int(mesh.processes[_grid_index(mesh, i, j)])


def _wait_if_traced(device: torch.device) -> None:
    """Under a profiler or a telemetry session, wait for ``device``'s
    work, so that a span around work on the cards ends when that work does
    (its results arrive on ``device``, whose stream waits for every card's
    copy); untraced, the host does not block. The profiler's module flag
    is read, as ``torch.autograd._profiler_enabled()`` is per thread and
    reads False under a profiler over every thread."""
    if device.type == "cuda" and (
        obs.collection_active()
        or getattr(torch.autograd.profiler, "_is_profiler_enabled", False)
    ):
        torch.cuda.synchronize(device)


def _grid_shape(mesh: Mesh):
    d_axis, m_axis = _mesh_axes(mesh)
    if d_axis not in mesh.axis_names:
        raise ValueError(
            f"a sharded Gramian needs a {d_axis!r} mesh axis, got "
            f"{mesh.axis_names}"
        )
    return mesh.shape[d_axis], (mesh.shape[m_axis] if m_axis else 1)


def _split(n: int, parts: int, size: int):
    """``parts`` slices of ``size`` indices from 0, clipped to n."""
    return [
        slice(min(i * size, n), min((i + 1) * size, n)) for i in range(parts)
    ]


def jax_tile_splits(n: int, mesh: Mesh):
    """The row and the column slices of an (n, n) G's tiles under the JAX
    package's ``P(data, model)`` sharding: n / parts wide. The port's own
    grid pads n to a multiple of the device count instead
    (:meth:`ShardedGramian.splits`), so the two differ where the device
    count does not divide n. Where an axis does not divide n, JAX refuses
    the sharding; the split is then ceil(n / parts) wide, the last tiles
    short or empty."""
    rows, cols = _grid_shape(mesh)
    return _split(n, rows, -(-n // rows)), _split(n, cols, -(-n // cols))


def _overlap(a: slice, b: slice) -> Optional[slice]:
    lo, hi = max(a.start, b.start), min(a.stop, b.stop)
    return slice(lo, hi) if lo < hi else None


def _retile(mesh: Mesh, src, src_splits, dst, dst_splits) -> None:
    """Copy an (n, n) G from one tile grid over the mesh's (data, model)
    positions into another, in place: ``src`` and ``dst`` are object
    arrays of this rank's tiles (None for a peer's), tile (i, j) holding
    the global rows ``splits[0][i]`` and columns ``splits[1][j]`` from its
    corner. A block whose two tiles are on one rank is copied; a block
    that changes ranks travels in one all-reduce that every rank joins
    (its source rank adds the block, the others zeros). Every rank walks
    the blocks in the same order."""
    me = distributed.process_index()
    home = mesh.local_devices()[0]

    def owner(ij):
        return int(mesh.processes[_grid_index(mesh, *ij)])

    for d_ij in np.ndindex(dst.shape):
        d_rows, d_cols = dst_splits[0][d_ij[0]], dst_splits[1][d_ij[1]]
        for s_ij in np.ndindex(src.shape):
            s_rows, s_cols = src_splits[0][s_ij[0]], src_splits[1][s_ij[1]]
            rows, cols = _overlap(d_rows, s_rows), _overlap(d_cols, s_cols)
            if rows is None or cols is None:
                continue
            s_own, d_own = owner(s_ij), owner(d_ij)
            if me not in (s_own, d_own) and s_own == d_own:
                continue
            if s_own == me:
                block = src[s_ij][
                    rows.start - s_rows.start:rows.stop - s_rows.start,
                    cols.start - s_cols.start:cols.stop - s_cols.start,
                ]
            if s_own != d_own:
                buf = torch.zeros(
                    (rows.stop - rows.start, cols.stop - cols.start),
                    dtype=torch.float32,
                    device=home,
                )
                if s_own == me:
                    buf.copy_(block)
                block = distributed.allreduce_sum_(buf)
            if d_own == me:
                dst[d_ij][
                    rows.start - d_rows.start:rows.stop - d_rows.start,
                    cols.start - d_cols.start:cols.stop - d_cols.start,
                ] = block.to(dst[d_ij].device)


class ShardedGramian:
    """An (n, n) float32 Gramian as a tile grid laid out ``P(data,
    model)``.

    N is padded to ``n_padded``, a multiple of the grid's device count
    (the JAX package's rule), so every tile is ``(tile_rows, tile_cols)``;
    the padded rows and columns are zero and lie outside the logical
    (n, n) matrix. ``tiles[i, j]`` lives on the device at grid position
    (i, j). On a mesh that spans processes a rank holds only its own
    tiles (the others are ``None``, and ``is_fully_addressable`` is
    False), and :meth:`full`, :meth:`row_sums` and :meth:`matmul` are
    collectives that every rank calls, in the same order.
    """

    def __init__(self, tiles: np.ndarray, n: int, mesh: Mesh):
        local = [t for t in tiles.flat if t is not None]
        if not local:
            raise ValueError(
                f"process {distributed.process_index()} holds no device "
                f"of {mesh}: every rank of a pod needs a tile"
            )
        self.tiles = tiles
        self.n = n
        self.mesh = mesh
        self.spans = mesh_spans_processes(mesh)
        self.tile_rows, self.tile_cols = local[0].shape
        self.n_padded = self.tile_rows * tiles.shape[0]

    @classmethod
    def zeros(cls, n: int, mesh: Mesh, dtype=torch.float32):
        rows, cols = _grid_shape(mesh)
        n_padded = round_up_multiple(n, rows * cols)
        tiles = np.empty((rows, cols), dtype=object)
        for i, j in np.ndindex(rows, cols):
            if mesh.is_local(_grid_index(mesh, i, j)):
                tiles[i, j] = torch.zeros(
                    (n_padded // rows, n_padded // cols),
                    dtype=dtype,
                    device=_grid_device(mesh, i, j),
                )
        return cls(tiles, n, mesh)

    @classmethod
    def from_full(cls, g, mesh: Mesh):
        """Lay an (n, n) tensor or array out over ``mesh``: one copy per
        tile (this rank's tiles on a spanning mesh)."""
        g = torch.as_tensor(g)
        out = cls.zeros(g.shape[0], mesh, g.dtype)
        out.add_(g)
        return out

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def is_fully_addressable(self) -> bool:
        """Does this process hold every tile?"""
        return all(t is not None for t in self.tiles.flat)

    def local_tiles(self):
        """``((i, j), tile)`` for every tile this process holds, in grid
        order."""
        return [
            (ij, t) for ij, t in np.ndenumerate(self.tiles) if t is not None
        ]

    @property
    def dtype(self):
        return self.local_tiles()[0][1].dtype

    @property
    def device(self) -> torch.device:
        """The first local tile's device, where gathers and panels land."""
        return self.local_tiles()[0][1].device

    def tile_origin(self, i: int, j: int):
        """Row and column offset of tile (i, j) in the padded matrix."""
        return i * self.tile_rows, j * self.tile_cols

    def splits(self):
        """The global row and column slices of the tiles, clipped to n."""
        rows, cols = self.tiles.shape
        return (
            _split(self.n, rows, self.tile_rows),
            _split(self.n, cols, self.tile_cols),
        )

    def jax_tiles(self) -> np.ndarray:
        """This rank's tiles of G in the JAX package's split
        (:func:`jax_tile_splits`), as an object array like ``tiles``: a
        collective on a spanning grid, which every rank calls."""
        splits = jax_tile_splits(self.n, self.mesh)
        out = np.empty(self.tiles.shape, dtype=object)
        for (i, j), tile in self.local_tiles():
            rows, cols = splits[0][i], splits[1][j]
            out[i, j] = torch.zeros(
                (rows.stop - rows.start, cols.stop - cols.start),
                dtype=tile.dtype,
                device=tile.device,
            )
        _retile(self.mesh, self.tiles, self.splits(), out, splits)
        return out

    @classmethod
    def from_jax_tiles(cls, tiles: np.ndarray, n: int, mesh: Mesh):
        """The inverse of :meth:`jax_tiles`: a grid laid out from this
        rank's tiles in the JAX package's split (a collective on a
        spanning grid)."""
        g = cls.zeros(n, mesh)
        _retile(mesh, tiles, jax_tile_splits(n, mesh), g.tiles, g.splits())
        return g

    def add_(self, g) -> "ShardedGramian":
        """Add an (n, n) tensor or array, or a tile grid of the same
        layout, into this process's tiles, in place."""
        if isinstance(g, ShardedGramian):
            for (ij, tile) in self.local_tiles():
                tile += g.tiles[ij].to(tile.device)
            return self
        g = torch.as_tensor(g)
        for (i, j), tile in self.local_tiles():
            r0, c0 = self.tile_origin(i, j)
            part = g[r0:r0 + self.tile_rows, c0:c0 + self.tile_cols]
            tile[: part.shape[0], : part.shape[1]] += part.to(
                tile.device, tile.dtype
            )
        return self

    def full(self) -> torch.Tensor:
        """The whole (n, n) matrix on the first local tile's device. On a
        spanning grid this is the JAX package's replicate before dense
        eigh: every rank lays its tiles into a zero matrix and one
        all-reduce over the group sums them (each entry comes from one
        tile, so the sum is a copy)."""
        if not self.spans:
            rows = [
                torch.cat([t.to(self.device) for t in row], dim=1)
                for row in self.tiles
            ]
            return torch.cat(rows, dim=0)[: self.n, : self.n].contiguous()
        out = torch.zeros(
            (self.n_padded, self.n_padded), dtype=self.dtype,
            device=self.device,
        )
        for (i, j), tile in self.local_tiles():
            r0, c0 = self.tile_origin(i, j)
            out[r0:r0 + self.tile_rows, c0:c0 + self.tile_cols] = tile.to(
                out.device
            )
        distributed.allreduce_sum_(out)
        return out[: self.n, : self.n].contiguous()

    def _gather_rows(self, out: torch.Tensor, parts) -> None:
        """Add ``parts`` — one row-block result a local tile, each on its
        tile's device, in grid order — into ``out``, in grid order, one
        copy to ``out``'s device at a time. Every part is launched before
        this call: a copy between two cards makes each card's stream wait
        for the other's, so gathering one tile's result before the next
        tile's work is launched runs the cards one after another."""
        for ((i, j), _), part in zip(self.local_tiles(), parts):
            r0, _ = self.tile_origin(i, j)
            out[r0:r0 + self.tile_rows] += part.to(out.device)

    def row_sums(self) -> torch.Tensor:
        """Σ_j G[i, j] for the n rows, on the first local tile's device
        (one all-reduce of the partial sums on a spanning grid). Every
        tile's sum is launched on its own device before any is
        gathered."""
        sums = torch.zeros(
            self.n_padded, dtype=self.dtype, device=self.device
        )
        self._gather_rows(
            sums, [tile.sum(dim=1) for _, tile in self.local_tiles()]
        )
        if self.spans:
            distributed.allreduce_sum_(sums)
        return sums[: self.n]

    def matmul(self, q: torch.Tensor) -> torch.Tensor:
        """``G @ q`` for an (n, p) panel on the first local tile's device,
        in three passes: each column slab of q is copied once to each
        device whose tiles multiply it, every tile multiplies its slab on
        its own device, and only then are the products gathered and added
        in grid order. Tiles on several cards thus multiply at the same
        time; ``sharded_overlapped_products_total`` counts such products.
        On a spanning grid one all-reduce of the panel sums the ranks'
        parts."""
        dev = q.device
        qp = torch.zeros(
            (self.n_padded, q.shape[1]), dtype=q.dtype, device=dev
        )
        qp[: self.n] = q
        out = torch.zeros_like(qp)
        tiles = self.local_tiles()
        slabs = {}
        for (i, j), tile in tiles:
            if (tile.device, j) not in slabs:
                _, c0 = self.tile_origin(i, j)
                slabs[tile.device, j] = qp[c0:c0 + self.tile_cols].to(
                    tile.device
                )
        self._gather_rows(
            out, [tile @ slabs[tile.device, j] for (_, j), tile in tiles]
        )
        if len({tile.device for _, tile in tiles}) > 1:
            obs.get_registry().counter(
                "sharded_overlapped_products_total",
                "Tile-grid products G·Q whose tile GEMMs were launched on "
                "more than one device before any result was gathered",
            ).inc()
        if self.spans:
            distributed.allreduce_sum_(out)
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
    """Add ``X[rows_i] · X[cols_j]ᵀ`` to every local tile (i, j) of ``g``;
    ``x`` is one (n_padded, V) block, copied slab by slab to each tile's
    device."""
    for (i, j), tile in g.local_tiles():
        r0, c0 = g.tile_origin(i, j)
        rows = x[r0:r0 + g.tile_rows].to(tile.device)
        if (r0, g.tile_rows) == (c0, g.tile_cols):
            cols = rows
        else:
            cols = x[c0:c0 + g.tile_cols].to(tile.device)
        tile += mxu_cross_product_pair(
            rows, cols, tile.dtype, compute_dtype
        )


def _tile_dense_pod(
    g: ShardedGramian, xp: torch.Tensor, compute_dtype, mirror: bool
) -> None:
    """The pod dense tile step on a bit-packed (n_padded, V/8) panel — the
    ranks' packed blocks, concatenated along the variant axis (JAX
    ``sharded.py:744-815``): each local tile slices its row and column
    slabs of the PACKED panel (packing runs along the variant axis, so row
    slices are exact), unpacks only those two and adds their product.

    ``mirror`` (a square grid) splits each off-diagonal pair of tiles: the
    upper tile (i < j) computes only its top ``half`` rows, the lower one
    only its right ``tile_cols − half`` columns, and :func:`_mirror_fill`
    rebuilds both at the end; diagonal tiles compute in full. The product
    zero-pads the half slabs to the shapes ``torch._int_mm`` takes
    (``ops/gramian.py``)."""
    width = 8 * xp.shape[1]
    half = g.tile_rows // 2
    on_device = {}

    def slab(dev, start, count):
        if dev not in on_device:
            on_device[dev] = xp.to(dev)
        return unpack_indicator_block(
            on_device[dev][start:start + count], width
        )

    def mm(tile, row_start, n_rows, col_start, n_cols):
        rows = slab(tile.device, row_start, n_rows)
        if (row_start, n_rows) == (col_start, n_cols):
            cols = rows
        else:
            cols = slab(tile.device, col_start, n_cols)
        return mxu_cross_product_pair(rows, cols, tile.dtype, compute_dtype)

    for (i, j), tile in g.local_tiles():
        r0, c0 = g.tile_origin(i, j)
        if not mirror or i == j:
            tile += mm(tile, r0, g.tile_rows, c0, g.tile_cols)
        elif i < j:
            tile[:half, :] += mm(tile, r0, half, c0, g.tile_cols)
        else:
            tile[:, half:] += mm(
                tile, r0, g.tile_rows, c0 + half, g.tile_cols - half
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
    :class:`ShardedGramian`. On a mesh that spans processes the feed
    follows the mesh, as in the JAX package: each rank's blocks go
    through :func:`sharded_gramian_blockwise_global`.
    """
    if mesh_spans_processes(mesh):
        return sharded_gramian_blockwise_global(
            blocks, n_samples, mesh, compute_dtype=compute_dtype,
            accum_dtype=accum_dtype, packed=packed, prepacked=prepacked,
        )
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
        compute_dtype = _compute_dtype_of(x_dtype)

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


def _compute_dtype_of(x_dtype) -> torch.dtype:
    """The exact product for a block dtype: int8 blocks take the int8
    product, anything else float32."""
    return torch.int8 if np.dtype(x_dtype) == np.int8 else torch.float32


# dtype.num ↔ dtype for the cross-process dtype agreement (the gather
# moves int64 codes, not dtype objects): every block dtype a producer can
# emit (indicators, dosages, counts). The JAX package's table.
_DTYPE_BY_NUM = {
    np.dtype(t).num: np.dtype(t)
    for t in (
        np.bool_,
        np.int8,
        np.uint8,
        np.int16,
        np.int32,
        np.int64,
        np.float16,
        np.float32,
        np.float64,
    )
}


def _dtype_name(num: int):
    dt = _DTYPE_BY_NUM.get(num)
    return str(dt) if dt is not None else f"dtype.num={num}"


def _agreed_first_dtype(blocks):
    """Peek the first block and agree its dtype across the pod (JAX
    ``sharded.py:207-264``): a rank whose stream is empty would otherwise
    default to int8 while its peers compute in float. The raw code goes
    into the gather unvalidated (−1 an empty stream, −2 a failed peek) and
    is checked on identical gathered data, so every rank raises together.
    Returns the agreed dtype and the stream with its first block pushed
    back."""
    blocks = iter(blocks)
    peek_exc = None
    try:
        first = next(blocks, None)
    except Exception as e:  # noqa: BLE001 — re-raised below, synced
        peek_exc, first = e, None
    x_dtype = np.dtype(np.int8) if first is None else np.asarray(first).dtype
    if peek_exc is not None:
        local_num = -2
    else:
        local_num = -1 if first is None else x_dtype.num
    nums = distributed.allgather_ints([local_num]).ravel()
    failed = [i for i, v in enumerate(nums) if int(v) == -2]
    if failed:
        raise RuntimeError(
            "block stream failed on process(es) "
            f"{failed} while peeking the first block; raising "
            "on every process together (a one-sided raise "
            "would strand peers in the collective)"
        ) from peek_exc
    present = sorted({int(v) for v in nums if v >= 0})
    unsupported = [n for n in present if n not in _DTYPE_BY_NUM]
    if unsupported:
        raise ValueError(
            "unsupported block dtype(s) in the pod-mode stream: "
            f"{[_dtype_name(n) for n in unsupported]}; supported: "
            f"{sorted(str(d) for d in _DTYPE_BY_NUM.values())}"
        )
    if len(present) > 1:
        raise ValueError(
            "block dtypes differ across processes: "
            f"{[_dtype_name(n) for n in present]}; "
            "every host must stream the same block dtype"
        )
    if present:
        x_dtype = _DTYPE_BY_NUM[present[0]]
    if first is not None:
        blocks = itertools.chain((first,), blocks)
    return x_dtype, blocks


def _synced_block_stream(local_blocks, n_samples: int, fill_dtype=np.int8):
    """Per-step width/liveness-synced blocks from per-rank streams (JAX
    ``sharded.py:455-557``).

    Every rank learns every peer's block width (−1 = exhausted) BEFORE any
    accumulation: a width mismatch raises on all ranks together, and an
    exhausted rank zero-fills at the peers' width until every stream
    drains (zero columns are inert in the Gramian). The same header
    carries each block's dtype.num and row count, checked per step, and a
    producer exception (width code −2) — the upstream generator runs
    host-side validation whose raise would otherwise fire on ONE rank —
    so every rank raises together, the failing one chaining its original
    exception. The header ``[w, dtype.num, rows]`` is all-gathered
    through the process group, on the calling (consumer) thread.
    ``n_samples`` is the padded N. Yields host blocks.
    """
    fill_dtype = np.dtype(fill_dtype)
    expected_num = fill_dtype.num
    it = iter(local_blocks)
    while True:
        exc = None
        try:
            block = next(it, None)
        except Exception as e:  # noqa: BLE001 — synced below, see docstring
            exc, block = e, None
        if exc is not None:
            w, num, rows = -2, -1, -1
        elif block is None:
            w, num, rows = -1, -1, -1
        else:
            block = np.asarray(block)
            w, num, rows = (
                int(block.shape[1]), block.dtype.num, int(block.shape[0])
            )
        peer_info = distributed.allgather_ints([w, num, rows]).reshape(-1, 3)
        failed = [
            i for i, (x, _, _) in enumerate(peer_info) if int(x) == -2
        ]
        if failed:
            # exc is None on healthy peers — `from None` is a no-op there.
            raise RuntimeError(
                "block stream failed on process(es) "
                f"{failed}; raising on every process together (a "
                "one-sided raise would strand peers in the next "
                "collective)"
            ) from exc
        bad_rows = sorted(
            {int(r) for x, _, r in peer_info if x >= 0 and r != n_samples}
        )
        if bad_rows:
            raise ValueError(
                f"block row counts {bad_rows} differ from the padded "
                f"sample count {n_samples}; every host must stream "
                "blocks over the full (padded) sample axis"
            )
        live = sorted({int(x) for x, _, _ in peer_info if x >= 0})
        if not live:
            return
        bad_nums = sorted(
            {int(n) for x, n, _ in peer_info if x >= 0 and n != expected_num}
        )
        if bad_nums:
            raise ValueError(
                "block dtype diverged mid-stream: got "
                f"{[_dtype_name(n) for n in bad_nums]} where the stream "
                f"was resolved as {_dtype_name(expected_num)}; every host "
                "must stream one dtype for the whole accumulation"
            )
        if len(live) > 1:
            raise ValueError(
                "block widths differ across processes in the same step: "
                f"{live}; every host must stream fixed-width blocks "
                "(blocks_from_calls pads) with the same --block-variants"
            )
        if block is None:
            block = np.zeros((n_samples, live[0]), fill_dtype)
        yield block


def _pod_blocks(blocks, n_samples: int, n_padded: int, packed: bool,
                prepacked: bool):
    """The pod accumulators' shared front: the agreed first-block dtype,
    the rows padded to ``n_padded``, packing, and the synced stream.
    Returns ``(x_dtype, stream)``."""
    if packed or prepacked:
        x_dtype = np.dtype(np.int8)
    else:
        x_dtype, blocks = _agreed_first_dtype(blocks)

    def padded_blocks():
        # A mid-stream dtype change is caught by the synced per-step
        # check, on every rank together.
        for block in blocks:
            xb = np.asarray(block)
            if n_padded != n_samples:
                xb = np.pad(xb, ((0, n_padded - n_samples), (0, 0)))
            if packed and not prepacked:
                xb = pack_indicator_block(xb)
            yield xb

    # A drained rank's zero fill has the agreed dtype, so its peers build
    # every step from one dtype.
    fill = np.dtype(np.uint8) if packed or prepacked else x_dtype
    return x_dtype, _synced_block_stream(padded_blocks(), n_padded, fill)


def gramian_blockwise_global(
    local_blocks,
    n_samples: int,
    mesh: Mesh,
    compute_dtype=None,
    accum_dtype=torch.float32,
    packed: bool = False,
    prepacked: bool = False,
    prefetch_depth: int = 2,
) -> torch.Tensor:
    """Pod blockwise Gramian with G replicated on every rank (JAX
    ``sharded.py:415-452``).

    Each rank feeds its own variant columns (its slice of the shard
    manifest) through :func:`_synced_block_stream` and adds each synced
    block's product into its own replica of G through the ``_int_mm``
    route; one chunked all-reduce over the process group sums the
    replicas at the end. The counts are exact integers, so G is the JAX
    package's per-step reduction bit for bit. Ranks may feed different
    numbers of blocks: an exhausted rank adds zero columns. Returns the
    (n, n) tensor on this rank's device, the same on every rank. On a
    mesh of one process it is the meshless accumulator on the mesh's
    first device.
    """
    local = mesh.local_devices()
    if not local:
        raise ValueError(
            f"process {distributed.process_index()} holds no device of "
            f"{mesh}: every rank of a pod needs one"
        )
    dev = local[0]
    if not mesh_spans_processes(mesh):
        from spark_examples_tpu_torch.ops.gramian import gramian_blockwise

        return gramian_blockwise(
            local_blocks, n_samples, compute_dtype=compute_dtype,
            accum_dtype=accum_dtype, packed=packed, prepacked=prepacked,
            prefetch_depth=prefetch_depth, device=dev,
        )
    x_dtype, stream = _pod_blocks(
        local_blocks, n_samples, n_samples, packed, prepacked
    )
    if compute_dtype is None:
        compute_dtype = _compute_dtype_of(x_dtype)
    g = torch.zeros((n_samples, n_samples), dtype=accum_dtype, device=dev)
    for b, xb in enumerate(stream):
        with obs.span(GRAMIAN_ACCUMULATE, block=b, pod=True):
            x = torch.from_numpy(np.ascontiguousarray(xb)).to(dev)
            if packed or prepacked:
                x = unpack_indicator_block(x, 8 * x.shape[1])
            g += mxu_cross_product(x, g.dtype, compute_dtype)
    with obs.span("allreduce_gramian", n=int(n_samples), pod=True):
        distributed.allreduce_sum_(g)
    return g


def sharded_gramian_blockwise_global(
    local_blocks,
    n_samples: int,
    mesh: Mesh,
    compute_dtype=None,
    accum_dtype=torch.float32,
    packed: bool = False,
    prepacked: bool = False,
    prefetch_depth: int = 2,
) -> ShardedGramian:
    """Pod blockwise Gramian with G *sample-sharded* over the mesh (JAX
    ``sharded.py:560-596``).

    G lives as a tile grid ``P(data, model)`` across the whole pod while
    each rank feeds its own variant columns. Each synced step all-gathers
    the ranks' blocks (bit-packed with ``packed``/``prepacked``) along the
    variant axis through the process group; each local tile then takes
    its row and column slabs of the gathered block and adds ``rows ·
    colsᵀ`` (:func:`_tile_dense_pod` without the mirror). The per-step
    sync and zero fill are :func:`gramian_blockwise_global`'s. Returns
    this rank's share of the grid. On a mesh of one process it is
    :func:`sharded_gramian_blockwise`.
    """
    if not mesh_spans_processes(mesh):
        return sharded_gramian_blockwise(
            local_blocks, n_samples, mesh, accum_dtype=accum_dtype,
            compute_dtype=compute_dtype, packed=packed, prepacked=prepacked,
            prefetch_depth=prefetch_depth,
        )
    g = ShardedGramian.zeros(n_samples, mesh, accum_dtype)
    x_dtype, stream = _pod_blocks(
        local_blocks, n_samples, g.n_padded, packed, prepacked
    )
    if compute_dtype is None:
        compute_dtype = _compute_dtype_of(x_dtype)
    for b, xb in enumerate(stream):
        with obs.span(GRAMIAN_ACCUMULATE, block=b, sharded=True, pod=True):
            x = torch.from_numpy(np.ascontiguousarray(xb)).to(g.device)
            x = distributed.allgather_concat(x, dim=1)
            if packed or prepacked:
                _tile_dense_pod(g, x, compute_dtype, mirror=False)
            else:
                _accumulate_tiles(g, x, compute_dtype)
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
    over ``mesh``: the union over the tiles this process holds (every
    tile of a single-controller mesh, so the full range there)."""
    rows, cols = _grid_shape(mesh)
    t_r, t_c = n // rows, n // cols
    return sample_bounds_of_indices(
        (
            (slice(i * t_r, (i + 1) * t_r), slice(j * t_c, (j + 1) * t_c))
            for i, j in np.ndindex(rows, cols)
            if mesh.is_local(_grid_index(mesh, i, j))
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


def _mirror_operands(li: torch.Tensor, lj: torch.Tensor, i: int, j: int,
                     tile_rows: int, tile_cols: int):
    """The mirror's slab masks on tile (i, j)'s operands (JAX
    ``sharded.py:711-725``): above the diagonal the tile keeps its top
    ``half`` rows, below it its right ``tile_cols − half`` columns; every
    other index becomes the sentinel. The diagonal keeps everything."""
    half = tile_rows // 2
    if i < j:
        li = torch.where(li >= half, tile_rows, li).to(torch.int32)
    elif i > j:
        lj = torch.where(lj < half, tile_cols, lj).to(torch.int32)
    return li.contiguous(), lj.contiguous()


def _tile_scatter(g: ShardedGramian, idx, mirror: bool = False) -> None:
    """One scatter window into every local tile: one :func:`~spark_
    examples_tpu_torch.ops.scatter_kernel.scatter_pairs` call per tile
    (the kernel on a CUDA tile, its plain version on a CPU one), on
    rebased operands; ``mirror`` masks them to the mirror slabs."""
    idx = torch.as_tensor(idx)
    on_device = {}
    for (i, j), tile in g.local_tiles():
        if tile.device not in on_device:
            on_device[tile.device] = idx.to(tile.device)
        r0, c0 = g.tile_origin(i, j)
        li, lj = _tile_operands(
            on_device[tile.device], r0, g.tile_rows, c0, g.tile_cols
        )
        if mirror:
            li, lj = _mirror_operands(
                li, lj, i, j, g.tile_rows, g.tile_cols
            )
        scatter_pairs(tile, li, lj)


def _mirror_fill(g: ShardedGramian) -> None:
    """Rebuild the mirror's skipped halves (JAX ``sharded.py:817-862``):
    for each off-diagonal pair, the upper tile (i, j) takes rows
    ``[half, t)`` from its partner's column slab, transposed, and the
    lower tile (j, i) takes columns ``[0, half)`` from its partner's row
    slab, transposed — exact copies of exact counts. A pair on one rank is
    copied in place; a pair across ranks swaps its slabs with one batch of
    point-to-point sends and receives through the process group, every
    rank posting its pairs in the same (upper-tile, row-major) order."""
    import torch.distributed as dist

    half = g.tile_rows // 2
    rows, cols = g.tiles.shape
    rank = distributed.process_index()
    ops, fills = [], []
    for i in range(rows):
        for j in range(i + 1, cols):
            up, lo = g.tiles[i, j], g.tiles[j, i]
            if up is not None and lo is not None:
                # Rows [half, t) of the upper tile first: they read only
                # the lower tile, whose columns [0, half) are then
                # filled from the upper tile's untouched rows [0, half).
                up[half:, :] = lo[:, half:].t().to(up.device)
                lo[:, :half] = up[:half, :].t().to(lo.device)
                continue
            if up is not None:
                peer = _grid_owner(g.mesh, j, i)
                send = up[:half, :].contiguous()
                recv = torch.empty(
                    (g.tile_rows, g.tile_cols - half), dtype=up.dtype,
                    device=up.device,
                )
                fills.append((up, "upper", recv))
            elif lo is not None:
                peer = _grid_owner(g.mesh, i, j)
                send = lo[:, half:].contiguous()
                recv = torch.empty(
                    (half, g.tile_cols), dtype=lo.dtype, device=lo.device
                )
                fills.append((lo, "lower", recv))
            else:
                continue
            tag = i * cols + j
            ops.append(dist.P2POp(dist.isend, send, peer, tag=tag))
            ops.append(dist.P2POp(dist.irecv, recv, peer, tag=tag))
    if ops:
        with obs.span("gramian.mirror_fill", rank=rank, pairs=len(fills)):
            for work in dist.batch_isend_irecv(ops):
                work.wait()
    for tile, side, recv in fills:
        if side == "upper":
            tile[half:, :] = recv.t()
        else:
            tile[:, :half] = recv.t()


# Route codes on the pod header (field 0 doubles as the liveness code):
# −2 a producer exception, −1 an exhausted stream, else the step's
# density route. The JAX package's codes.
_ROUTE_CODES = {"scatter": 0, "dense": 1}
_ROUTE_OF_CODE = {v: k for k, v in _ROUTE_CODES.items()}
# Each route's payload dtype, which rides the header: int32 carrier
# matrices on scatter steps, packed uint8 panels on dense ones.
_PAYLOAD_DTYPES = {"scatter": np.dtype(np.int32), "dense": np.dtype(np.uint8)}


def _synced_carrier_stream(
    windows,
    n_samples: int,
    n_padded: int,
    density_threshold: float,
    dense_width: int,
    v_div: int,
    pipeline_depth: int = 2,
    coalesce_variants: Optional[int] = None,
):
    """The pipelined per-step header and carrier exchange of a pod's CSR
    streams — the sparse twin of :func:`_synced_block_stream` (JAX
    ``sharded.py:879-1360``), over the host exchange of
    :mod:`~spark_examples_tpu_torch.parallel.podstream`.

    Per step every rank FIRST agrees a small header — ``[route/liveness
    code, k_max, variant rows, payload dtype.num, nnz, windows, check
    flag]`` — and only then builds and exchanges the payload. The whole
    protocol step (the header, the payload's host construction, its
    confirm and the carrier exchange) runs on a sync thread
    ``pipeline_depth`` slots ahead of the consumer's kernels (``0`` is
    inline lockstep). The failure discipline holds slot by slot:

    - an exhausted rank posts −1 and keeps feeding inert payloads
      (all-sentinel carrier rows, zero packed columns) until every stream
      drains;
    - a producer exception posts −2 and every rank raises together at the
      SAME slot, the failing one chaining its exception; a payload that
      fails to build after the header is caught by the confirm exchange
      before any payload moves;
    - the density route is a per-step GLOBAL decision (a divergent step
      raises on every rank together);
    - carrier widths need not agree: every rank pads to the power-of-two
      bucket of the GLOBAL max width and the global max row count;
    - consecutive scatter-route windows COALESCE into one gang per step
      until their variant rows reach ``coalesce_variants`` (a dense
      window ends the gang and becomes its own step) — bit-identical at
      any split;
    - with ``SPARK_EXAMPLES_TPU_TORCH_COLLECTIVE_CHECK`` on every rank,
      each step's derived geometry is digested and cross-checked
      (:mod:`~spark_examples_tpu_torch.utils.collectivecheck`).

    Scatter steps exchange the padded ``(rows, k_bucket)`` int32 carrier
    matrices over the sockets (a drained peer's inert block is made
    locally from its header); dense steps carry this rank's packed panel,
    which the consumer all-gathers through the process group. Yields
    ``(route, payload, local_nnz, local_variants, step, local_windows,
    stream_id)``: the payload is a CPU tensor — the global carrier matrix,
    or this rank's packed panel — built HERE, on the consumer thread; the
    sync thread never touches torch.
    """
    from spark_examples_tpu_torch.parallel.podstream import (
        PodSlot,
        PodWindowExchange,
        SlotPipeline,
    )
    from spark_examples_tpu_torch.utils import collectivecheck

    if coalesce_variants is None:
        coalesce_variants = DEFAULT_POD_COALESCE_VARIANTS
    if pipeline_depth < 0:
        raise ValueError(
            f"--pod-pipeline-depth must be >= 0, got {pipeline_depth}"
        )
    world = distributed.process_count()
    pid = distributed.process_index()
    exchange = PodWindowExchange.open()
    if exchange is None:
        raise RuntimeError(
            "process-spanning sparse accumulation needs a process group "
            "of more than one rank for its host-side window exchange; "
            "join one via parallel.distributed.initialize_from_env"
        )

    it = iter(windows)
    pushback: list = []

    def _pull():
        if pushback:
            return pushback.pop()
        return next(it, None)

    def _gang():
        """This step's local windows: ``[]`` when drained, ONE
        dense-route window, or 1+ scatter-route windows coalesced until
        the variant-row total reaches ``coalesce_variants``."""
        first = _pull()
        if first is None:
            return [], None
        idx = np.asarray(first[0], dtype=np.int64)
        lens = np.asarray(first[1], dtype=np.int64)
        _check_indices(idx, n_samples)
        route = window_route(lens, n_samples, density_threshold)
        gang = [(idx, lens)]
        if route == "dense":
            return gang, route
        total = int(lens.size)
        while total < coalesce_variants:
            nxt = _pull()
            if nxt is None:
                break
            nidx = np.asarray(nxt[0], dtype=np.int64)
            nlens = np.asarray(nxt[1], dtype=np.int64)
            _check_indices(nidx, n_samples)
            if window_route(nlens, n_samples, density_threshold) != "scatter":
                # A dense window ends the gang and becomes the NEXT step.
                pushback.append((nidx, nlens))
                break
            gang.append((nidx, nlens))
            total += int(nlens.size)
        return gang, "scatter"

    def _span(step, phase):
        return obs.span(
            "gramian.sparse.allgather", step=step, phase=phase,
            stream=exchange.stream, processes=world,
        )

    def _produce_step(step):
        exc = None
        gang: list = []
        code, k_max, rows, num, nnz, nwin = -1, -1, -1, -1, 0, 0
        try:
            gang, route_local = _gang()
            if gang:
                all_lens = [lens for _, lens in gang]
                code = _ROUTE_CODES[route_local]
                k_max = max(
                    (int(lens.max()) if lens.size else 0)
                    for lens in all_lens
                )
                rows = sum(int(lens.size) for lens in all_lens)
                nnz = sum(int(lens.sum()) for lens in all_lens)
                nwin = len(gang)
                num = _PAYLOAD_DTYPES[route_local].num
        except Exception as e:  # noqa: BLE001 — synced below
            exc, code = e, -2
        check_flag = 1 if collectivecheck.collective_check_enabled() else 0
        with _span(step, "header"):
            exchange.post_header(
                step,
                np.array(
                    [code, k_max, rows, num, nnz, nwin, check_flag],
                    np.int64,
                ),
            )
            peer_info = exchange.gather_headers(step, 7)
        failed = [i for i, row in enumerate(peer_info) if int(row[0]) == -2]
        if failed:
            _note_pod_sync("producer-error")
            raise RuntimeError(
                "carrier stream failed on process(es) "
                f"{failed}; raising on every process together (a "
                "one-sided raise would strand peers in the next "
                "collective)"
            ) from exc
        live = peer_info[peer_info[:, 0] >= 0]
        if live.size == 0:
            _note_pod_sync("drained")
            exchange.close()
            return None
        routes = sorted({int(c) for c in live[:, 0]})
        if len(routes) > 1:
            _note_pod_sync("route-divergence")
            per_proc = {
                i: _ROUTE_OF_CODE[int(row[0])]
                for i, row in enumerate(peer_info)
                if int(row[0]) >= 0
            }
            raise ValueError(
                "sparse pod streams disagree on the density route "
                f"for the same step: {per_proc}; the route is a "
                "per-window GLOBAL decision (both routes are "
                "collective programs) — pin "
                "--sparse-density-threshold to one side for "
                "heterogeneous cohorts"
            )
        nums = sorted({int(n) for n in live[:, 3]})
        if len(nums) > 1:
            # The dtype derives from the agreed route, so only a
            # version-skewed pod reaches this.
            _note_pod_sync("dtype-divergence")
            raise ValueError(
                "sparse pod payload dtypes diverged in the same "
                f"step: {[_dtype_name(n) for n in nums]}; every "
                "host must stream one payload dtype (the dtype "
                "derives from the agreed route — divergence means "
                "a version-skewed pod)"
            )
        route = _ROUTE_OF_CODE[routes[0]]
        g_rows = _pad_rows_for_scan(int(live[:, 2].max()))
        # The step's derived geometry, from the gathered (identical)
        # headers: the carrier bucket on scatter steps, the pow2 panel
        # width on dense ones.
        bucket = g_dense = 0
        payload_num = nums[0]
        if route == "scatter":
            bucket = _carrier_bucket(int(live[:, 1].max()))
            geometry = (g_rows, bucket, world, n_padded, payload_num)
        else:
            g_dense = dense_panel_width(int(live[:, 2].max()), dense_width)
            geometry = (g_dense, v_div, world, n_padded, payload_num)
        if bool((live[:, 6] == 1).all()):
            digest = collectivecheck.step_digest(
                exchange.stream,
                step,
                [("header", (world, 7)), (route, geometry)],
            )
            with _span(step, "check"):
                exchange.post_check(step, digest)
                digests = exchange.gather_checks(step)
            collectivecheck.verify_step_digests(step, digests, digest)
        # The local payload is host numpy work that can fail one-sided
        # AFTER the header committed every peer to this step, so it runs
        # under its own try and the confirm exchange agrees success
        # before any payload moves.
        payload_exc = None
        local = None
        try:
            if route == "scatter":
                if gang:
                    local = padded_carrier_matrix(
                        np.concatenate([idx for idx, _ in gang]),
                        np.concatenate([lens for _, lens in gang]),
                        sentinel=n_padded,
                        n_rows=g_rows,
                        k_bucket=bucket,
                    )
                # A drained rank posts nothing: every peer makes its inert
                # all-sentinel block from its −1 header.
            else:
                if gang:
                    xp = _dense_operand(
                        gang[0][0], gang[0][1], n_samples, g_dense, n_padded
                    )
                else:
                    xp = pack_indicator_block(
                        np.zeros((n_padded, g_dense), dtype=np.int8)
                    )
                cols = round_up_multiple(xp.shape[1], v_div)
                if cols != xp.shape[1]:
                    # Zero bytes unpack to inert zero columns; every rank
                    # derives the same width from the same header.
                    xp = np.pad(xp, ((0, 0), (0, cols - xp.shape[1])))
                local = xp
        except Exception as e:  # noqa: BLE001 — synced just below
            payload_exc = e
        with _span(step, "confirm"):
            exchange.post_confirm(step, payload_exc is None)
            confirm = exchange.gather_confirms(step)
        bad = [i for i, v in enumerate(confirm) if int(v) == -2]
        if bad:
            _note_pod_sync("producer-error")
            raise RuntimeError(
                "carrier payload construction failed on "
                f"process(es) {bad}; raising on every process "
                "together (a one-sided raise would strand peers "
                "in the payload collective)"
            ) from payload_exc
        gathered = None
        if route == "scatter":
            with _span(step, "carrier"):
                if local is not None:
                    exchange.post_payload(step, local)
                inert = np.full((g_rows, bucket), n_padded, np.int32)
                parts = []
                for p in range(world):
                    if p == pid:
                        parts.append(local if local is not None else inert)
                    elif int(peer_info[p, 0]) >= 0:
                        parts.append(
                            exchange.get_payload(step, p, (g_rows, bucket))
                        )
                    else:
                        parts.append(inert)
                gathered = np.concatenate(parts, axis=0)
        _note_pod_sync("synced")
        _note_pod_gang(nwin)
        return PodSlot(
            step=step,
            route=route,
            gathered=gathered,
            local=local,
            nnz=nnz,
            variants=max(rows, 0),
            windows=nwin,
        )

    state = {"step": 0}

    def _produce():
        step = state["step"]
        with obs.span(
            "gramian.sparse.slot", step=step, depth=pipeline_depth,
            stream=exchange.stream, processes=world,
        ):
            slot = _produce_step(step)
        state["step"] = step + 1
        return slot

    # A SYNCHRONIZED protocol failure (raised by next(): every rank raised
    # at the same frame boundary) propagates as it is and the mesh stays
    # usable. A ONE-SIDED abandonment — this rank's consumer dying, which
    # lands here as an exception at the yield — may leave the sync thread
    # blocked mid-read with peers' frames on the pipes, so the mesh is
    # poisoned: a later stream fails loudly instead of desyncing.
    pipe_iter = iter(SlotPipeline(_produce, pipeline_depth))
    while True:
        try:
            slot = next(pipe_iter)
        except StopIteration:
            return
        try:
            if slot.route == "scatter":
                payload = torch.from_numpy(slot.gathered)
            else:
                payload = torch.from_numpy(slot.local)
            item = (
                slot.route, payload, slot.nnz, slot.variants, slot.step,
                slot.windows, exchange.stream,
            )
        except BaseException:
            exchange.poison()
            raise
        try:
            yield item
        except BaseException:
            exchange.poison()
            raise


def sparse_sharded_gramian_blockwise(
    windows,
    n_samples: int,
    mesh: Mesh,
    density_threshold: Optional[float] = None,
    block_variants: Optional[int] = None,
    pipeline_depth: int = 2,
    coalesce_variants: Optional[int] = None,
) -> ShardedGramian:
    """Stream CSR carrier windows into a mesh-sharded (tiled) Gramian.

    G is float32. On a single-controller mesh the windows run through the
    meshless engine's window step
    (:func:`~spark_examples_tpu_torch.ops.sparse._accumulate_windows`)
    against ``n_padded`` rows: a rare window's padded carrier matrix
    (sentinel ``n_padded``) is copied to every tile's device, re-based
    into each tile's frame and scattered there (:func:`_tile_scatter`); a
    dense window's packed panel is unpacked and added to every tile as an
    int8 product (:func:`_accumulate_tiles`). Both routes add exact
    integer counts, so G is bit-identical to the meshless engine's at any
    mesh shape and window order.

    On a mesh that SPANS processes each rank feeds its own windows through
    :func:`_synced_carrier_stream` (``pipeline_depth``,
    ``coalesce_variants``): a scatter step re-bases the concatenated
    global carrier matrix into each local tile's frame and launches the
    kernel once per local tile; a dense step all-gathers the ranks'
    packed panels and runs :func:`_tile_dense_pod`. On a square grid
    larger than 1×1 the mirror is on (JAX ``sharded.py:1462-1464``): the
    off-diagonal tiles compute their slabs and :func:`_mirror_fill`
    rebuilds them at the end. Pod ingest ships full sample-range windows
    (each rank is the source of its variants for every peer's tiles).
    """
    if density_threshold is None:
        density_threshold = DEFAULT_SPARSE_DENSITY_THRESHOLD
    g = ShardedGramian.zeros(n_samples, mesh)
    n_padded = g.n_padded
    with obs.span("gramian.sparse.accumulate", n=n_samples, sharded=True):
        if g.spans:
            grid_rows, grid_cols = g.tiles.shape
            mirror = grid_rows == grid_cols and grid_rows > 1
            stream = _synced_carrier_stream(
                windows,
                n_samples,
                n_padded,
                density_threshold,
                block_variants or DEFAULT_BLOCK_VARIANTS,
                _axis_product(mesh, (tuple(mesh.axis_names),)),
                pipeline_depth=pipeline_depth,
                coalesce_variants=coalesce_variants,
            )
            for route, payload, nnz, n_variants, step, n_win, stream_id in (
                stream
            ):
                with obs.span(
                    "gramian.sparse.window",
                    route=route,
                    nnz=nnz,
                    variants=n_variants,
                    step=step,
                    stream=stream_id,
                    windows=n_win,
                ):
                    if route == "scatter":
                        _tile_scatter(g, payload, mirror=mirror)
                    else:
                        xp = distributed.allgather_concat(
                            payload.to(g.device), dim=1
                        )
                        _tile_dense_pod(g, xp, torch.int8, mirror)
                _note_window(route, nnz, count=n_win)
            if mirror:
                _mirror_fill(g)
            return g
        _accumulate_windows(
            windows, n_samples, density_threshold, block_variants, n_padded,
            scatter=lambda idx: _tile_scatter(g, idx),
            add_packed=lambda xp: _accumulate_tiles(g, unpack_indicator_block(
                torch.from_numpy(xp).to(g.device), 8 * xp.shape[1]
            ), torch.int8),
        )
    return g


class CenteredGramian:
    """The centred matrix C = H·G·H (H = I − 11ᵀ/n) of a tile grid, as an
    operator: :meth:`matmul` gives C·Q from the grid's own ``G @ Q`` and
    G's row sums r, and C is never formed. For symmetric G (a Gramian),
    with s = Σr,

        C·Q = G·Q − r·(1ᵀQ)/n − 1·(rᵀQ)/n + (s/n²)·1·(1ᵀQ),

    which is ``ops/centering.py``'s ``g − rowmean − colmean + grandmean``
    applied to Q. The rank-one corrections are computed in float64 on the
    first local tile's device, added to ``G @ Q`` there and the sum cast
    back to the panel's dtype; rows past n never enter (``matmul`` drops
    them). The card holds G's tiles and a few (n, p) panels, and G is left
    as it was.

    ``row_sums`` are G's row sums where the caller has them already (a
    spanning grid's, all-reduced, on every rank); else they are read from
    the tiles, a collective on a spanning grid, in one
    :data:`~spark_examples_tpu_torch.utils.tracing.PCOA_TILES_SUMS` span.
    Each product is one
    :data:`~spark_examples_tpu_torch.utils.tracing.PCOA_TILES_PRODUCT`
    span and adds one to ``sharded_centered_products_total``. Under a
    profiler or a telemetry session each span ends when the cards' work
    does; untraced, the host does not wait (the panel's QR that follows
    waits for the product all the same).
    """

    def __init__(self, g: ShardedGramian, row_sums=None):
        self.g = g
        self.n = g.n
        self.device = g.device
        self.dtype = g.dtype
        if row_sums is None:
            with obs.span(PCOA_TILES_SUMS, n=self.n):
                row_sums = g.row_sums()
                _wait_if_traced(self.device)
        self.r = torch.as_tensor(row_sums).to(self.device, torch.float64)
        self.s = self.r.sum()
        self.products = 0

    @property
    def shape(self):
        return (self.n, self.n)

    def matmul(self, q: torch.Tensor) -> torch.Tensor:
        """``C @ q`` for an (n, p) panel on the first local tile's
        device."""
        self.products += 1
        with obs.span(PCOA_TILES_PRODUCT, products=self.products, n=self.n):
            y = self.g.matmul(q)
            q64 = q.to(torch.float64)
            ones_q = q64.sum(dim=0)  # 1ᵀQ
            r_q = self.r @ q64  # rᵀQ
            n = self.n
            out = (
                y.to(torch.float64)
                - self.r[:, None] * (ones_q / n)
                - r_q / n
                + (self.s / (n * n)) * ones_q
            ).to(q.dtype)
            _wait_if_traced(out.device)
        obs.get_registry().counter(
            "sharded_centered_products_total",
            "Products C·Q of an implicitly centred tile grid",
        ).inc()
        return out


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
    timer=None,
    gap_warn_ratio: float = 0.95,
    tol: Optional[float] = None,
    check_every: int = 5,
):
    """Top-|λ| eigenpairs of symmetric C by randomized subspace iteration.

    ``c`` is an (n, n) tensor or any operator with ``matmul``, ``shape``,
    ``device`` and ``dtype`` (a :class:`CenteredGramian` of a tile grid);
    the only O(n²) op is ``C @ Q`` against an (n, k+p) panel, tile by tile
    on a grid, and the QR of the panel runs on the first device. Returns
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
    product = c.matmul

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
    row_sums=None,
):
    """Center + top-k eigenvectors of a mesh-sharded Gramian.

    ``g`` is a :class:`ShardedGramian` (a tensor or array is laid out over
    ``mesh`` first); its tiles are left as they are. For n ≤
    ``dense_eigh_limit`` G is gathered, double-centered and dense
    ``eigh`` runs with the spectral-gap check on one extra eigenpair;
    above it randomized subspace iteration runs on the tiles through a
    :class:`CenteredGramian`, which takes ``row_sums`` (G's, where the
    caller has read them) or reads them. Returns host ``(coords (n, k),
    vals (k,))`` arrays.
    """
    if not isinstance(g, ShardedGramian):
        g = ShardedGramian.from_full(g, mesh)
    n = g.n
    if n <= dense_eigh_limit:

        def dense(kk):
            coords, vals = pcoa(g.full(), kk)
            return coords.cpu().numpy(), vals.cpu().numpy()

        return topk_with_gap_check(dense, k, n, timer=timer)
    coords, vals = topk_eig_randomized(
        CenteredGramian(g, row_sums), k, timer=timer, tol=eig_tol
    )
    return coords.cpu().numpy(), vals.cpu().numpy()


# -- Gramian-free sketch panels (ops/sketch.py's mesh half) ------------------


def _flat_devices(mesh: Mesh):
    """``(device, owner)`` for every device of ``mesh`` in row-major
    order: the device axis the JAX package flattens every mesh axis into
    (``P(all_axes)``), so block ``d`` of a row-split panel lives on
    entry ``d``."""
    return list(zip(mesh.devices.flat, (int(p) for p in mesh.processes.flat)))


def _sketch_pod_scatter(y: torch.Tensor, om: torch.Tensor, idx) -> None:
    """A pod scatter step into the replicated panel: the step's global
    carrier matrix (every rank's rows, sentinel ``n_padded``) back to CSR
    form and through the meshless scatter update. Every rank applies the
    same pairs, so the replicas stay equal."""
    from spark_examples_tpu_torch.ops.sketch import _sketch_scatter_update

    idx = np.asarray(idx)
    real = idx < y.shape[0]
    _sketch_scatter_update(
        y, om, idx[real].astype(np.int64), real.sum(axis=1).astype(np.int64)
    )


def _sketch_pod_dense_contrib(
    xp_local: torch.Tensor, om: torch.Tensor
) -> torch.Tensor:
    """One rank's card work on a dense pod step of the sketch panel: its
    own packed variant columns unpacked, and ``X_loc·(X_locᵀ·Ω̃)`` in
    float32 on ``om``'s device."""
    xb = unpack_indicator_block(
        xp_local.to(om.device), 8 * xp_local.shape[1]
    ).to(om.dtype)
    return (xb @ (xb.T @ om)).contiguous()


def _sketch_pod_dense_step(
    y: torch.Tensor, xp_local: torch.Tensor, om: torch.Tensor
) -> None:
    """The dense-route pod step of the sketch panel (JAX
    ``_sketch_pod_dense_kernel``): this rank's contribution
    (:func:`_sketch_pod_dense_contrib`), and one all-reduce over the group
    sums the ranks' contributions into every replica. No (N, V) unpack
    leaves a rank."""
    contrib = _sketch_pod_dense_contrib(xp_local, om)
    distributed.allreduce_sum_(contrib)
    y += contrib


def sketch_tsqr(y, mesh: Mesh):
    """Tall-skinny QR of an (n_padded, l) panel over the mesh's row blocks
    (JAX ``sketch_tsqr``): the sketch finish's factorization.

    The rows split into one block a device of the mesh, every axis
    flattened (:func:`_flat_devices`). Each local block gets a thin QR on
    its device; the (l, l) R factors are gathered (from the local list
    on a single-controller mesh, through the process group on a pod);
    one QR of the stacked (D·l, l) factors runs on every rank; each block
    composes its Q with its slice of the second-level Q. Returns
    ``(q, r)``: ``q`` a list of the D row blocks, the ones this process
    holds (None for a peer's), each on its device; ``r`` the (l, l)
    factor on this process's first device. Needs ``n_padded / D ≥ l``
    (:func:`sharded_sketch_finish` takes the host QR below that).
    """
    flat = _flat_devices(mesh)
    d = len(flat)
    y = torch.as_tensor(y)
    n_padded, l = int(y.shape[0]), int(y.shape[1])
    if n_padded % d:
        raise ValueError(
            f"panel rows {n_padded} are not a multiple of the mesh's "
            f"{d} devices"
        )
    rows = n_padded // d
    if rows < l:
        raise ValueError(
            f"TSQR needs n_padded / devices >= l; got {rows} rows a "
            f"device for l = {l}"
        )
    rank = distributed.process_index()
    local = [i for i, (_, owner) in enumerate(flat) if owner == rank]
    home = flat[local[0]][0]
    q1, r1 = {}, {}
    for i in local:
        block = y[i * rows:(i + 1) * rows].to(flat[i][0], torch.float32)
        q1[i], r1[i] = torch.linalg.qr(block)
    if mesh_spans_processes(mesh):
        counts = distributed.allgather_ints([len(local)]).ravel()
        if len(set(counts.tolist())) != 1:
            raise ValueError(
                f"TSQR over a pod needs as many devices on every rank; got "
                f"{counts.tolist()}"
            )
        mine = torch.stack([r1[i].to(home) for i in local])
        parts = distributed.allgather_concat(mine, dim=0)
        owners = [owner for _, owner in flat]
        order = sorted(range(d), key=lambda i: (owners[i], i))
        stacked = torch.empty((d, l, l), dtype=parts.dtype, device=home)
        stacked[order] = parts.to(home)
        stacked = stacked.reshape(d * l, l)
    else:
        stacked = torch.cat([r1[i].to(home) for i in range(d)], dim=0)
    q2, r = torch.linalg.qr(stacked)
    q = [None] * d
    for i in local:
        dev = flat[i][0]
        q[i] = q1[i] @ q2[i * l:(i + 1) * l].to(dev)
    return q, r


def sharded_sketch_panel(
    windows_factory,
    n_samples: int,
    k: int,
    mesh: Mesh,
    oversample: Optional[int] = None,
    power_iters: Optional[int] = None,
    seed: int = 0,
    density_threshold: Optional[float] = None,
    block_variants: Optional[int] = None,
    pipeline_depth: int = 2,
    coalesce_variants: Optional[int] = None,
):
    """Stream CSR carrier windows into a mesh-replicated (N, k+p) sketch
    panel (JAX ``sharded_sketch_panel``): the ``--pca-mode sketch`` twin
    of :func:`sparse_sharded_gramian_blockwise`, with no N×N tile
    anywhere.

    The panel is O(N·(k+p)) float32 and replicated; the mesh buys the
    window machinery and the TSQR finish. Two paths:

    - a single-controller mesh, and a host-local mesh in a process group:
      every window updates every row of the panel (the Gramian's
      sample-range restriction does not apply), so the meshless engine
      runs on the mesh's first device, over each rank's manifest slice,
      and sums the ranks' partial panels;
    - a pod: :func:`_synced_carrier_stream` (``pipeline_depth``,
      ``coalesce_variants``), scatter steps through the meshless scatter
      update on the global carrier matrix, dense steps through
      :func:`_sketch_pod_dense_step`.

    ``windows_factory`` returns a fresh window iterator per call: each of
    the ``power_iters + 1`` passes re-streams the cohort with Ω ← orth(Y).
    Returns a :class:`~spark_examples_tpu_torch.ops.sketch.SketchPanel`
    of host float64 panels with ``n_padded`` rows (a multiple of the
    mesh's device count, the pad rows zero) and ``mesh`` set.
    """
    from spark_examples_tpu_torch.ops.pcoa import DEFAULT_SKETCH_POWER_ITERS
    from spark_examples_tpu_torch.ops.sketch import (
        SketchPanel,
        sketch_host_bytes,
        sketch_panel_blockwise,
    )

    if density_threshold is None:
        density_threshold = DEFAULT_SPARSE_DENSITY_THRESHOLD
    if oversample is None:
        oversample = DEFAULT_RANDOMIZED_OVERSAMPLE
    if power_iters is None:
        power_iters = DEFAULT_SKETCH_POWER_ITERS
    l = randomized_panel_width(n_samples, k, oversample)
    n_padded = round_up_multiple(n_samples, mesh.size)
    local = mesh.local_devices()
    if not local:
        raise ValueError(
            f"process {distributed.process_index()} holds no device of "
            f"{mesh}: every rank of a pod needs one"
        )
    if mesh_spans_processes(mesh):
        y, omega, row_sums = _pod_sketch_passes(
            windows_factory, n_samples, n_padded, l, power_iters, seed,
            density_threshold, block_variants or DEFAULT_BLOCK_VARIANTS,
            mesh.size, local[0], pipeline_depth, coalesce_variants,
        )
    else:
        panel = sketch_panel_blockwise(
            windows_factory, n_samples, k, oversample=oversample,
            power_iters=power_iters, seed=seed,
            density_threshold=density_threshold,
            block_variants=block_variants, device=local[0], sharded=True,
        )
        y, omega, row_sums = panel.y, panel.omega, panel.row_sums
    pad = ((0, n_padded - n_samples), (0, 0))
    return SketchPanel(
        y=np.pad(y, pad),
        omega=np.pad(omega, pad),
        row_sums=row_sums,
        n=n_samples,
        k=k,
        l=l,
        seed=seed,
        power_iters=power_iters,
        mesh=mesh,
        host_peak_bytes=sketch_host_bytes(n_padded, l),
    )


def _pod_sketch_passes(
    windows_factory, n, n_padded, l, power_iters, seed, density_threshold,
    width, n_devices, dev, pipeline_depth, coalesce_variants,
):
    """A pod's ``power_iters + 1`` sketch passes over the synced carrier
    stream, every rank holding the whole replicated panel on ``dev``.
    Returns the host float64 ``(y, omega, row_sums)`` over the n real
    rows, as :func:`~spark_examples_tpu_torch.ops.sketch.sketch_panel_blockwise`
    returns them."""
    from spark_examples_tpu_torch.ops.sketch import (
        SKETCH_WINDOWS,
        _augmented_omega,
        _center_columns,
        _note_sketch_window,
        gaussian_test_matrix,
    )
    from spark_examples_tpu_torch.utils.tracing import (
        SKETCH_ACCUMULATE,
        SKETCH_WINDOW,
    )

    omega_cur = gaussian_test_matrix(n, l, seed)
    for p in range(power_iters + 1):
        first = p == 0
        # One zero row past the padding: the carrier sentinel n_padded
        # gathers it.
        om = torch.zeros((n_padded + 1, l + 1), dtype=torch.float32,
                         device=dev)
        om[:n_padded] = torch.from_numpy(_augmented_omega(
            np.pad(omega_cur, ((0, n_padded - n), (0, 0))), n, first
        ))
        y = torch.zeros((n_padded, l + 1), dtype=torch.float32, device=dev)
        with obs.span(SKETCH_ACCUMULATE, n=n, l=l, sharded=True,
                      sketch_pass=p):
            stream = _synced_carrier_stream(
                windows_factory(),
                n,
                n_padded,
                density_threshold,
                width,
                n_devices,
                pipeline_depth=pipeline_depth,
                coalesce_variants=coalesce_variants,
            )
            for route, payload, nnz, n_variants, step, n_win, sid in stream:
                with obs.span(
                    SKETCH_WINDOW,
                    route=route,
                    nnz=nnz,
                    variants=n_variants,
                    step=step,
                    stream=sid,
                    windows=n_win,
                ):
                    if route == "scatter":
                        _sketch_pod_scatter(y, om, payload)
                    else:
                        _sketch_pod_dense_step(y, payload, om[:n_padded])
                SKETCH_WINDOWS[route] += n_win
                _note_sketch_window(route, count=n_win)
        y_np = y[:n].cpu().numpy().astype(np.float64)
        if first:
            row_sums = y_np[:, -1].copy()
        y_host = _center_columns(y_np[:, :-1], n)
        if p < power_iters:
            q, _ = np.linalg.qr(y_host)
            omega_cur = q.astype(np.float32)
    return y_host, _center_columns(omega_cur.astype(np.float64), n), row_sums


def sharded_sketch_finish(panel, k: int):
    """The sketch's Nyström finish on a mesh (JAX
    ``sharded_sketch_finish``): :func:`sketch_tsqr` of the shifted panel
    over the mesh's row blocks, the (k+p)×(k+p) core on the host in
    float64, and the coordinates ``Q·U₁`` on each block's device. Below
    ``n_padded / D < l`` rows a device, the QR runs on the host. Returns
    ``(coords (n_padded, l), vals (l,))`` as host float64 arrays; the
    caller (:func:`~spark_examples_tpu_torch.ops.sketch.sketch_eig`)
    trims, checks the gap and normalizes the signs."""
    from spark_examples_tpu_torch.ops.sketch import _nystrom_core

    mesh = panel.mesh
    y, omega = panel.y, panel.omega
    norm = float(np.linalg.norm(y))
    if norm == 0.0:
        return np.zeros((panel.n, panel.l)), np.zeros(panel.l)
    nu = float(np.sqrt(panel.n) * np.finfo(np.float32).eps * norm)
    y_nu = y + nu * omega
    n_padded, l = y_nu.shape
    rows_loc = n_padded // mesh.size
    b = omega.T @ y_nu
    if rows_loc < l:
        # Fewer rows a device than panel columns: the local QR's shape
        # contract breaks, and the whole finish is small on the host.
        q, r = np.linalg.qr(y_nu)
        u1, vals = _nystrom_core(r, b, nu)
        return q @ u1, vals
    q_blocks, r_dev = sketch_tsqr(
        torch.from_numpy(y_nu.astype(np.float32)), mesh
    )
    r = r_dev.cpu().numpy().astype(np.float64)
    u1, vals = _nystrom_core(r, b, nu)
    u = torch.from_numpy(u1.astype(np.float32))
    home = r_dev.device
    coords = torch.zeros((n_padded, l), dtype=torch.float32, device=home)
    for i, qi in enumerate(q_blocks):
        if qi is not None:
            rows = qi.shape[0]
            coords[i * rows:(i + 1) * rows] = (qi @ u.to(qi.device)).to(home)
    if mesh_spans_processes(mesh):
        # Each row block comes from one rank, so the sum is a copy.
        distributed.allreduce_sum_(coords)
    return coords.cpu().numpy().astype(np.float64), vals
