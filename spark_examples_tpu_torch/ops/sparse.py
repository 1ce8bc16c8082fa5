"""Sparse-aware Gramian accumulation straight from CSR carrier windows.

For the 0/1 indicator Gramian

    G[i, j] += |{v : i ∈ carriers(v) and j ∈ carriers(v)}|

each rare window scatters +1 at every carrier pair straight from its
``(indices, lens)`` CSR form — no densify, no bit-pack, work O(Σ k_v²)
instead of O(N²·V_blk). Each window's ragged carrier lists are right-padded
into a ``(V_pad, k_bucket)`` int32 index matrix with an out-of-range
sentinel, and :func:`~spark_examples_tpu_torch.ops.scatter_kernel.
scatter_pairs` adds +1 at every in-range pair: the hand-written CUDA kernel
on the card, its plain version on the CPU.

Density routing: a dense window (common variants) would pay k_max² ≈ (dN)²
per variant here while the matrix product pays N·V_blk, so
:func:`sparse_gramian_blockwise` routes each window by its own density:
strictly below the threshold it scatters, at or above it densifies +
bit-packs into the int8 product. Both routes add exact integer counts, so
the mix is bit-identical to either pure path and to the JAX package's
engine.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch

from spark_examples_tpu_torch import obs
from spark_examples_tpu_torch.arrays.blocks import (
    DEFAULT_BLOCK_VARIANTS,
    _check_indices,
    _densify_window,
    round_up_multiple,
)
from spark_examples_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from spark_examples_tpu_torch.ops.gramian import (
    gramian_accumulate_packed,
    pack_indicator_block,
)
from spark_examples_tpu_torch.ops.scatter_kernel import (
    SCATTER_CHUNK_VARIANTS,
    scatter_pairs,
    scatter_pairs_chunked,
)

__all__ = [
    "DEFAULT_POD_COALESCE_VARIANTS",
    "DEFAULT_SPARSE_DENSITY_THRESHOLD",
    "SCATTER_CHUNK_VARIANTS",
    "dense_panel_width",
    "padded_carrier_matrix",
    "scatter_pairs",
    "scatter_pairs_chunked",
    "sparse_gramian_accumulate",
    "sparse_gramian_blockwise",
    "window_density",
    "window_route",
]

# Dense/sparse switch: windows with density STRICTLY below this scatter
# straight from CSR; at or above it they densify onto the int8 product.
# The JAX package's default, kept so both engines route every window alike.
DEFAULT_SPARSE_DENSITY_THRESHOLD = 0.02

# Pod gang coalescing target (the pipelined carrier exchange of
# parallel/sharded.py::_synced_carrier_stream): consecutive scatter-route
# windows merge into one protocol step until their variant-row total
# reaches this, so tiny windows (tail windows, small shards) share one
# header and one carrier exchange. Windows at the default block width
# already exceed it. 0 or 1 disables. The JAX package's default.
DEFAULT_POD_COALESCE_VARIANTS = 256

_MIN_CARRIER_BUCKET = 8


def window_density(lens: np.ndarray, n_samples: int) -> float:
    """nnz / (N · V) for one CSR window (0.0 for an empty window)."""
    lens = np.asarray(lens)
    if lens.size == 0 or n_samples == 0:
        return 0.0
    return float(lens.sum()) / (n_samples * lens.size)


def window_route(
    lens: np.ndarray, n_samples: int, density_threshold: float
) -> str:
    """``"scatter"`` | ``"dense"`` for one window. Density exactly AT the
    threshold routes dense.

    Two gates, both required for scatter: the MEAN density (total work,
    O(Σk²) pairs) and the MAX per-variant carrier fraction — scatter cost
    and its index matrix scale with k_max², so ONE common variant buried
    in an otherwise-rare window routes the window dense.
    """
    lens = np.asarray(lens)
    if window_density(lens, n_samples) >= density_threshold:
        return "dense"
    if (
        lens.size
        and n_samples
        and int(lens.max()) / n_samples >= density_threshold
    ):
        return "dense"
    return "scatter"


def _carrier_bucket(k: int) -> int:
    """Round a window's max carrier count up to a power of two (min 8),
    the index matrix's column count."""
    bucket = _MIN_CARRIER_BUCKET
    while bucket < k:
        bucket *= 2
    return bucket


def dense_panel_width(rows: int, block_variants: int) -> int:
    """Padded variant width for one DENSE-route window's panel: the
    power-of-two bucket (min 8, capped at the block width), so a small
    tail window pays only its rounded size. Zero pad columns are inert."""
    if rows >= block_variants:
        return max(rows, 1)
    return min(_carrier_bucket(rows), block_variants)


def padded_carrier_matrix(
    window_idx: np.ndarray,
    lens: np.ndarray,
    sentinel: int,
    n_rows: Optional[int] = None,
    k_bucket: Optional[int] = None,
) -> np.ndarray:
    """One CSR window → a ``(n_rows, k_bucket)`` int32 carrier matrix.

    Row v holds variant v's carrier sample indices, right-padded with
    ``sentinel`` (any index ≥ the scatter target's row count — padded
    pairs are dropped). ``n_rows`` pads the variant axis (tail windows,
    chunk alignment); padded rows are all-sentinel and inert. ``k_bucket``
    overrides the locally derived power-of-two carrier bucket.
    """
    lens = np.asarray(lens, dtype=np.int64)
    window_idx = np.asarray(window_idx, dtype=np.int64)
    rows = lens.size if n_rows is None else n_rows
    if rows < lens.size:
        raise ValueError(
            f"n_rows {rows} < window variant count {lens.size}"
        )
    k_local = int(lens.max()) if lens.size else 0
    if k_bucket is None:
        k_bucket = _carrier_bucket(k_local)
    elif k_bucket < k_local:
        raise ValueError(
            f"k_bucket {k_bucket} < window max carrier count {k_local}"
        )
    mat = np.full((rows, k_bucket), sentinel, dtype=np.int32)
    if window_idx.size:
        row_of = np.repeat(np.arange(lens.size, dtype=np.int64), lens)
        starts = np.zeros(lens.size, dtype=np.int64)
        np.cumsum(lens[:-1], out=starts[1:])
        pos = np.arange(window_idx.size, dtype=np.int64) - starts[row_of]
        mat[row_of, pos] = window_idx
    return mat


def _pad_rows_for_scan(rows: int) -> int:
    """Variant-axis padding of a carrier matrix: a multiple of
    :data:`SCATTER_CHUNK_VARIANTS` (at least one chunk), so the chunked
    steps divide it evenly."""
    return round_up_multiple(max(rows, 1), SCATTER_CHUNK_VARIANTS)


def _carrier_operand(window_idx, lens, n_rows: int) -> np.ndarray:
    """A scatter-route window's operand: its carrier matrix with sentinel
    ``n_rows`` (the accumulator's row count), padded to whole chunks."""
    rows = _pad_rows_for_scan(np.asarray(lens).size)
    return padded_carrier_matrix(
        window_idx, lens, sentinel=n_rows, n_rows=rows
    )


def _dense_operand(window_idx, lens, n_samples, width, n_rows) -> np.ndarray:
    """A dense-route window's operand: densified to ``width`` columns,
    zero-padded to the accumulator's ``n_rows`` rows, bit-packed."""
    xb = _densify_window(window_idx, lens, n_samples, width)
    if n_rows != n_samples:
        xb = np.pad(xb, ((0, n_rows - n_samples), (0, 0)))
    return pack_indicator_block(xb)


def _scatter_into(g: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    """Scatter one carrier operand into G, on G's device."""
    idx = torch.from_numpy(idx).to(g.device)
    return scatter_pairs(g, idx, idx)


def sparse_gramian_accumulate(g: torch.Tensor, window_idx, lens):
    """One sparse accumulation step: scatter a CSR window into G in place.

    ``g`` is the ``(N, N)`` float32 accumulator, updated in place (the
    port's counterpart of the JAX package's donation) and returned; the
    window is host CSR ``(indices, lens)``. Bit-identical to densifying
    the window and accumulating its product.
    """
    return _scatter_into(g, _carrier_operand(window_idx, lens, g.shape[0]))


def _note_window(route: str, nnz: int, count: int = 1) -> None:
    """Per-window telemetry, the JAX package's counters."""
    reg = obs.get_registry()
    reg.counter(
        "sparse_gramian_windows_total",
        "CSR windows accumulated by the sparse-aware Gramian engine",
    ).labels(route=route).inc(count)
    reg.counter(
        "sparse_gramian_nnz_total",
        "Genotype carriers (nonzeros) accumulated by the sparse engine",
    ).inc(nnz)


def _note_pod_gang(n_windows: int) -> None:
    """Pod coalescing telemetry: how many local CSR windows one protocol
    step carried, labeled ``mode="gang"`` (more than one) or ``"solo"``;
    inert (zero-window) steps are not noted. The JAX package's counter."""
    if n_windows <= 0:
        return
    obs.get_registry().counter(
        "sparse_pod_coalesced_windows_total",
        "Local CSR windows entering pod-sparse protocol steps, by "
        "gang/solo coalescing outcome",
    ).labels(mode="gang" if n_windows > 1 else "solo").inc(n_windows)


def _note_pod_sync(outcome: str) -> None:
    """Per-step pod sync telemetry, outcome ∈ {synced, drained,
    producer-error, route-divergence, dtype-divergence}. The JAX
    package's counter."""
    obs.get_registry().counter(
        "sparse_pod_sync_total",
        "Pod-sparse per-window sync steps (header + carrier allgather) "
        "by outcome",
    ).labels(outcome=outcome).inc()


def _accumulate_windows(
    windows: Iterable[Tuple[np.ndarray, np.ndarray]],
    n_samples: int,
    density_threshold: float,
    block_variants: Optional[int],
    n_rows: int,
    scatter: Callable[[np.ndarray], object],
    add_packed: Callable[[np.ndarray], object],
) -> None:
    """The CSR-window step of every G accumulator: check, route by density,
    build the route's operand for an accumulator of ``n_rows`` rows, hand
    it to ``scatter`` or ``add_packed``; one span and one count a window."""
    width = block_variants or DEFAULT_BLOCK_VARIANTS
    for window_idx, lens in windows:
        lens = np.asarray(lens)
        _check_indices(np.asarray(window_idx), n_samples)
        route = window_route(lens, n_samples, density_threshold)
        nnz = int(lens.sum())
        with obs.span(
            "gramian.sparse.window",
            route=route,
            nnz=nnz,
            variants=int(lens.size),
        ):
            if route == "scatter":
                scatter(_carrier_operand(window_idx, lens, n_rows))
            else:
                cols = dense_panel_width(int(lens.size), width)
                add_packed(_dense_operand(
                    window_idx, lens, n_samples, cols, n_rows
                ))
        _note_window(route, nnz)


def sparse_gramian_blockwise(
    windows: Iterable[Tuple[np.ndarray, np.ndarray]],
    n_samples: int,
    density_threshold: float = DEFAULT_SPARSE_DENSITY_THRESHOLD,
    block_variants: Optional[int] = None,
    device=DEFAULT_DEVICE,
):
    """Stream CSR windows into one float32 G on ``device``, routing each
    window by density.

    ``windows`` yields ``(indices, lens)`` pairs. Sparse windows scatter
    straight from CSR; dense windows are densified to the
    :func:`dense_panel_width` bucket, bit-packed and multiplied as int8.
    Returns the (N, N) G tensor.
    """
    dev = resolve_device(device)
    g = torch.zeros((n_samples, n_samples), dtype=torch.float32, device=dev)
    with obs.span("gramian.sparse.accumulate", n=n_samples):
        _accumulate_windows(
            windows, n_samples, density_threshold, block_variants, n_samples,
            scatter=lambda idx: _scatter_into(g, idx),
            add_packed=lambda xp: gramian_accumulate_packed(g, xp),
        )
    return g
