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

from typing import Iterable, Optional, Tuple

import numpy as np
import torch

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


def sparse_gramian_accumulate(g: torch.Tensor, window_idx, lens):
    """One sparse accumulation step: scatter a CSR window into G in place.

    ``g`` is the ``(N, N)`` float32 accumulator, updated in place (the
    port's counterpart of the JAX package's donation) and returned; the
    window is host CSR ``(indices, lens)``. Bit-identical to densifying
    the window and accumulating its product.
    """
    idx = padded_carrier_matrix(
        window_idx,
        lens,
        sentinel=g.shape[0],
        n_rows=round_up_multiple(
            max(np.asarray(lens).size, 1), SCATTER_CHUNK_VARIANTS
        ),
    )
    idx = torch.from_numpy(idx).to(g.device)
    return scatter_pairs(g, idx, idx)


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
    width = block_variants or DEFAULT_BLOCK_VARIANTS
    g = torch.zeros((n_samples, n_samples), dtype=torch.float32, device=dev)
    for window_idx, lens in windows:
        lens = np.asarray(lens)
        _check_indices(np.asarray(window_idx), n_samples)
        route = window_route(lens, n_samples, density_threshold)
        if route == "scatter":
            sparse_gramian_accumulate(g, window_idx, lens)
        else:
            xp = pack_indicator_block(
                _densify_window(
                    window_idx,
                    lens,
                    n_samples,
                    dense_panel_width(int(lens.size), width),
                )
            )
            gramian_accumulate_packed(g, xp)
    return g
