"""CSR carrier windows: the host side of the sparse Gramian engine.

The bridge between the ragged host world (per-variant lists of carrying
sample indices, the ``RDD[Seq[Int]]`` interface at VariantsPca.scala:153-168)
and the device: per-block ``(indices, lens)`` CSR windows of
``block_variants`` variants, which the sparse engine scatters from directly
or densifies into a 0/1 indicator block ``X_blk ∈ {0,1}^(N × width)`` for
the dense route. Padding is free correctness-wise: an all-zero variant
column contributes nothing to the Gramian.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Sequence, Tuple

import numpy as np

__all__ = [
    "DEFAULT_BLOCK_VARIANTS",
    "round_up_multiple",
    "windows_from_calls",
]


def round_up_multiple(n: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` ≥ n (tile/padding arithmetic)."""
    return -(-n // multiple) * multiple


# 2^13 variant columns per block: at N=2504 samples an int8 block is
# ~20 MB host-side.
DEFAULT_BLOCK_VARIANTS = 8192


def _check_indices(idx: np.ndarray, n_samples: int) -> None:
    """Out-of-range sample indices mean a corrupt callset index — fail
    loudly (the reference throws on unknown callsets too,
    VariantsPca.scala:59)."""
    if idx.size and (idx.min() < 0 or idx.max() >= n_samples):
        bad = idx[(idx < 0) | (idx >= n_samples)][0]
        raise ValueError(
            f"sample index {bad} out of range for N={n_samples}"
        )


def windows_from_calls(
    calls_iter: Iterable[Sequence[int]],
    block_variants: int = DEFAULT_BLOCK_VARIANTS,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Stream per-variant carrier lists into ``(indices, lens)`` windows.

    Buffers ``block_variants`` variants and emits the window shape the
    sparse Gramian engine consumes — per-variant carrier counts plus the
    concatenated carrier indices, never a densified block. Window
    composition is the JAX package's, variant for variant, so the two
    engines accumulate the same windows.
    """
    buf_idx: List[np.ndarray] = []
    buf_lens: List[int] = []

    def emit():
        lens = np.asarray(buf_lens, dtype=np.int64)
        idx = (
            np.concatenate(buf_idx)
            if buf_idx
            else np.zeros(0, dtype=np.int64)
        )
        return idx, lens

    for calls in calls_iter:
        arr = np.asarray(calls, dtype=np.int64)
        buf_lens.append(arr.size)
        if arr.size:
            buf_idx.append(arr)
        if len(buf_lens) == block_variants:
            yield emit()
            buf_idx, buf_lens = [], []
    if buf_lens:
        yield emit()


def _densify_window(
    window_idx: np.ndarray,
    lens: np.ndarray,
    n_samples: int,
    block_variants: int,
) -> np.ndarray:
    """One CSR window → one dense (n_samples, block_variants) 0/1 int8
    block: the dense route of the sparse Gramian engine densifies a
    window with it before bit-packing."""
    cols = np.repeat(np.arange(lens.size, dtype=np.int64), lens)
    x = np.zeros((n_samples, block_variants), dtype=np.int8)
    x[window_idx, cols] = 1
    return x
