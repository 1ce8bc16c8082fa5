"""Carrier lists → CSR windows and dense 0/1 blocks: the host side of ingest.

The bridge between the ragged host world (per-variant lists of carrying
sample indices, the ``RDD[Seq[Int]]`` interface at VariantsPca.scala:153-168,
or per-shard CSR ``(indices, offsets)`` pairs) and the device: per-block
``(indices, lens)`` CSR windows of ``block_variants`` variants, which the
sparse and sketch engines consume directly, and 0/1 indicator blocks
``X_blk ∈ {0,1}^(N × width)`` of a fixed width for the dense-blockwise
route and the dense windows of both engines. Padding is free
correctness-wise: an all-zero variant column contributes nothing to the
Gramian, so the final partial block is zero-padded.
"""

from __future__ import annotations

import collections
import itertools
import time
from typing import (
    Callable,
    Iterable,
    Iterator,
    List,
    Optional,
    Sequence,
    Tuple,
)

import numpy as np

from spark_examples_tpu_torch import native as native_core
from spark_examples_tpu_torch import obs
from spark_examples_tpu_torch.utils.concurrency import (
    completion_parallel_map,
)
from spark_examples_tpu_torch.utils.tracing import INGEST_BUILD

__all__ = [
    "DEFAULT_BLOCK_VARIANTS",
    "blocks_from_calls",
    "blocks_from_csr",
    "csr_windows",
    "densify_calls",
    "packed_block_from_csr",
    "packed_blocks_from_csr",
    "restrict_window_to_sample_range",
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


def csr_windows(
    csr_iter: Iterable,
    block_variants: int = DEFAULT_BLOCK_VARIANTS,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Regroup per-shard CSR pairs into per-block windows.

    Consumes ``(indices, offsets)`` pairs in arrival order (``offsets`` of
    length rows+1; ``None`` or empty shards are skipped) and yields one
    ``(indices, lens)`` window per ``block_variants`` variants, the tail
    window smaller: ``lens[i]`` is variant i's carrier count and
    ``indices`` its carriers concatenated, as int64. Window composition
    depends only on the pair arrival order. A pair that spans many blocks
    is sliced with a moving cursor of zero-copy views, never
    re-concatenated per emitted window.
    """
    pend: collections.deque = collections.deque()
    rows_buf = 0

    def emit(take: int):
        """Slice the first ``take`` buffered variants into one window."""
        nonlocal rows_buf
        idx_parts: List[np.ndarray] = []
        lens_parts: List[np.ndarray] = []
        need = take
        while need:
            idx, lens = pend[0]
            if lens.size <= need:
                pend.popleft()
                idx_parts.append(idx)
                lens_parts.append(lens)
                need -= lens.size
            else:
                cut = int(lens[:need].sum())
                idx_parts.append(idx[:cut])
                lens_parts.append(lens[:need])
                pend[0] = (idx[cut:], lens[need:])
                need = 0
        rows_buf -= take
        if len(lens_parts) == 1:
            return idx_parts[0], lens_parts[0]
        return np.concatenate(idx_parts), np.concatenate(lens_parts)

    for pair in csr_iter:
        if pair is None:
            continue
        indices, offsets = pair
        if offsets.size <= 1:
            continue
        pend.append(
            (
                np.asarray(indices, dtype=np.int64),
                np.diff(np.asarray(offsets, dtype=np.int64)),
            )
        )
        rows_buf += offsets.size - 1
        while rows_buf >= block_variants:
            yield emit(block_variants)
    if rows_buf:
        yield emit(rows_buf)


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


def restrict_window_to_sample_range(
    window_idx: np.ndarray,
    lens: np.ndarray,
    lo: int,
    hi: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Drop a window's carriers outside sample range ``[lo, hi)``.

    The per-host sample-range ingest contract: a mesh whose Gramian tiles
    cover sample rows/columns ``[lo, hi)`` never needs carriers outside
    them — every pair with an endpoint outside lands in a tile another
    host owns. Indices stay global (the tile scatter re-bases them);
    ``lens`` is recomputed per variant so the window stays a valid CSR
    window. The full range is a no-op (the single-controller case).
    """
    window_idx = np.asarray(window_idx, dtype=np.int64)
    lens = np.asarray(lens, dtype=np.int64)
    if window_idx.size == 0 or (lo <= 0 and hi > window_idx.max()):
        return window_idx, lens
    keep = (window_idx >= lo) & (window_idx < hi)
    if bool(keep.all()):
        return window_idx, lens
    row_of = np.repeat(np.arange(lens.size, dtype=np.int64), lens)
    new_lens = np.bincount(
        row_of[keep], minlength=lens.size
    ).astype(np.int64)
    return window_idx[keep], new_lens


def densify_calls(
    calls: Sequence[Sequence[int]],
    n_samples: int,
    width: int = None,
    native: bool = True,
) -> np.ndarray:
    """Per-variant index lists → one (n_samples, width) 0/1 int8 block.

    The hot host loop of ingest: the lists become one CSR window and the
    block is filled by the native core's ``pack_calls``, or with
    ``native=False`` by one vectorized numpy scatter
    (:func:`_densify_window`); the two are byte-identical. Out-of-range
    indices raise on both.
    """
    width = width if width is not None else len(calls)
    if width < len(calls):
        raise ValueError(
            f"width {width} < number of variants {len(calls)}"
        )
    lens = np.fromiter(map(len, calls), dtype=np.int64, count=len(calls))
    idx = np.fromiter(
        itertools.chain.from_iterable(calls),
        dtype=np.int64,
        count=int(lens.sum()),
    )
    _check_indices(idx, n_samples)
    if not native:
        return _densify_window(idx, lens, n_samples, width)
    offsets = np.zeros(lens.size + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    x = np.zeros((n_samples, width), dtype=np.int8)
    native_core.load().pack_calls(
        idx.ctypes.data,
        offsets.ctypes.data,
        lens.size,
        n_samples,
        width,
        x.ctypes.data,
    )
    return x


def blocks_from_calls(
    calls_iter: Iterable[Sequence[int]],
    n_samples: int,
    block_variants: int = DEFAULT_BLOCK_VARIANTS,
) -> Iterator[np.ndarray]:
    """Stream ragged call lists into fixed-shape zero-padded blocks."""
    buf: List[Sequence[int]] = []
    for calls in calls_iter:
        buf.append(calls)
        if len(buf) == block_variants:
            yield densify_calls(buf, n_samples, block_variants)
            buf = []
    if buf:
        yield densify_calls(buf, n_samples, block_variants)


def blocks_from_csr(
    csr_iter,
    n_samples: int,
    block_variants: int = DEFAULT_BLOCK_VARIANTS,
) -> Iterator[np.ndarray]:
    """Stream per-shard CSR pairs into fixed-shape 0/1 int8 blocks.

    The vectorized twin of :func:`blocks_from_calls` for sources that serve
    a shard's carrying lists as one ``(indices, offsets)`` pair
    (``stream_carrying_csr``): each emitted block is a single fancy-index
    scatter over the window's nonzeros instead of a Python loop over
    variants. Emits the same blocks bit-for-bit in the same order.

    ``csr_iter`` yields ``(indices, offsets)`` with ``offsets`` of length
    rows+1 (or None for empty shards, skipped).
    """
    for window_idx, lens in csr_windows(csr_iter, block_variants):
        _check_indices(window_idx, n_samples)
        yield _densify_window(window_idx, lens, n_samples, block_variants)


def packed_block_from_csr(
    window_idx: np.ndarray,
    lens: np.ndarray,
    n_samples: int,
    block_variants: int = DEFAULT_BLOCK_VARIANTS,
    native: bool = True,
) -> np.ndarray:
    """One CSR window → one BIT-PACKED ``(n_samples, ⌈Vb/8⌉)`` block.

    The build stage of the CSR ingest (an :data:`~spark_examples_tpu_torch.
    utils.tracing.INGEST_BUILD` range in the calling builder thread): the
    native core's ``csr_to_packed_blocks`` scatters carrier bits straight
    into packbits layout — no int8 densify intermediate — with the GIL
    released for the whole scatter, which is what lets builder threads
    scale. ``native=False`` runs the densify + ``np.packbits``
    composition instead, byte for byte the same block. Out-of-range
    indices raise on both.
    """
    window_idx = np.ascontiguousarray(window_idx, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    # The native scatter trusts these sizes: a window wider than the block
    # or lens that disagree with the indices would write or read past a
    # buffer.
    if lens.size > block_variants:
        raise ValueError(
            f"window of {lens.size} variants > block of {block_variants}"
        )
    if (lens.size and lens.min() < 0) or int(lens.sum()) != window_idx.size:
        raise ValueError(
            f"window lens (sum {int(lens.sum())}) do not match its "
            f"{window_idx.size} indices"
        )
    _check_indices(window_idx, n_samples)
    mode = "native" if native else "python"
    t0 = time.perf_counter()
    with obs.span(INGEST_BUILD, mode=mode, variants=int(lens.size)):
        if native:
            offsets = np.zeros(lens.size + 1, dtype=np.int64)
            np.cumsum(lens, out=offsets[1:])
            out = np.zeros((n_samples, (block_variants + 7) // 8), np.uint8)
            rc = native_core.load().csr_to_packed_blocks(
                window_idx.ctypes.data,
                offsets.ctypes.data,
                lens.size,
                n_samples,
                out.shape[1],
                out.ctypes.data,
            )
            if rc != 0:
                # Unreachable after _check_indices; kept so a corrupt
                # window can never silently drop a carrier.
                raise ValueError(
                    f"sample index out of range for N={n_samples} "
                    "in native csr_to_packed_blocks"
                )
        else:
            out = np.packbits(
                _densify_window(
                    window_idx, lens, n_samples, block_variants
                ).astype(bool),
                axis=1,
            )
    _record_block_built(mode, time.perf_counter() - t0)
    return out


def _record_block_built(mode: str, seconds: float) -> None:
    reg = obs.get_registry()
    reg.counter(
        "ingest_blocks_built_total",
        "Packed genotype blocks produced by the ingest engine",
    ).labels(mode=mode).inc()
    reg.histogram(
        "ingest_block_build_seconds",
        "Per-block build latency (CSR window -> packed block)",
    ).labels(mode=mode).observe(seconds)


def packed_blocks_from_csr(
    csr_iter,
    n_samples: int,
    block_variants: int = DEFAULT_BLOCK_VARIANTS,
    workers: int = 1,
    attempt: Optional[
        Callable[[Callable[[], np.ndarray], str], np.ndarray]
    ] = None,
    native: bool = True,
) -> Iterator[np.ndarray]:
    """Stream per-shard CSR pairs into BIT-PACKED blocks, ``workers``
    at a time.

    Windows are sliced sequentially (:func:`csr_windows` — composition
    fixed by arrival order), built into packed blocks by up to ``workers``
    threads, and yielded in COMPLETION order when ``workers > 1`` — safe
    because the Gramian accumulates exact integer counts, so G is
    bit-identical under any block arrival order. ``workers <= 1`` is the
    serial in-order path, byte-identical to
    ``pack_indicator_block(b) for b in blocks_from_csr(...)``.

    ``attempt(thunk, key)`` wraps each block build (a pure, idempotent
    function of its window; ``key`` is the window's index as a string):
    the driver passes its retry and ``ingest.build`` fault-seam wrapper,
    so a builder dying mid-block is retried instead of the block being
    dropped.
    """
    if attempt is None:
        def attempt(thunk, _key):
            return thunk()

    def build(numbered):
        i, (window_idx, lens) = numbered
        return attempt(
            lambda: packed_block_from_csr(
                window_idx, lens, n_samples, block_variants, native
            ),
            str(i),
        )

    yield from completion_parallel_map(
        build, enumerate(csr_windows(csr_iter, block_variants)), workers
    )
