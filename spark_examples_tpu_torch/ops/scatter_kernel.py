"""Pair scatter-accumulate: the hand-written CUDA kernel and its plain version.

``g[row_idx[v, a], col_idx[v, b]] += 1`` for every (v, a, b), indices
outside G dropped, duplicates counted with their multiplicity. This is the
port of ``spark_examples_tpu/ops/scatter_kernel.py::scatter_pairs_kernel``
(the JAX package's only Pallas kernel). The CUDA source is
``csrc/scatter_pairs.cu``; its header states the bound and the design.
The kernel's launch geometry (row bands and column tiles of G, each held
in one block's shared memory) is chosen here, in :func:`scatter_plan`, so
that the CPU tests reach it.

:func:`scatter_pairs` is the one entry point. It updates ``g`` in place
(the port's counterpart of the JAX package's buffer donation) and returns
it. The tensor's device alone picks the implementation: a CPU tensor takes
:func:`scatter_pairs_chunked`, the plain PyTorch version; a CUDA tensor
launches the kernel or raises. There is no switch and no fallback.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

__all__ = [
    "SCATTER_CHUNK_VARIANTS",
    "ScatterPlan",
    "band_mask_bit",
    "scatter_pairs",
    "scatter_pairs_chunked",
    "scatter_plan",
]

# Variant rows per step of the plain version. Index matrices are padded to
# a multiple of it (ops/sparse.py), which bounds the plain version's pair
# transient at chunk * K^2 elements.
SCATTER_CHUNK_VARIANTS = 256

# Kernel launches made by scatter_pairs; the plain version never counts.
SCATTER_KERNEL_LAUNCHES = 0

# Launch geometry of csrc/scatter_pairs.cu; the constants mirror its own.
# Shared memory one block may use on Hopper (227 KB), less a reserve for
# the kernel's static shared variables.
SCATTER_SMEM_BYTES = 232448 - 16
# The band kernel's list of the variants that touch its band: 8192
# packed 4-byte entries.
SCATTER_LIST_BYTES = 8192 * 4
# What is left for a block's int32 counters (rows x columns of G).
SCATTER_COUNTER_BYTES = SCATTER_SMEM_BYTES - SCATTER_LIST_BYTES
# Bits of the per-variant row-band mask the pre-pass writes.
SCATTER_MASK_BITS = 256
# Streaming multiprocessors of an H100 SXM, for callers without a card.
H100_SMS = 132


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class ScatterPlan(NamedTuple):
    """One launch's geometry: G is cut into ``n_bands`` bands of
    ``band_rows`` rows and ``n_tiles`` tiles of ``tile_cols`` columns (the
    last of each may be partial); block (band, tile) holds that cell's
    counters in ``smem_bytes`` of dynamic shared memory."""

    band_rows: int
    tile_cols: int
    n_bands: int
    n_tiles: int
    smem_bytes: int


def scatter_plan(
    n_rows: int,
    n_cols: int,
    n_sms: int = H100_SMS,
    counter_bytes: int = SCATTER_COUNTER_BYTES,
) -> ScatterPlan:
    """The band kernel's geometry for an (n_rows, n_cols) G.

    A band keeps whole rows when one row of int32 counters fits in
    ``counter_bytes``; otherwise the columns split into the fewest tiles
    that fit, each a multiple of 4 wide (the epilogue's 16-byte stores).
    The band height is the most that fits, lowered to spread the blocks
    over the ``n_sms`` streaming multiprocessors when there are fewer
    than one per SM.
    """
    if n_rows < 1 or n_cols < 1:
        raise ValueError(f"scatter_plan: empty G ({n_rows}, {n_cols})")
    max_cols = counter_bytes // 4
    if n_cols <= max_cols:
        tile_cols, n_tiles = n_cols, 1
    else:
        widest = max_cols - max_cols % 4
        if widest < 4:
            raise ValueError(
                f"scatter_plan: {counter_bytes} counter bytes hold no tile"
            )
        n_tiles = _ceil_div(n_cols, widest)
        tile_cols = 4 * _ceil_div(_ceil_div(n_cols, n_tiles), 4)
    max_rows = counter_bytes // (4 * tile_cols)
    spread = _ceil_div(n_rows * n_tiles, max(n_sms, 1))
    band_rows = max(1, min(max_rows, spread))
    return ScatterPlan(
        band_rows=band_rows,
        tile_cols=tile_cols,
        n_bands=_ceil_div(n_rows, band_rows),
        n_tiles=n_tiles,
        smem_bytes=SCATTER_LIST_BYTES + 4 * band_rows * tile_cols,
    )


def band_mask_bit(band: int, n_bands: int) -> int:
    """The bit of a variant's row-band mask that stands for ``band``: the
    pre-pass sets it when one of the variant's rows lies in that band.
    Distinct for up to :data:`SCATTER_MASK_BITS` bands; beyond that,
    neighbouring bands share a bit."""
    return band * SCATTER_MASK_BITS // n_bands


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def scatter_pairs_chunked(g, row_idx, col_idx):
    """The plain version: ``index_put_(accumulate=True)`` per chunk of
    :data:`SCATTER_CHUNK_VARIANTS` variant rows, with out-of-range pairs
    masked out. Every update is an exact +1 in ``g.dtype``. Updates ``g``
    in place and returns it."""
    n_rows, n_cols = g.shape
    flat = g.view(-1)
    for start in range(0, row_idx.shape[0], SCATTER_CHUNK_VARIANTS):
        r = row_idx[start:start + SCATTER_CHUNK_VARIANTS].long()[:, :, None]
        c = col_idx[start:start + SCATTER_CHUNK_VARIANTS].long()[:, None, :]
        valid = (r >= 0) & (r < n_rows) & (c >= 0) & (c < n_cols)
        lin = (r * n_cols + c)[valid]
        flat.index_put_(
            (lin,),
            torch.ones(lin.numel(), dtype=g.dtype, device=g.device),
            accumulate=True,
        )
    return g


def _check_operands(g, row_idx, col_idx) -> None:
    if g.dim() != 2 or g.dtype != torch.float32:
        raise ValueError(
            f"scatter_pairs: g must be a 2-D float32 tensor, got "
            f"{tuple(g.shape)} {g.dtype}"
        )
    for name, idx in (("row_idx", row_idx), ("col_idx", col_idx)):
        if idx.dim() != 2 or idx.dtype != torch.int32:
            raise ValueError(
                f"scatter_pairs: {name} must be a 2-D int32 tensor, got "
                f"{tuple(idx.shape)} {idx.dtype}"
            )
        if idx.device != g.device:
            raise ValueError(
                f"scatter_pairs: {name} is on {idx.device}, g on {g.device}"
            )
    if row_idx.shape != col_idx.shape:
        raise ValueError(
            f"scatter_pairs: row_idx {tuple(row_idx.shape)} and col_idx "
            f"{tuple(col_idx.shape)} differ in shape"
        )
    if row_idx.shape[0] % SCATTER_CHUNK_VARIANTS:
        raise ValueError(
            f"scatter_pairs: {row_idx.shape[0]} variant rows is not a "
            f"multiple of {SCATTER_CHUNK_VARIANTS}"
        )
    if not (
        g.is_contiguous()
        and row_idx.is_contiguous()
        and col_idx.is_contiguous()
    ):
        raise ValueError("scatter_pairs: operands must be contiguous")


def _launch(g, row_idx, col_idx) -> None:
    """Launch the CUDA kernel on the current stream; raise on any error."""
    global SCATTER_KERNEL_LAUNCHES
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"scatter_pairs: g is on {g.device} but CUDA is not available"
        )
    if g.device.type != "cuda":
        raise ValueError(
            f"scatter_pairs: the kernel needs CUDA tensors, got {g.device}"
        )
    if row_idx.numel() == 0 or g.numel() == 0:
        return
    from spark_examples_tpu_torch.cuda_build import load

    fn = load("scatter_pairs").scatter_pairs_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 9 + [
        ctypes.c_void_p
    ] * 3
    fn.restype = ctypes.c_int
    v_pad, k = row_idx.shape
    if v_pad >= 2**31 or k >= 2**31:
        raise ValueError(
            f"scatter_pairs: index matrix {tuple(row_idx.shape)} beyond "
            "the kernel's 32-bit variant and slot counts"
        )
    n_rows, n_cols = g.shape
    plan = scatter_plan(n_rows, n_cols, _sm_count(g.device.index or 0))
    # Per-variant extents, then the 8-word row-band masks (word-major).
    scratch = torch.empty(9 * v_pad, dtype=torch.int32, device=g.device)
    with torch.cuda.device(g.device):
        err = fn(
            g.data_ptr(),
            row_idx.data_ptr(),
            col_idx.data_ptr(),
            v_pad,
            k,
            n_rows,
            n_cols,
            *plan,
            scratch.data_ptr(),
            scratch[v_pad:].data_ptr(),
            torch.cuda.current_stream(g.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"scatter_pairs: kernel launch failed with cudaError_t {err}"
        )
    SCATTER_KERNEL_LAUNCHES += 1


def scatter_pairs(g, row_idx, col_idx):
    """``g[row_idx[v,a], col_idx[v,b]] += 1`` for every (v, a, b), in place.

    ``g`` is a contiguous (n_rows, n_cols) float32 tensor of any size;
    ``row_idx`` and ``col_idx`` are contiguous (V_pad, K) int32 tensors on
    the same device (they may be the same tensor), V_pad a multiple of
    :data:`SCATTER_CHUNK_VARIANTS`, any K. An index outside
    ``[0, n_rows)`` / ``[0, n_cols)`` drops its pair. Returns ``g``.
    Bit-identical on either device, and the same on every run: counts
    are integers, and a count added to a G entry below 2^24 is exact.
    """
    _check_operands(g, row_idx, col_idx)
    if g.device.type == "cpu":
        return scatter_pairs_chunked(g, row_idx, col_idx)
    _launch(g, row_idx, col_idx)
    return g
