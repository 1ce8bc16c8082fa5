"""Pair scatter-accumulate: the hand-written CUDA kernel and its plain version.

``g[row_idx[v, a], col_idx[v, b]] += 1`` for every (v, a, b), indices
outside G dropped, duplicates counted with their multiplicity. This is the
port of ``spark_examples_tpu/ops/scatter_kernel.py::scatter_pairs_kernel``
(the JAX package's only Pallas kernel). The CUDA source is
``csrc/scatter_pairs.cu``; its header states the bound and the design.

:func:`scatter_pairs` is the one entry point. It updates ``g`` in place
(the port's counterpart of the JAX package's buffer donation) and returns
it. The tensor's device alone picks the implementation: a CPU tensor takes
:func:`scatter_pairs_chunked`, the plain PyTorch version; a CUDA tensor
launches the kernel or raises. There is no switch and no fallback.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = [
    "SCATTER_CHUNK_VARIANTS",
    "scatter_pairs",
    "scatter_pairs_chunked",
]

# Variant rows per step of the plain version. Index matrices are padded to
# a multiple of it (ops/sparse.py), which bounds the plain version's pair
# transient at chunk * K^2 elements.
SCATTER_CHUNK_VARIANTS = 256

# Kernel launches made by scatter_pairs; the plain version never counts.
SCATTER_KERNEL_LAUNCHES = 0


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
    if row_idx.numel() == 0:
        return
    from spark_examples_tpu_torch.cuda_build import load

    fn = load("scatter_pairs").scatter_pairs_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 4 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    v_pad, k = row_idx.shape
    with torch.cuda.device(g.device):
        err = fn(
            g.data_ptr(),
            row_idx.data_ptr(),
            col_idx.data_ptr(),
            v_pad,
            k,
            g.shape[0],
            g.shape[1],
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
    Bit-identical on either device: every update is an exact +1 below
    2^24.
    """
    _check_operands(g, row_idx, col_idx)
    if g.device.type == "cpu":
        return scatter_pairs_chunked(g, row_idx, col_idx)
    _launch(g, row_idx, col_idx)
    return g
