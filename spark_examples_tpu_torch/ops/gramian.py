"""Sample co-occurrence Gramian from 0/1 indicator blocks.

Semantics (reference ``VariantsPca.scala:170-191``): for each variant, every
pair of samples that both carry a non-reference allele contributes +1 to
``G[i, j]`` (the diagonal counts each sample against itself). With the
per-variant sample-index lists densified to a 0/1 indicator block
``X ∈ {0,1}^(N × V)`` this is exactly ``G = X @ X.T``.

The product runs as int8×int8→int32 (``torch._int_mm``: int8 tensor cores
on the card, exact integer arithmetic on both devices), and the exact int32
counts are added into the float32 G, exact below 2^24 co-occurrences per
pair. On the card ``_int_mm`` takes only more than 16 rows and row and
column counts that are multiples of 8, so every operand is zero-padded to
:func:`int_mm_rows` rows and a multiple of 8 columns first, on both
devices: zero rows and columns are inert in X·Xᵀ, and only the (N, M)
corner of the product is used. The JAX package computes this product
outside any Pallas kernel (an ``einsum`` with
``preferred_element_type=int32``), so the port uses the library product
here; only the scatter route has a hand-written kernel.

:func:`gramian_blockwise` streams blocks through the double-buffered
host→device feed (:func:`~spark_examples_tpu_torch.arrays.feed.
device_prefetch`): the host pack and the copy of one block overlap the
product of the one before it.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from spark_examples_tpu_torch import obs
from spark_examples_tpu_torch.arrays.blocks import round_up_multiple
from spark_examples_tpu_torch.arrays.feed import device_prefetch
from spark_examples_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from spark_examples_tpu_torch.utils.tracing import (
    GRAMIAN_ACCUMULATE,
    INGEST_PACK,
)

__all__ = [
    "gang_gramian_blockwise",
    "gramian",
    "gramian_accumulate",
    "gramian_accumulate_packed",
    "gramian_blockwise",
    "int_mm_rows",
    "mxu_cross_product",
    "mxu_cross_product_pair",
    "pack_indicator_block",
    "unpack_indicator_block",
]

# The smallest row count torch._int_mm takes on CUDA (more than 16, a
# multiple of 8).
_INT_MM_MIN_ROWS = 24


def int_mm_rows(n: int) -> int:
    """Rows an int8 product operand of ``n`` rows is zero-padded to: the
    next multiple of 8, and at least 24, as ``_int_mm`` needs on CUDA."""
    return max(_INT_MM_MIN_ROWS, round_up_multiple(n, 8))


def _int_mm_operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` (n, v) as a contiguous int8 (int_mm_rows(n), ⌈v/8⌉·8) operand
    with zero rows and columns appended (none when the shape already fits);
    an empty variant axis becomes 8 zero columns."""
    n, v = x.shape
    rows, cols = int_mm_rows(n), round_up_multiple(max(v, 1), 8)
    x = x.to(torch.int8)
    if (rows, cols) == (n, v):
        return x.contiguous()
    out = x.new_zeros((rows, cols))
    out[:n, :v] = x
    return out


def _resolve_compute_dtype(x_dtype, compute_dtype):
    """int8 storage rides the int8 product unless the caller names the
    dtype; int8 and float32 are the two exact products served."""
    if compute_dtype is None:
        compute_dtype = torch.int8 if x_dtype == torch.int8 else torch.float32
    if compute_dtype not in (torch.int8, torch.float32):
        raise ValueError(
            f"compute_dtype must be torch.int8 or torch.float32, got "
            f"{compute_dtype}"
        )
    return compute_dtype


def _cross_product(a: torch.Tensor, b: torch.Tensor, compute_dtype):
    """The exact ``A @ B.T``: int32 from the int8 product, float32 from a
    float32 product (TF32 off, exact below 2^24)."""
    compute_dtype = _resolve_compute_dtype(a.dtype, compute_dtype)
    if compute_dtype == torch.int8:
        ap = _int_mm_operand(a)
        bp = ap if b is a else _int_mm_operand(b)
        return torch._int_mm(ap, bp.t())[: a.shape[0], : b.shape[0]]
    # Resolving the device turns TF32 off for float32 products on CUDA.
    resolve_device(a.device)
    af = a.to(torch.float32)
    bf = af if b is a else b.to(torch.float32)
    return af @ bf.t()


def mxu_cross_product_pair(a, b, out_dtype, compute_dtype=None):
    """``A @ B.T`` under the Gramian's exact-dtype policy, as ``out_dtype``.

    int8-stored operands (or ``compute_dtype=torch.int8``) take the int8
    product (int32 counts, then cast); anything else a float32 product.
    Both are exact integer counts for 0/1 indicators. :func:`mxu_cross_
    product` is the ``a is b`` case and delegates here, so the policy lives
    in one body. Computes on the operands' device.
    """
    return _cross_product(a, b, compute_dtype).to(out_dtype)


def mxu_cross_product(x, out_dtype, compute_dtype=None):
    """``X @ X.T`` in the fastest exact dtype path for 0/1 indicators."""
    return mxu_cross_product_pair(x, x, out_dtype, compute_dtype)


def gramian(
    x, compute_dtype=None, accum_dtype=torch.float32, device=DEFAULT_DEVICE
):
    """``G = X @ X.T`` for a 0/1 genotype-indicator block.

    ``x`` is an ``(n_samples, n_variants)`` tensor or array of any integer
    or float dtype with 0/1 values (int8 preferred); it is moved to
    ``device`` (the card unless the caller passes ``"cpu"``) and the
    product runs there. ``compute_dtype`` None picks int8 for int8
    storage, else float32. Returns the symmetric ``(n_samples,
    n_samples)`` co-occurrence matrix as ``accum_dtype``.
    """
    x = torch.as_tensor(x).to(resolve_device(device))
    return mxu_cross_product(x, accum_dtype, compute_dtype)


def gramian_accumulate(g: torch.Tensor, x_block, compute_dtype=None):
    """One blockwise-accumulation step: ``G += X_blk @ X_blk.T``.

    The variant-axis streaming primitive: the variant axis is unbounded
    while G stays fixed at N×N on its device. ``g`` is updated in place
    (the port's counterpart of the JAX package's buffer donation) and
    returned; ``x_block`` is moved to G's device.
    """
    x = torch.as_tensor(x_block).to(g.device)
    g += _cross_product(x, x, compute_dtype)
    return g


def pack_indicator_block(x_block: np.ndarray) -> np.ndarray:
    """Host-side bit-pack of a 0/1 indicator block: (N, V) → (N, ⌈V/8⌉).

    0/1 indicators waste 7 of every 8 bits of an int8 block, and the
    host→device copy moves the packed bytes.

    PRECONDITION: values must be 0/1 indicators. Packing collapses any
    nonzero value to 1 (``astype(bool)``), which would silently corrupt a
    dosage-valued block (0/1/2) into a wrong Gramian. A strided subsample
    (≤64Ki elements) is validated on every call; it cannot catch every
    stray value, so block producers own the full invariant.
    """
    x_block = np.asarray(x_block)
    if x_block.size:
        flat = x_block.reshape(-1)
        step = max(1, flat.shape[0] // 65536)
        sample = flat[::step]
        # Exact-0/1 check (not a range check): a fractional dosage like
        # 0.5 sits inside [0, 1] but still collapses to 1 under
        # astype(bool) — compare against the round-trip instead.
        if not np.array_equal(sample, sample.astype(bool)):
            bad_lo, bad_hi = sample.min(), sample.max()
            raise ValueError(
                "pack_indicator_block requires exact 0/1 indicator values; "
                f"got values in [{bad_lo}, {bad_hi}] (dosage-valued blocks "
                "must use the unpacked path)"
            )
    return np.packbits(x_block.astype(bool), axis=1)


def unpack_indicator_block(x_packed: torch.Tensor, n_bits: int):
    """Device-side unpack: (N, ⌈V/8⌉) uint8 → (N, n_bits) int8 0/1, by a
    broadcast shift-and-mask on the tensor's own device. The 0/1 bytes are
    reinterpreted as int8 in place, not copied."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=x_packed.device)
    bits = (x_packed[:, :, None] >> shifts) & 1
    return bits.reshape(x_packed.shape[0], -1)[:, :n_bits].view(torch.int8)


def gramian_accumulate_packed(
    g: torch.Tensor, x_packed, n_bits=None, compute_dtype=None
):
    """``G += X_blk @ X_blk.T`` from a bit-packed block, in place.

    ``x_packed`` is :func:`pack_indicator_block` output (host numpy or a
    tensor, moved to G's device); ``n_bits`` is the block's true variant
    count (default: all 8·⌈V/8⌉ columns — the pad bits packbits appends
    are zero and inert in the Gramian). Any N and any ``n_bits`` are
    served: the unpacked operand is zero-padded to the shape the int8
    product takes. ``g`` is updated in place and returned.
    """
    xp = torch.as_tensor(x_packed).to(g.device)
    if n_bits is None:
        n_bits = 8 * xp.shape[1]
    x = unpack_indicator_block(xp, n_bits)
    g += _cross_product(x, x, compute_dtype)
    return g


def gang_gramian_blockwise(
    windows: Iterable,
    remaps,
    n_max: int,
    device=DEFAULT_DEVICE,
    compute_dtype=None,
) -> np.ndarray:
    """Batched Gramians for B cohorts from ONE full-frame window stream.

    ``windows`` yields full-frame ``(indices, lens)`` CSR windows (the
    ``csr_windows``/``windows_from_calls`` shape); ``remaps`` is one int
    array per cohort mapping full-frame sample index → that cohort's dense
    index (< 0 drops the carrier). Each window is scattered on the host
    into one ``(B, rows, width)`` int8 stack — cohorts shorter than
    ``n_max`` zero-pad, and ``rows``/``width`` are already the shape the
    int8 product takes, so no operand is re-padded on the device — copied
    to ``device`` once, and each cohort's slice is accumulated into its
    ``G[b]`` by :func:`gramian_accumulate` (the JAX package maps that
    product over the batch with ``vmap``; PyTorch has no batched int8
    product). Each ``G[b]``'s
    top-left ``(n_b, n_b)`` corner is bit-identical to that cohort's
    serial accumulation — exact integer counts, any composition. (The
    JAX package also pads every window to ``block_variants`` columns, for
    its jit cache; the port needs no fixed width.)

    Returns the host ``(B, n_max, n_max)`` float32 stack (callers slice
    per-cohort corners).
    """
    batch = len(remaps)
    if batch == 0:
        raise ValueError("gang_gramian_blockwise needs >= 1 cohort")
    dev = resolve_device(device)
    remaps = [np.asarray(r, dtype=np.int64) for r in remaps]
    rows = int_mm_rows(n_max)
    g = torch.zeros((batch, rows, rows), dtype=torch.float32, device=dev)
    for window_idx, lens in windows:
        window_idx = np.asarray(window_idx, dtype=np.int64)
        lens = np.asarray(lens, dtype=np.int64)
        width = round_up_multiple(max(int(lens.size), 1), 8)
        cols = np.repeat(np.arange(lens.size, dtype=np.int64), lens)
        stack = np.zeros((batch, rows, width), dtype=np.int8)
        for b, remap in enumerate(remaps):
            mapped = remap[window_idx]
            keep = mapped >= 0
            stack[b][mapped[keep], cols[keep]] = 1
        xs = torch.from_numpy(stack).to(dev)
        with obs.span(GRAMIAN_ACCUMULATE, gang=batch):
            for b in range(batch):
                gramian_accumulate(g[b], xs[b], compute_dtype)
    return g[:, :n_max, :n_max].cpu().numpy()


def gramian_blockwise(
    blocks: Iterable[np.ndarray],
    n_samples: int,
    packed: bool = False,
    prepacked: bool = False,
    prefetch_depth: int = 2,
    device=DEFAULT_DEVICE,
    compute_dtype=None,
):
    """Stream variant blocks through ``G += X_blk @ X_blk.T`` on ``device``.

    ``blocks`` yields host ``(n_samples, v_blk)`` 0/1 arrays (ragged
    ``v_blk`` allowed). With ``packed`` each block is bit-packed on the
    host inside the feed's producer thread, so the pack of one block
    overlaps the copy and product of the one before it; with ``prepacked``
    too, the blocks already are :func:`pack_indicator_block` output.
    ``prefetch_depth`` (``--prefetch-depth``) is how many copied blocks the
    feed keeps ahead of the product. Returns the ``(N, N)`` float32 G
    tensor (exact below 2^24 co-occurrences per pair).
    """
    dev = resolve_device(device)
    g = torch.zeros((n_samples, n_samples), dtype=torch.float32, device=dev)

    def pack_each():
        for xb in blocks:
            # The range closes before the yield: it times the pack, not
            # the consumer's turn of the generator.
            with obs.span(INGEST_PACK):
                xp = pack_indicator_block(xb)
            yield xp

    if packed:
        stream = blocks if prepacked else pack_each()
        step = gramian_accumulate_packed
    else:
        stream, step = blocks, gramian_accumulate
    for i, xb in enumerate(
        device_prefetch(stream, depth=prefetch_depth, device=dev)
    ):
        with obs.span(GRAMIAN_ACCUMULATE, block=i):
            step(g, xb, compute_dtype=compute_dtype)
    return g
