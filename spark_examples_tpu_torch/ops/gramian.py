"""Sample co-occurrence Gramian from bit-packed 0/1 indicator blocks.

Semantics (reference ``VariantsPca.scala:170-191``): for each variant, every
pair of samples that both carry a non-reference allele contributes +1 to
``G[i, j]`` (the diagonal counts each sample against itself). With the
per-variant sample-index lists densified to a 0/1 indicator block
``X ∈ {0,1}^(N × V)`` this is exactly ``G = X @ X.T``.

The product runs as int8×int8→int32 (``torch._int_mm``: int8 tensor cores
on the card, exact integer arithmetic on both devices), and the exact int32
counts are added into the float32 G, exact below 2^24 co-occurrences per
pair. The JAX package computes this product outside any Pallas kernel (an
``einsum`` with ``preferred_element_type=int32``), so the port uses the
library product here; only the scatter route has a hand-written kernel.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "gramian_accumulate_packed",
    "pack_indicator_block",
    "unpack_indicator_block",
]


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
    broadcast shift-and-mask on the tensor's own device."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=x_packed.device)
    bits = (x_packed[:, :, None] >> shifts) & 1
    return bits.reshape(x_packed.shape[0], -1)[:, :n_bits].to(torch.int8)


def gramian_accumulate_packed(g: torch.Tensor, x_packed, n_bits=None):
    """``G += X_blk @ X_blk.T`` from a bit-packed block, in place.

    ``x_packed`` is :func:`pack_indicator_block` output (host numpy or a
    tensor); ``n_bits`` is the block's true variant count (default: all
    8·⌈V/8⌉ columns — the pad bits packbits appends are zero and inert in
    the Gramian). ``g`` is updated in place (the port's counterpart of the
    JAX package's buffer donation) and returned.

    On the card ``torch._int_mm`` needs N > 16 and N and ``n_bits``
    multiples of 8; other shapes raise rather than pad.
    """
    xp = torch.as_tensor(x_packed).to(g.device)
    if n_bits is None:
        n_bits = 8 * xp.shape[1]
    n = g.shape[0]
    if g.device.type == "cuda" and (n <= 16 or n % 8 or n_bits % 8):
        raise ValueError(
            f"int8 Gramian product on CUDA needs N > 16 and N, n_bits "
            f"multiples of 8; got N={n}, n_bits={n_bits}"
        )
    x = unpack_indicator_block(xp, n_bits)
    g += torch._int_mm(x, x.t())
    return g
