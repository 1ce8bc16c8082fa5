"""Reads ops: per-base depth and the base-frequency table, as torch ops.

The JAX package's ``ops/reads_ops.py``. The reference's reads examples are
per-base scalar loops shuffled through Spark
(``SearchReadsExample.scala:138-164`` flatMaps every read into one
(position, 1) pair *per base* and reduceByKey's them). The formulations
here, the JAX package's:

- **per-base depth** — a difference array: +1 at each read start, −1 past
  its end, inclusive prefix sum. O(reads) scatter + O(region) cumsum, no
  per-base materialization at all.
- **base frequencies** — one scatter-add of (position-offset, base-code)
  pairs into a (region, 5) count table; quality masking happens in the
  same pass (no host filtering loop).

Both run on the device their operands lie on. The scatters are integer
``index_put_(accumulate=True)`` into int32 tables and the cumsum takes an
explicit int32 ``dtype`` (torch's default for an int32 input is int64,
JAX's is int32): the results are integer counts, exact in any order of
accumulation, so they are the JAX package's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "per_base_depth",
    "base_frequency_table",
    "BASE_CODES",
    "encode_bases",
]

# Base → column: A C G T N/other. The reference keys its frequency maps by
# raw char (SearchReadsExample.scala:219-238); N is rare but countable.
BASE_CODES = {"A": 0, "C": 1, "G": 2, "T": 3, "N": 4}
_BASE_LUT = np.full(256, 4, dtype=np.int8)
for _b, _c in BASE_CODES.items():
    _BASE_LUT[ord(_b)] = _c
    _BASE_LUT[ord(_b.lower())] = _c


def encode_bases(seq: str) -> np.ndarray:
    """ASCII sequence → int8 codes (vectorized byte lookup)."""
    return _BASE_LUT[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]


def per_base_depth(
    starts: torch.Tensor, lengths: torch.Tensor, region_len: int
) -> torch.Tensor:
    """Read depth over a region window via difference array + cumsum.

    Args:
      starts: (R,) integer read start offsets relative to the window (may
        be negative for reads starting before the window — clipped).
      lengths: (R,) integer aligned-sequence lengths (0 = padding slot).
      region_len: window size.

    Returns:
      (region_len,) int32 depth on the operands' device: one count per
      aligned base (cigar-less, as the reference's own TODO notes,
      SearchReadsExample.scala:152).
    """
    starts = starts.to(torch.int32)
    lengths = lengths.to(torch.int32)
    ends = starts + lengths
    lo = starts.clamp(0, region_len)
    hi = ends.clamp(0, region_len)
    valid = (lengths > 0) & (hi > lo)
    one = valid.to(torch.int32)
    sink = torch.full_like(lo, region_len)
    diff = torch.zeros(region_len + 1, dtype=torch.int32, device=starts.device)
    diff.index_put_((torch.where(valid, lo, sink).long(),), one,
                    accumulate=True)
    diff.index_put_((torch.where(valid, hi, sink).long(),), -one,
                    accumulate=True)
    return torch.cumsum(diff[:-1], 0, dtype=torch.int32)


def base_frequency_table(
    starts: torch.Tensor,
    base_codes: torch.Tensor,
    quals: torch.Tensor,
    min_base_qual: int,
    region_len: int,
) -> torch.Tensor:
    """Per-position base counts with quality masking, one scatter-add.

    Args:
      starts: (R,) integer read start offsets relative to the window.
      base_codes: (R, L) int8 encoded bases (5 = beyond-sequence padding).
      quals: (R, L) int32 per-base qualities (−1 where absent: the
        reference skips bases past the quality array,
        SearchReadsExample.scala:225).
      min_base_qual: scalar threshold.
      region_len: window size.

    Returns:
      (region_len, 5) int32 counts on the operands' device; divide by row
      sums for frequencies.
    """
    dev = starts.device
    _, l = base_codes.shape
    pos = starts[:, None].to(torch.int32) + torch.arange(
        l, dtype=torch.int32, device=dev
    )
    valid = (
        (base_codes >= 0)
        & (base_codes < 5)
        & (quals >= min_base_qual)
        & (pos >= 0)
        & (pos < region_len)
    )
    flat_pos = torch.where(valid, pos, torch.full_like(pos, region_len))
    flat_code = base_codes.clamp(0, 4).to(torch.int64)
    cell = (flat_pos.to(torch.int64) * 5 + flat_code).reshape(-1)
    counts = torch.zeros((region_len + 1) * 5, dtype=torch.int32, device=dev)
    counts.index_put_((cell,), valid.reshape(-1).to(torch.int32),
                      accumulate=True)
    return counts.view(region_len + 1, 5)[:region_len]
