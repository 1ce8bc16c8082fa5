"""The four reads example drivers — SearchReadsExample.scala parity.

The JAX package's ``models/search_reads.py``. Each driver keeps the
reference's observable behavior (filters, thresholds, output
shapes/formats) while the per-base hot loops run as the vectorized torch
ops of :mod:`spark_examples_tpu_torch.ops.reads_ops`: depth is a difference
array + cumsum instead of a per-base flatMap+shuffle, base frequencies are
one masked scatter-add instead of groupByKey chains. Pileup (example 1) and
coverage (example 2) are host code; depth (example 3) and the frequency
table (example 4) run on ``device`` — the card unless the caller asks for
the CPU — and their stdout and files are the JAX package's byte for byte.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from spark_examples_tpu_torch.genomics.shards import (
    HUMAN_CHROMOSOMES,
    DEFAULT_BASES_PER_SHARD,
    Shard,
    parse_references,
    shards_for_references,
)
from spark_examples_tpu_torch.arrays.blocks import round_up_multiple
from spark_examples_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from spark_examples_tpu_torch.genomics.types import Read
from spark_examples_tpu_torch.ops.reads_ops import (
    BASE_CODES,
    base_frequency_table,
    encode_bases,
    per_base_depth,
)

__all__ = [
    "Examples",
    "pileup",
    "average_coverage",
    "per_base_depth_example",
    "tumor_normal_diff",
]


class Examples:
    """Well-known ids/constants — SearchReadsExample.scala:29-66."""

    GOOGLE_1KG_HG00096_READSET = "CMvnhpKTFhCwvIWYw9eikzQ"
    GOOGLE_EXAMPLE_READSET = "CMvnhpKTFhD04eLE-q2yxnU"
    GOOGLE_DREAM_SET3_NORMAL = "CPHG3MzoCRDRkqXzk7b6l_kB"
    GOOGLE_DREAM_SET3_TUMOR = "CPHG3MzoCRCO1rDx8pOY6yo"
    CILANTRO = 6_889_648  # cilantro/soap SNP near OR10A2
    HUMAN_CHROMOSOMES = HUMAN_CHROMOSOMES


def _stream(source, rgsid: str, references: str, bases_per_shard: int):
    for shard in shards_for_references(references, bases_per_shard):
        yield shard, list(source.stream_reads(rgsid, shard))


# -- Example 1: pileup --------------------------------------------------------


def pileup(
    source,
    read_group_set_id: str = Examples.GOOGLE_EXAMPLE_READSET,
    snp: int = Examples.CILANTRO,
    contig: str = "11",
    window: int = 1000,
    references: Optional[str] = None,
    bases_per_shard: int = DEFAULT_BASES_PER_SHARD,
) -> List[str]:
    """Text pileup of reads covering a SNP, quality spliced inline.

    Output format parity with SearchReadsExample1 (lines :96-109): a ``v``
    marker column over the SNP, one line per covering read with its base
    quality at the SNP printed ``(%02d)`` after the SNP base, and a closing
    ``^`` marker.
    """
    references = references or f"{contig}:{snp - window}:{snp + window}"
    covering: List[Read] = []
    for _, reads in _stream(source, read_group_set_id, references, bases_per_shard):
        for r in reads:
            i = snp - r.position
            # Reference filter (:87-90) allows position+len == snp, but the
            # quality splice needs an in-bounds index; require it.
            if 0 <= i < len(r.aligned_sequence) and i < len(r.aligned_quality):
                covering.append(r)
    if not covering:
        return []
    first = min(r.position for r in covering)
    lines = [" " * (snp - first) + "v"]
    for r in covering:
        i = snp - r.position
        head, tail = r.aligned_sequence[: i + 1], r.aligned_sequence[i + 1 :]
        lines.append(
            " " * (r.position - first)
            + head
            + f"({r.aligned_quality[i]:02d}) "
            + tail
        )
    lines.append(" " * (snp - first) + "^")
    return lines


# -- Example 2: average coverage ----------------------------------------------


def average_coverage(
    source,
    read_group_set_id: str = Examples.GOOGLE_EXAMPLE_READSET,
    contig: str = "21",
    references: Optional[str] = None,
    bases_per_shard: int = DEFAULT_BASES_PER_SHARD,
    length: Optional[int] = None,
) -> float:
    """Σ aligned-sequence length / (end − start) of the region
    (SearchReadsExample2, :115-133; default region = whole chr21, where
    the divisor equals the reference's chromosome length)."""
    if references:
        contig, start, end = _single_region(references)
    else:
        start, end = 0, length or HUMAN_CHROMOSOMES[contig]
        references = f"{contig}:{start}:{end}"
    # One denominator convention regardless of how the region was given:
    # the half-open region's length, end - start. The reference divides by
    # the chromosome length (SearchReadsExample2:129) and only ever runs on
    # the whole chromosome; the default region here is 0:length, so the
    # default path reproduces its divisor exactly and passing that region
    # explicitly yields the identical result.
    denom = end - start
    total = 0
    for _, reads in _stream(
        source, read_group_set_id, references, bases_per_shard
    ):
        total += sum(len(r.aligned_sequence) for r in reads)
    coverage = total / denom
    print(f"Coverage of chromosome {contig} = {coverage}")
    return coverage


# -- Example 3: per-base depth -------------------------------------------------


def _pad_pow2(n: int, floor: int = 256) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def _single_region(references: str):
    """The reads examples operate on one contiguous region."""
    regions = parse_references(references)
    if len(regions) != 1:
        raise ValueError(
            f"reads examples take a single region, got {references!r}"
        )
    return regions[0]


def _windowed_arrays(source, rgsid, references, bases_per_shard, compute):
    """Per-shard accumulation with overhang carry across shard boundaries.

    STRICT sources yield a read only in the shard containing its *start*,
    but its bases may extend past the shard end; the reference's per-base
    flatMap counts every base regardless of partition
    (SearchReadsExample.scala:152-157). ``compute(shard, reads, pad)``
    returns an array covering ``shard.range + pad`` positions; the overhang
    ``[shard.end, shard.end + pad)`` is carried into the next adjacent
    window (or flushed as a trailing pseudo-window at a discontinuity), so
    output is independent of ``--bases-per-partition``.
    """
    carry = None
    prev = None
    for shard in shards_for_references(references, bases_per_shard):
        reads = list(source.stream_reads(rgsid, shard))
        if prev is not None and (
            prev.contig != shard.contig or prev.end != shard.start
        ):
            if carry is not None and carry.any():
                yield Shard(prev.contig, prev.end, prev.end + len(carry)), carry
            carry = None
        pad = max((len(r.aligned_sequence) for r in reads), default=0)
        arr = compute(shard, reads, pad)
        if carry is not None and len(carry):
            if len(carry) > len(arr):
                widen = [(0, len(carry) - len(arr))] + [(0, 0)] * (
                    arr.ndim - 1
                )
                arr = np.pad(arr, widen)
            arr[: len(carry)] += carry
        yield shard, arr[: shard.range]
        carry = arr[shard.range :]
        prev = shard
    if prev is not None and carry is not None and carry.any():
        yield Shard(prev.contig, prev.end, prev.end + len(carry)), carry


def per_base_depth_example(
    source,
    read_group_set_id: str = Examples.GOOGLE_EXAMPLE_READSET,
    contig: str = "21",
    references: Optional[str] = None,
    out_path: str = ".",
    bases_per_shard: int = DEFAULT_BASES_PER_SHARD,
    length: Optional[int] = None,
    device=DEFAULT_DEVICE,
) -> str:
    """Per-base read depth over a chromosome → ``coverage_<chr>`` text dump.

    SearchReadsExample3 (:138-164) parity: one ``(position,depth)`` line per
    covered base, ascending. Each shard window runs the difference-array
    ops on ``device``; read-count arrays are padded to power-of-two buckets,
    as in the JAX package (the depth does not depend on the padding).
    """
    dev = resolve_device(device)
    if references:
        contig, _, _ = _single_region(references)
    else:
        references = f"{contig}:1:{length or HUMAN_CHROMOSOMES[contig]}"
    out_dir = os.path.join(out_path, f"coverage_{contig}")
    os.makedirs(out_dir, exist_ok=True)
    out_file = os.path.join(out_dir, "part-00000")

    def compute(shard, reads, pad):
        window = shard.range + round_up_multiple(pad, 128)
        if not reads:
            return np.zeros(window, np.int64)
        n_pad = _pad_pow2(len(reads))
        starts = np.zeros(n_pad, np.int32)
        lengths = np.zeros(n_pad, np.int32)
        for j, r in enumerate(reads):
            starts[j] = r.position - shard.start
            lengths[j] = len(r.aligned_sequence)
        depth = per_base_depth(
            torch.from_numpy(starts).to(dev),
            torch.from_numpy(lengths).to(dev),
            window,
        )
        return depth.cpu().numpy().astype(np.int64)

    with open(out_file, "w") as f:
        for shard, depth in _windowed_arrays(
            source,
            read_group_set_id,
            references,
            bases_per_shard,
            compute,
        ):
            (covered,) = np.nonzero(depth)
            for off in covered:
                f.write(f"({shard.start + int(off)},{int(depth[off])})\n")
    return out_file


# -- Example 4: tumor/normal base-frequency diff -------------------------------

_CODE_TO_BASE = {v: k for k, v in BASE_CODES.items()}


def _freq_strings(
    source,
    rgsid: str,
    references: str,
    bases_per_shard: int,
    min_mapping_qual: int,
    min_base_qual: int,
    min_freq: float,
    dev: torch.device,
    read_len_cap: int = 512,
) -> Dict[int, str]:
    """position → sorted string of bases with frequency ≥ min_freq.

    The freqRDD→threshold-projection composition of SearchReadsExample4
    (:216-241, :277-288) collapsed into one pass: counts come from the
    scatter-add on ``dev``, thresholding happens on the count table.
    """
    def compute(shard, reads, pad):
        window = shard.range + round_up_multiple(pad, 128)
        reads = [r for r in reads if r.mapping_quality >= min_mapping_qual]
        # Reads longer than the scatter-row width become several rows with
        # shifted starts, so every aligned base is counted — the reference
        # counts all of them (SearchReadsExample.scala:224-229); capping
        # bounds the dense row width of the scatter, never the data.
        segs = []
        for r in reads:
            seq, qual = r.aligned_sequence, r.aligned_quality
            for off in range(0, len(seq), read_len_cap) or (0,):
                segs.append(
                    (
                        r.position - shard.start + off,
                        seq[off : off + read_len_cap],
                        qual[off : off + read_len_cap],
                    )
                )
        if not segs:
            return np.zeros((window, 5), np.int64)
        n_pad = _pad_pow2(len(segs))
        max_len = _pad_pow2(
            max(len(s) for _, s, _ in segs) or 1, floor=64
        )
        starts = np.zeros(n_pad, np.int32)
        codes = np.full((n_pad, max_len), -1, np.int8)
        quals = np.full((n_pad, max_len), -1, np.int32)
        for j, (seg_start, seq, qual) in enumerate(segs):
            starts[j] = seg_start
            codes[j, : len(seq)] = encode_bases(seq)
            lq = min(len(qual), len(seq))
            quals[j, :lq] = qual[:lq]
        counts = base_frequency_table(
            torch.from_numpy(starts).to(dev),
            torch.from_numpy(codes).to(dev),
            torch.from_numpy(quals).to(dev),
            min_base_qual,
            window,
        )
        return counts.cpu().numpy().astype(np.int64)

    out: Dict[int, str] = {}
    for shard, counts in _windowed_arrays(
        source, rgsid, references, bases_per_shard, compute
    ):
        totals = counts.sum(axis=1)
        (covered,) = np.nonzero(totals)
        freqs = counts[covered] / totals[covered, None]
        keep = freqs >= min_freq
        for row, off in enumerate(covered):
            s = "".join(
                sorted(
                    _CODE_TO_BASE[c]
                    for c in np.nonzero(keep[row])[0]
                )
            )
            out[shard.start + int(off)] = s
    return out


def tumor_normal_diff(
    source,
    normal_id: str = Examples.GOOGLE_DREAM_SET3_NORMAL,
    tumor_id: str = Examples.GOOGLE_DREAM_SET3_TUMOR,
    references: str = "1:100000000:101000000",
    out_path: str = ".",
    bases_per_shard: int = DEFAULT_BASES_PER_SHARD,
    min_mapping_qual: int = 30,
    min_base_qual: int = 30,
    min_freq: float = 0.25,
    device=DEFAULT_DEVICE,
) -> str:
    """Positions whose thresholded base strings differ tumor vs normal.

    SearchReadsExample4 (:171-304) parity: inner join on positions covered
    in both readsets, keep rows where the strings differ, write
    ``(position,(normal,tumor))`` lines ascending to ``diff_<chr>``.
    """
    contig = references.split(":")[0]
    args = (references, bases_per_shard, min_mapping_qual, min_base_qual,
            min_freq, resolve_device(device))
    normal = _freq_strings(source, normal_id, *args)
    tumor = _freq_strings(source, tumor_id, *args)

    out_dir = os.path.join(out_path, f"diff_{contig}")
    os.makedirs(out_dir, exist_ok=True)
    out_file = os.path.join(out_dir, "part-00000")
    with open(out_file, "w") as f:
        for pos in sorted(normal.keys() & tumor.keys()):
            n, t = normal[pos], tumor[pos]
            if n != t:
                f.write(f"({pos},({n},{t}))\n")
    return out_file
