"""Dataset assembly: AF filtering and call extraction.

The host-side transformations between raw variant streams and the carrier
windows the device consumes — the semantics of ``VariantsPca.scala:96-168``.
Per-variant carrying-sample index lists flow straight into the window
builder (:mod:`spark_examples_tpu_torch.arrays.blocks`). This slice of the
port serves one dataset; the multi-dataset identity join/merge is a later
slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional, Sequence

from spark_examples_tpu_torch.genomics.types import Variant, has_variation

__all__ = [
    "af_filter",
    "af_value",
    "carrying_sample_indices",
    "calls_stream",
]


def af_value(af) -> Optional[float]:
    """``info["AF"][0]`` as a float, or ``None`` when absent or non-numeric.

    Non-numeric AF (the VCF "." missing marker, or any malformed value)
    counts as MISSING: under an active filter the record drops, in every
    tier, so the tiers stay behavior-identical on bad input. The reference
    would throw NumberFormatException here (``"AF".toDouble``-style,
    VariantsPca.scala:100-104); crashing a whole-cohort run on one missing
    marker is a bug, not parity to keep.
    """
    if not af:
        return None
    try:
        return float(af[0])
    except (TypeError, ValueError):
        return None


def af_filter(
    variants: Iterable[Variant], min_allele_frequency: Optional[float]
) -> Iterator[Variant]:
    """Keep variants with ``info["AF"][0] >= threshold``.

    Missing (or non-numeric, see :func:`af_value`) AF drops the variant
    (``.getOrElse(false)``, VariantsPca.scala:100-104). ``None`` threshold
    disables the filter.
    """
    if min_allele_frequency is None:
        yield from variants
        return
    for v in variants:
        af = af_value(v.info.get("AF"))
        if af is not None and af >= min_allele_frequency:
            yield v


def carrying_sample_indices(
    variant: Variant, indexes: Dict[str, int]
) -> List[int]:
    """Dense sample indices whose call carries a non-reference allele.

    extractCallInfo + the variation filter of getCallsRdd
    (VariantsPca.scala:56-60, 157-160). Callsets absent from the index are a
    hard error, as in the reference (``mapping(call.callsetId)`` throws).
    """
    out = []
    for call in variant.calls or ():
        if has_variation(call):
            out.append(indexes[call.callset_id])
    return out


def calls_stream(
    streams: Sequence[Iterable[Variant]],
    indexes: Dict[str, int],
) -> Iterator[List[int]]:
    """One dataset's variants → per-variant index lists, dropping variants
    with no carrying samples (getCallsRdd, VariantsPca.scala:153-168)."""
    if len(streams) != 1:
        raise NotImplementedError(
            "multi-dataset join/merge is not ported yet (ROADMAP.md, "
            "Queue 1: JSONL/CSR/network sources and multi-dataset ingest)"
        )
    for v in streams[0]:
        calls = carrying_sample_indices(v, indexes)
        if calls:
            yield calls
