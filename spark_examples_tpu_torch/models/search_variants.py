"""Search-variants example drivers — SearchVariantsExample.scala parity.

The JAX package's ``models/search_variants.py``.

Two small inspection drivers over a variantset region, plus the
record↔object round-trip exercise the reference carries in the Klotho
example (its ``toJavaVariant`` loop, ``SearchVariantsExample.scala:74-81``;
here the round trip is record-dict → Variant → record-dict).
"""

from __future__ import annotations

from typing import List

from spark_examples_tpu_torch.genomics.shards import (
    BRCA1_REFERENCES,
    DEFAULT_BASES_PER_SHARD,
    KLOTHO_REFERENCES,
    shards_for_references,
)
from spark_examples_tpu_torch.genomics.sources import (
    _variant_to_record,
    variant_from_record,
)

__all__ = [
    "GoogleGenomicsPublicData",
    "search_variants_klotho",
    "search_variants_brca1",
]


class GoogleGenomicsPublicData:
    """Well-known variantset ids — SearchVariantsExample.scala:27-31."""

    PLATINUM_GENOMES = "3049512673186936334"
    THOUSAND_GENOMES = "10473108253681171589"
    THOUSAND_GENOMES_PHASE_3 = "4252737135923902652"


def _collect(source, variant_set_id, references, bases_per_shard):
    return [
        v
        for s in shards_for_references(references, bases_per_shard)
        for v in source.stream_variants(variant_set_id, s)
    ]


def search_variants_klotho(
    source,
    variant_set_id: str = GoogleGenomicsPublicData.PLATINUM_GENOMES,
    references: str = KLOTHO_REFERENCES,
    bases_per_shard: int = DEFAULT_BASES_PER_SHARD,
) -> List[str]:
    """One-SNP window inspection (SearchVariantsExampleKlotho, :39-84).

    Counts records / variant records / reference-matching blocks, prints
    each non-N-reference variant's position, and exercises the
    record-conversion round trip for every record.
    """
    data = _collect(source, variant_set_id, references, bases_per_shard)
    lines = [f"We have {len(data)} records that overlap Klotho."]
    n_variant = sum(1 for v in data if v.alternate_bases is not None)
    lines.append(f"But only {n_variant} records are of a variant.")
    lines.append(
        f"The other {len(data) - n_variant} records are "
        "reference-matching blocks."
    )
    for v in data:
        if v.reference_bases != "N":
            lines.append(f"Reference: {v.contig} @ {v.start}")
    # Round-trip exercise (toJavaVariant analog): must reconstruct equal.
    for v in data:
        rec = _variant_to_record(v)
        if variant_from_record(rec) != v:
            raise ValueError(f"round-trip mismatch for {v.id or v.start}")
    for line in lines:
        print(line)
    return lines


def search_variants_brca1(
    source,
    variant_set_id: str = GoogleGenomicsPublicData.PLATINUM_GENOMES,
    references: str = BRCA1_REFERENCES,
    bases_per_shard: int = DEFAULT_BASES_PER_SHARD,
) -> List[str]:
    """All variants overlapping BRCA1 (SearchVariantsExampleBRCA1, :89-114).

    Note the reference's variant/block split here keys on
    ``referenceBases != "N"`` (unlike Klotho's ``alternateBases`` test) —
    replicated as-is.
    """
    data = _collect(source, variant_set_id, references, bases_per_shard)
    lines = [f"We have {len(data)} records that overlap BRCA1."]
    n_variant = sum(1 for v in data if v.reference_bases != "N")
    lines.append(f"But only {n_variant} records are of a variant.")
    lines.append(
        f"The other {len(data) - n_variant} records are "
        "reference-matching blocks."
    )
    for line in lines:
        print(line)
    return lines
