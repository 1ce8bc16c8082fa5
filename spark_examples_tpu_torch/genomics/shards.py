"""Deterministic shard manifests — the unit of data parallelism.

The reference's partitioners turn genomic ranges into one gRPC request per
fixed-size window (``VariantsRDD.scala:260-292``, ``ReadsRDD.scala:150-182``,
``ShardUtils`` in google-genomics-utils). Here a *shard manifest* is a plain
list of ``Shard`` records computed up front — deterministic, so a failed
shard can be re-ingested idempotently (the elasticity story, SURVEY.md §2.10)
and a manifest hash can key checkpoints.

Kept semantics:

- ``--bases-per-partition`` fixed-size windows (default 1,000,000;
  ``GenomicsConf.scala:32-37``);
- explicit ``contig:start:end[,...]`` reference strings
  (``GenomicsConf.scala:47-51``, default BRCA1);
- all-references mode excludes X/Y for variants but includes them for reads
  (``VariantsRDD.scala:274-276`` vs ``ReadsRDD.scala:165``);
- STRICT shard boundaries: a record belongs to exactly the shard containing
  its start coordinate — the dedup rule ``ShardBoundary.Requirement.STRICT``
  enforces (``VariantsRDD.scala:210-211``), enforced here by sources.
"""

from __future__ import annotations

import enum
import hashlib
from dataclasses import dataclass
from typing import Dict, List, Sequence

__all__ = [
    "Shard",
    "SexChromosomeFilter",
    "HUMAN_CHROMOSOMES",
    "parse_references",
    "shards_for_references",
    "shards_for_all_references",
    "chromosomes_for_filter",
    "references_for_all",
    "manifest_digest",
    "DEFAULT_BASES_PER_SHARD",
    "BRCA1_REFERENCES",
    "KLOTHO_REFERENCES",
]

DEFAULT_BASES_PER_SHARD = 1_000_000

# Reference defaults: BRCA1 region (GenomicsConf.scala:33) and the Klotho
# one-SNP window (SearchVariantsExample.scala:44).
BRCA1_REFERENCES = "17:41196311:41277499"
KLOTHO_REFERENCES = "13:33628137:33628138"

# GRCh37 chromosome lengths — Examples.HumanChromosomes,
# SearchReadsExample.scala:41-64.
HUMAN_CHROMOSOMES: Dict[str, int] = {
    "1": 249250621,
    "2": 243199373,
    "3": 198022430,
    "4": 191154276,
    "5": 180915260,
    "6": 171115067,
    "7": 159138663,
    "8": 146364022,
    "9": 141213431,
    "10": 135534747,
    "11": 135006516,
    "12": 133851895,
    "13": 115169878,
    "14": 107349540,
    "15": 102531392,
    "16": 90354753,
    "17": 81195210,
    "18": 78077248,
    "19": 59128983,
    "20": 63025520,
    "21": 48129895,
    "22": 51304566,
    "X": 155270560,
    "Y": 59373566,
}


class SexChromosomeFilter(enum.Enum):
    """ShardUtils.SexChromosomeFilter parity: variants EXCLUDE_XY
    (VariantsRDD.scala:275), reads INCLUDE_XY (ReadsRDD.scala:165)."""

    EXCLUDE_XY = "exclude_xy"
    INCLUDE_XY = "include_xy"


@dataclass(frozen=True)
class Shard:
    """One genomic-range request: the manifest entry.

    The analog of the serialized ``StreamVariantsRequest`` bytes held by a
    ``VariantsPartition`` (VariantsRDD.scala:242-252) — but human-readable
    and hashable, since there is no protobuf-over-closure constraint.
    """

    contig: str
    start: int
    end: int  # exclusive

    @property
    def range(self) -> int:
        return self.end - self.start


def parse_references(references: str) -> List[tuple]:
    """``"contig:start:end[,contig:start:end...]"`` → [(contig, start, end)].

    The flag format of ``--references`` (GenomicsConf.scala:47-51).
    """
    out = []
    for part in references.split(","):
        part = part.strip()
        if not part:
            continue
        contig, start, end = part.split(":")
        out.append((contig, int(start), int(end)))
    return out


def _window(contig: str, start: int, end: int, bases_per_shard: int):
    pos = start
    while pos < end:
        yield Shard(contig, pos, min(pos + bases_per_shard, end))
        pos += bases_per_shard


def shards_for_references(
    references: str, bases_per_shard: int = DEFAULT_BASES_PER_SHARD
) -> List[Shard]:
    """Shard an explicit reference string — ReferencesVariantsPartitioner
    (VariantsRDD.scala:282-292) / ReferencesReadsPartitioner semantics."""
    shards = []
    for contig, start, end in parse_references(references):
        shards.extend(_window(contig, start, end, bases_per_shard))
    return shards


def chromosomes_for_filter(
    sex_filter: SexChromosomeFilter = SexChromosomeFilter.EXCLUDE_XY,
    chromosomes: Dict[str, int] = None,
) -> Dict[str, int]:
    """The chromosome table after the sex filter — the ONE place the
    EXCLUDE_XY policy lives (VariantsRDD.scala:275 vs ReadsRDD.scala:165)."""
    chromosomes = chromosomes or HUMAN_CHROMOSOMES
    if sex_filter is not SexChromosomeFilter.EXCLUDE_XY:
        return dict(chromosomes)
    return {
        c: length
        for c, length in chromosomes.items()
        if c not in ("X", "Y")
    }


def references_for_all(
    sex_filter: SexChromosomeFilter = SexChromosomeFilter.EXCLUDE_XY,
    chromosomes: Dict[str, int] = None,
) -> str:
    """All covered chromosomes as a ``--references`` string (whole-length
    regions) — so cohort generators can target exactly what an
    --all-references manifest queries."""
    return ",".join(
        f"{c}:0:{length}"
        for c, length in chromosomes_for_filter(
            sex_filter, chromosomes
        ).items()
    )


def shards_for_all_references(
    sex_filter: SexChromosomeFilter = SexChromosomeFilter.EXCLUDE_XY,
    bases_per_shard: int = DEFAULT_BASES_PER_SHARD,
    chromosomes: Dict[str, int] = None,
) -> List[Shard]:
    """Cover every chromosome — AllReferences{Variants,Reads}Partitioner
    (VariantsRDD.scala:266-280, ReadsRDD.scala:158-170)."""
    shards = []
    for contig, length in chromosomes_for_filter(
        sex_filter, chromosomes
    ).items():
        shards.extend(_window(contig, 0, length, bases_per_shard))
    return shards


def manifest_digest(shards: Sequence[Shard]) -> str:
    """Stable digest of a shard manifest — the checkpoint/resume key."""
    h = hashlib.sha256()
    for s in shards:
        h.update(f"{s.contig}:{s.start}:{s.end};".encode())
    return h.hexdigest()[:16]
