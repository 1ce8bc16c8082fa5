"""Typed genomic records with the reference's exact messy-bit semantics.

Mirrors the serializable case classes of ``rdd/VariantsRDD.scala:46-98`` and
``rdd/ReadsRDD.scala:44-48`` — but as plain Python dataclasses: there is no
JVM closure serialization to appease, and the device never sees these (only
dense genotype blocks reach the device).

Faithfully-kept behaviors (SURVEY.md §7 "hard parts" #4):

- contig normalization via the regex ``([a-z]*)?([0-9]*)`` keeping only the
  numeric id and *dropping* variants on non-matching contigs (chrX/chrY/chrM,
  alt contigs) — ``VariantsRDD.scala:103-110, 132-135``;
- ``has_variation``: a call carries variation iff any genotype allele > 0 —
  ``VariantsPca.scala:56-60``;
- cigar enum → SAM letter table — ``ReadsRDD.scala:52-61``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, NamedTuple, Optional

__all__ = [
    "Call",
    "Variant",
    "Read",
    "VariantKey",
    "ReadKey",
    "normalize_contig",
    "has_variation",
    "CIGAR_MATCH",
]

# Anchored equivalent of the Scala pattern match at VariantsRDD.scala:103.
_REF_NAME_RE = re.compile(r"([a-z]*)?([0-9]*)")


def normalize_contig(reference_name: str) -> Optional[str]:
    """"chr17" → "17"; non-matching contigs (chrX, chrM, HLA-*) → None.

    Scala pattern matching anchors the regex to the full string, so any
    uppercase letter or punctuation anywhere fails the match and the variant
    is dropped by the builder — replicated with ``fullmatch``.
    """
    m = _REF_NAME_RE.fullmatch(reference_name)
    if m is None:
        return None
    return m.group(2)


class VariantKey(NamedTuple):
    """(contig, position) ordering key — VariantsRDD.scala:258."""

    contig: str
    position: int


class ReadKey(NamedTuple):
    """(reference_name, position) ordering key — ReadsRDD.scala per-read key."""

    reference_name: str
    position: int


@dataclass(frozen=True)
class Call:
    """One sample's genotype call at a variant — VariantsRDD.scala:46-48."""

    callset_id: str
    callset_name: str
    genotype: tuple  # e.g. (0, 1); -1 for no-call
    genotype_likelihood: Optional[tuple] = None
    phaseset: str = ""
    info: Dict[str, tuple] = field(default_factory=dict)


@dataclass(frozen=True)
class Variant:
    """A variant with optional per-sample calls — VariantsRDD.scala:51-98.

    ``contig`` is the *normalized* numeric contig id (post
    :func:`normalize_contig`); ``reference_name`` as streamed from a source
    is normalized at build time, so a constructed ``Variant`` is always on a
    kept contig.
    """

    contig: str
    id: str
    start: int
    end: int
    reference_bases: str
    names: Optional[tuple] = None
    alternate_bases: Optional[tuple] = None
    info: Dict[str, tuple] = field(default_factory=dict)
    created: int = 0
    variant_set_id: str = ""
    calls: Optional[tuple] = None  # tuple[Call, ...]

    @staticmethod
    def build(
        reference_name: str,
        start: int,
        end: int,
        reference_bases: str,
        *,
        id: str = "",
        names=None,
        alternate_bases=None,
        info=None,
        created: int = 0,
        variant_set_id: str = "",
        calls=None,
    ) -> Optional["Variant"]:
        """Record → Variant, or None when the contig is dropped.

        The analog of ``VariantsBuilder.build`` (VariantsRDD.scala:115-157):
        normalization failure drops the record.
        """
        contig = normalize_contig(reference_name)
        if contig is None:
            return None
        return Variant(
            contig=contig,
            id=id,
            start=start,
            end=end,
            reference_bases=reference_bases,
            names=tuple(names) if names else None,
            alternate_bases=tuple(alternate_bases) if alternate_bases else None,
            info=dict(info) if info else {},
            created=created,
            variant_set_id=variant_set_id,
            calls=tuple(calls) if calls else None,
        )

    def key(self) -> VariantKey:
        return VariantKey(self.contig, self.start)


def has_variation(call: Call) -> bool:
    """True iff the sample carries any non-reference allele.

    ``call.genotype.foldLeft(false)(_ || _ > 0)`` — VariantsPca.scala:58.
    No-calls (-1) and hom-ref (0/0) are False.
    """
    return any(g > 0 for g in call.genotype)


# Cigar enum → SAM letter — ReadsRDD.scala:52-61.
CIGAR_MATCH = {
    "ALIGNMENT_MATCH": "M",
    "CLIP_HARD": "H",
    "CLIP_SOFT": "S",
    "DELETE": "D",
    "INSERT": "I",
    "PAD": "P",
    "SEQUENCE_MATCH": "=",
    "SEQUENCE_MISMATCH": "X",
    "SKIP": "N",
}


@dataclass(frozen=True)
class Read:
    """An aligned read — ReadsRDD.scala:44-48 field-for-field.

    ``cigar`` is the SAM string (e.g. ``"100M"``) assembled through
    :data:`CIGAR_MATCH` at build time, as ``ReadBuilder.fromJavaRead`` does.
    """

    aligned_quality: tuple
    cigar: str
    id: str
    mapping_quality: int
    mate_position: int
    mate_reference_name: str
    fragment_name: str
    aligned_sequence: str
    position: int
    read_group_set_id: str
    reference_name: str
    info: Dict[str, tuple] = field(default_factory=dict)
    fragment_length: int = 0

    @staticmethod
    def build(
        reference_name: str,
        position: int,
        aligned_sequence: str,
        *,
        cigar_ops=(),  # iterable of (op_name, length)
        aligned_quality=(),
        id: str = "",
        mapping_quality: int = 0,
        mate_position: int = -1,
        mate_reference_name: str = "",
        fragment_name: str = "",
        read_group_set_id: str = "",
        info=None,
        fragment_length: int = 0,
    ) -> "Read":
        cigar = "".join(
            f"{length}{CIGAR_MATCH[op]}" for op, length in cigar_ops
        )
        return Read(
            aligned_quality=tuple(aligned_quality),
            cigar=cigar,
            id=id,
            mapping_quality=mapping_quality,
            mate_position=mate_position,
            mate_reference_name=mate_reference_name,
            fragment_name=fragment_name,
            aligned_sequence=aligned_sequence,
            position=position,
            read_group_set_id=read_group_set_id,
            reference_name=reference_name,
            info=dict(info) if info else {},
            fragment_length=fragment_length,
        )

    def key(self) -> ReadKey:
        return ReadKey(self.reference_name, self.position)
