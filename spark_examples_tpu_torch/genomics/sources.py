"""Streaming sources: the in-memory fixture source.

The reference streams shards over gRPC from the Google Genomics v1 API
(``VariantStreamIterator`` with STRICT shard boundaries,
``VariantsRDD.scala:205-235``). That API is retired; this slice of the port
carries the hermetic source, :class:`FixtureSource` (in-memory records, the
"fake genomics service" SURVEY.md §4 calls for). The JSONL, CSR-sidecar and
network sources are a later slice (ROADMAP.md).

Every source enforces the STRICT boundary rule: a record is yielded by
exactly the shard containing its start coordinate, so no deduplication pass
is needed downstream — the guarantee ``ShardBoundary.Requirement.STRICT``
gives the reference (VariantsRDD.scala:210-211).
"""

from __future__ import annotations

import bisect
import threading
from dataclasses import dataclass
from typing import Iterator, List, Optional, Protocol, Sequence

from spark_examples_tpu_torch.genomics.datasets import (
    af_filter,
    af_value,
    carrying_sample_indices,
)
from spark_examples_tpu_torch.genomics.shards import Shard
from spark_examples_tpu_torch.genomics.types import (
    Call,
    Variant,
    normalize_contig,
)
from spark_examples_tpu_torch.utils.stats import IoStats

__all__ = [
    "Callset",
    "VariantSource",
    "FixtureSource",
    "variant_from_record",
]


@dataclass(frozen=True)
class Callset:
    """Callset metadata row (SearchCallSetsResponse analog)."""

    id: str
    name: str
    variant_set_id: str


class VariantSource(Protocol):
    def list_callsets(self, variant_set_id: str) -> List[Callset]: ...

    def stream_variants(
        self, variant_set_id: str, shard: Shard
    ) -> Iterator[Variant]: ...


def variant_from_record(rec: dict) -> Optional[Variant]:
    """JSON record → Variant (drops non-numeric contigs, like the builder)."""
    calls = [
        Call(
            callset_id=c["callset_id"],
            callset_name=c.get("callset_name", c["callset_id"]),
            genotype=tuple(c.get("genotype", ())),
            genotype_likelihood=(
                tuple(c["genotype_likelihood"])
                if c.get("genotype_likelihood")
                else None
            ),
            phaseset=c.get("phaseset", ""),
            info={k: tuple(v) for k, v in c.get("info", {}).items()},
        )
        for c in rec.get("calls", ())
    ]
    return Variant.build(
        rec["reference_name"],
        rec["start"],
        rec["end"],
        rec.get("reference_bases", ""),
        id=rec.get("id", ""),
        names=rec.get("names"),
        alternate_bases=rec.get("alternate_bases"),
        info=rec.get("info"),
        created=rec.get("created", 0),
        variant_set_id=rec.get("variant_set_id", ""),
        calls=calls,
    )


def _strip_chr(name: str) -> str:
    return name[3:] if name.startswith("chr") else name


def _carrying_records(records, indexes, variant_set_id, stats, min_af):
    """The fused ingest fast path over raw records.

    Per-variant carrying sample indices WITHOUT materializing Call/Variant
    objects. Semantics are identical to stream_variants → af_filter →
    carrying_sample_indices:

    - contig normalization drops non-numeric contigs BEFORE the
      variants_read count (VariantsRDD.scala:132-135);
    - the AF filter reads info["AF"][0], missing AF drops
      (VariantsPca.scala:100-104), applied AFTER the count;
    - hasVariation = any genotype allele > 0 (VariantsPca.scala:56-60);
    - unknown callset ids raise KeyError, as the reference's
      ``mapping(call.callsetId)`` throws;
    - empty index lists are dropped (getCallsRdd, VariantsPca.scala:157-160);
    - the variant-set rule: a falsy stored id matches any query; a
      non-empty stored id must equal a non-empty query.
    """
    for rec in records:
        stored = rec.get("variant_set_id")
        if variant_set_id and stored and stored != variant_set_id:
            continue
        if normalize_contig(rec["reference_name"]) is None:
            continue
        stats.add(variants_read=1)
        if min_af is not None:
            af = af_value((rec.get("info") or {}).get("AF"))
            # Negated >= (not <) so non-comparable values (NaN) drop
            # exactly as af_filter's `>= min_af` keep-test does.
            if af is None or not (af >= min_af):
                continue
        out = []
        for c in rec.get("calls", ()):
            for g in c.get("genotype", ()):
                if g > 0:
                    out.append(indexes[c["callset_id"]])
                    break
        if out:
            yield out


def _filtered_variants(variants, stats, min_af):
    """Counted + AF-filtered Variant stream."""

    def counted():
        for v in variants:
            stats.add(variants_read=1)
            yield v

    return af_filter(counted(), min_af)


def _carrying_variants(variants, indexes, stats, min_af):
    """Fast-path semantics over already-built Variant objects (the
    FixtureSource fallback when items are not raw dicts)."""
    for v in _filtered_variants(variants, stats, min_af):
        out = carrying_sample_indices(v, indexes)
        if out:
            yield out


class _SortedIndex:
    """contig → (sorted start positions, items) with bisect range slicing:
    built once, O(log n) per shard query."""

    def __init__(self, by_contig: dict):
        self._by = by_contig

    @staticmethod
    def build(items, key_fn) -> "_SortedIndex":
        tmp: dict = {}
        for it in items:
            contig, start = key_fn(it)
            tmp.setdefault(_strip_chr(contig), []).append((start, it))
        by = {}
        for contig, pairs in tmp.items():
            pairs.sort(key=lambda p: p[0])
            by[contig] = ([p[0] for p in pairs], [p[1] for p in pairs])
        return _SortedIndex(by)

    def slice(self, shard: Shard) -> list:
        """STRICT boundary: items whose start is in [shard.start, shard.end).

        Adjacent windows + half-open bisect bounds ⇒ every record is
        yielded by exactly one shard. Contig matching is lenient on the
        "chr" prefix in either direction, applied at build and query time.
        """
        starts, items = self._by.get(_strip_chr(shard.contig), ([], []))
        lo = bisect.bisect_left(starts, shard.start)
        hi = bisect.bisect_left(starts, shard.end)
        return items[lo:hi]


class FixtureSource:
    """In-memory fake genomics service.

    Holds raw JSON-shaped records (dicts) or already-built objects;
    streaming goes through the same builder path as real ingest so
    contig-drop and STRICT-boundary semantics are exercised. Counts into an
    :class:`IoStats` exactly where the reference's accumulators are fed
    (VariantsRDD.scala:199-203, 214, 218-221).
    """

    def __init__(
        self,
        variants: Sequence = (),
        callsets: Sequence[Callset] = (),
        stats: Optional[IoStats] = None,
    ):
        self._variants = list(variants)
        self._callsets = list(callsets)
        self.stats = stats if stats is not None else IoStats()
        self._variant_idx: Optional[_SortedIndex] = None
        self._idx_lock = threading.Lock()

    @staticmethod
    def _variant_key(item):
        if isinstance(item, Variant):
            return item.contig, item.start
        return item["reference_name"], item["start"]

    def list_callsets(self, variant_set_id: str) -> List[Callset]:
        self.stats.add(requests=1)
        return [
            c for c in self._callsets if c.variant_set_id == variant_set_id
        ]

    def _shard_items(self, shard: Shard) -> list:
        """Stats/index preamble shared by both variant streaming paths."""
        self.stats.add(
            partitions=1, requests=1, reference_bases=shard.range
        )
        if self._variant_idx is None:
            with self._idx_lock:
                if self._variant_idx is None:
                    self._variant_idx = _SortedIndex.build(
                        self._variants, self._variant_key
                    )
        return self._variant_idx.slice(shard)

    def _built(self, items, variant_set_id: str) -> Iterator[Variant]:
        """item (dict | Variant) → Variant, applying the variant-set
        filter and the builder's contig drop (shared by both paths)."""
        for item in items:
            if isinstance(item, Variant):
                v = item
            else:
                stored = item.get("variant_set_id")
                if variant_set_id and stored and stored != variant_set_id:
                    continue
                v = variant_from_record(item)
                if v is None:  # dropped contig
                    continue
            if (
                variant_set_id
                and v.variant_set_id
                and v.variant_set_id != variant_set_id
            ):
                continue
            yield v

    def stream_variants(
        self, variant_set_id: str, shard: Shard
    ) -> Iterator[Variant]:
        for v in self._built(self._shard_items(shard), variant_set_id):
            self.stats.add(variants_read=1)
            yield v

    def stream_carrying(
        self,
        variant_set_id: str,
        shard: Shard,
        indexes: dict,
        min_allele_frequency: Optional[float] = None,
    ) -> Iterator[List[int]]:
        """Fused fast path: per-variant carrying sample indices for the
        shard, skipping Call/Variant materialization (see
        :func:`_carrying_records`). Same stats behavior as
        :meth:`stream_variants`."""
        items = self._shard_items(shard)
        if any(isinstance(i, Variant) for i in items):
            # Object-holding fixtures (test-sized): order-preserving
            # fallback through the shared builder path.
            yield from _carrying_variants(
                self._built(items, variant_set_id),
                indexes,
                self.stats,
                min_allele_frequency,
            )
            return
        yield from _carrying_records(
            items, indexes, variant_set_id, self.stats,
            min_allele_frequency,
        )
