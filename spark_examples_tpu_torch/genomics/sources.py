"""Streaming sources: the in-memory fixture and the on-disk JSONL cohort.

The reference streams shards over gRPC from the Google Genomics v1 API
(``VariantStreamIterator`` with STRICT shard boundaries,
``VariantsRDD.scala:205-235``). That API is retired; the port carries the
JAX package's local sources:

- :class:`FixtureSource` — in-memory records; the hermetic test and
  benchmark source (the "fake genomics service" SURVEY.md §4 calls for);
- :class:`JsonlSource` — a newline-JSON cohort directory on disk
  (``callsets.json`` + ``variants.jsonl[.gz]``), served to the fused
  ingest tiers from a persistent columnar CSR sidecar
  (:class:`_CsrCohort`, the JAX package's file format: either package
  loads the other's sidecar without a rebuild) and to the staged record
  path through a byte-offset line index (:class:`_LineIndex`).

Both also carry the serving methods the HTTP service
(:mod:`spark_examples_tpu_torch.genomics.service`) fronts: the callset
ordinal order, one shard's carrying CSR pair in ordinals (the binary wire
frame's payload), the raw record lines of a shard, the whole-cohort
interchange export and the cohort identity.

Every source enforces the STRICT boundary rule: a record is yielded by
exactly the shard containing its start coordinate, so no deduplication pass
is needed downstream — the guarantee ``ShardBoundary.Requirement.STRICT``
gives the reference (VariantsRDD.scala:210-211).
"""

from __future__ import annotations

import bisect
import ctypes
import gzip
import io
import json
import mmap
import os
import struct
import threading
import zipfile
import zlib
from dataclasses import dataclass
from typing import Iterator, List, Optional, Protocol, Sequence

import numpy as np
from numpy.lib import format as npformat

from spark_examples_tpu_torch import native as native_core
from spark_examples_tpu_torch.genomics.datasets import (
    _variant_triples,
    af_filter,
    af_value,
    carrying_sample_indices,
)
from spark_examples_tpu_torch.genomics.hashing import (
    _identity_payload,
    hash_payloads,
)
from spark_examples_tpu_torch.genomics.shards import Shard
from spark_examples_tpu_torch.genomics.types import (
    Call,
    Read,
    Variant,
    normalize_contig,
)
from spark_examples_tpu_torch.resilience.faults import FaultPlan, FaultRule
from spark_examples_tpu_torch.utils.stats import IoStats
from spark_examples_tpu_torch.utils.tracing import rpc_range

__all__ = [
    "Callset",
    "VariantSource",
    "ReadSource",
    "FixtureSource",
    "JsonlSource",
    "LINEIDX_BASENAME",
    "SIDECAR_BASENAME",
    "csr_pair_from_lists",
    "read_from_record",
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


class ReadSource(Protocol):
    def stream_reads(
        self, read_group_set_id: str, shard: Shard
    ) -> Iterator[Read]: ...


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


def _variant_to_record(v: Variant) -> dict:
    return {
        "reference_name": v.contig,
        "start": v.start,
        "end": v.end,
        "reference_bases": v.reference_bases,
        "id": v.id,
        "names": list(v.names) if v.names else None,
        "alternate_bases": list(v.alternate_bases)
        if v.alternate_bases
        else None,
        "info": {k: list(val) for k, val in v.info.items()},
        "created": v.created,
        "variant_set_id": v.variant_set_id,
        "calls": [
            {
                "callset_id": c.callset_id,
                "callset_name": c.callset_name,
                "genotype": list(c.genotype),
                "genotype_likelihood": list(c.genotype_likelihood)
                if c.genotype_likelihood
                else None,
                "phaseset": c.phaseset,
                "info": {k: list(val) for k, val in c.info.items()},
            }
            for c in (v.calls or ())
        ],
    }


def read_from_record(rec: dict) -> Read:
    if "cigar" in rec and "cigar_ops" not in rec:
        # Already-assembled SAM cigar (a re-serialized Read, e.g. over the
        # HTTP service): reconstruct directly — Read.build only converts
        # enum op tuples.
        return Read(
            aligned_quality=tuple(rec.get("aligned_quality", ())),
            cigar=rec["cigar"],
            id=rec.get("id", ""),
            mapping_quality=rec.get("mapping_quality", 0),
            mate_position=rec.get("mate_position", -1),
            mate_reference_name=rec.get("mate_reference_name", ""),
            fragment_name=rec.get("fragment_name", ""),
            aligned_sequence=rec.get("aligned_sequence", ""),
            position=rec["position"],
            read_group_set_id=rec.get("read_group_set_id", ""),
            reference_name=rec["reference_name"],
            # Same info-value shape as Read.build (plain parsed lists), so
            # HTTP-fetched and locally-read records stay field-identical.
            info=dict(rec.get("info", {})),
            fragment_length=rec.get("fragment_length", 0),
        )
    return Read.build(
        rec["reference_name"],
        rec["position"],
        rec.get("aligned_sequence", ""),
        cigar_ops=rec.get("cigar_ops", ()),
        aligned_quality=rec.get("aligned_quality", ()),
        id=rec.get("id", ""),
        mapping_quality=rec.get("mapping_quality", 0),
        mate_position=rec.get("mate_position", -1),
        mate_reference_name=rec.get("mate_reference_name", ""),
        fragment_name=rec.get("fragment_name", ""),
        read_group_set_id=rec.get("read_group_set_id", ""),
        info=rec.get("info"),
        fragment_length=rec.get("fragment_length", 0),
    )


def _read_to_record(r: Read) -> dict:
    return {
        "reference_name": r.reference_name,
        "position": r.position,
        "aligned_sequence": r.aligned_sequence,
        "cigar": r.cigar,
        "aligned_quality": list(r.aligned_quality),
        "id": r.id,
        "mapping_quality": r.mapping_quality,
        "mate_position": r.mate_position,
        "mate_reference_name": r.mate_reference_name,
        "fragment_name": r.fragment_name,
        "read_group_set_id": r.read_group_set_id,
        "info": {k: list(v) for k, v in r.info.items()},
        "fragment_length": r.fragment_length,
    }


def _strip_chr(name: str) -> str:
    return name[3:] if name.startswith("chr") else name


def _extracted_records(records, indexes, variant_set_id, stats, min_af):
    """The ONE record-extraction loop every fused path shares.

    Yields (record, normalized contig, carrying indices) applying the
    full shared semantics — variant-set wildcard rule, contig drop,
    variants_read accounting, AF NaN-drop, hasVariation, KeyError on
    unknown callsets. Wrappers shape the output; the semantics live here
    exactly once.
    """
    for rec in records:
        stored = rec.get("variant_set_id")
        if variant_set_id and stored and stored != variant_set_id:
            continue
        contig = normalize_contig(rec["reference_name"])
        if contig is None:
            continue
        stats.add(variants_read=1)
        if min_af is not None:
            af = af_value((rec.get("info") or {}).get("AF"))
            # Negated >= (not <) so non-comparable values (NaN) drop
            # exactly as af_filter's `>= min_af` keep-test does; None is
            # missing-or-non-numeric (af_value docs).
            if af is None or not (af >= min_af):
                continue
        out = []
        for c in rec.get("calls", ()):
            for g in c.get("genotype", ()):
                if g > 0:
                    out.append(indexes[c["callset_id"]])
                    break
        yield rec, contig, out


def _carrying_records(records, indexes, variant_set_id, stats, min_af):
    """The fused ingest fast path over raw records.

    Per-variant carrying sample indices WITHOUT materializing Call/Variant
    objects: every consumer of the PCA path needs only these index lists.
    Semantics are identical to stream_variants → af_filter →
    carrying_sample_indices:

    - contig normalization drops non-numeric contigs BEFORE the
      variants_read count (VariantsRDD.scala:132-135);
    - the AF filter reads info["AF"][0], missing AF drops
      (VariantsPca.scala:100-104), applied AFTER the count (the reference
      filters downstream of ingest);
    - hasVariation = any genotype allele > 0 (VariantsPca.scala:56-60);
    - unknown callset ids raise KeyError, as the reference's
      ``mapping(call.callsetId)`` throws;
    - empty index lists are dropped (getCallsRdd, VariantsPca.scala:157-160);
    - the ONE variant-set rule (applied identically by every ingest path,
      dict or object or sidecar): a falsy stored id — missing key, null,
      "" — matches any query; a non-empty stored id must equal a
      non-empty query. (Serialization turns a missing key into an
      explicit "", so "" must stay a wildcard or HTTP round-trips would
      change filtering.)
    """
    for _rec, _contig, out in _extracted_records(
        records, indexes, variant_set_id, stats, min_af
    ):
        if out:
            yield out


def _carrying_keyed_records(records, indexes, variant_set_id, stats, min_af):
    """(contig, identity payload, carrying indices) triples — the fused
    MULTI-dataset path: :func:`_carrying_records` plus the cross-dataset
    identity fields (VariantsPca.scala:62-78).

    Unlike the single-dataset path, variants with NO carrying calls are
    kept: the reference joins RECORDS, so a variant empty in one dataset
    still contributes its peers' calls; the empty-drop happens after
    concatenation (getCallsRdd).
    """
    for rec, contig, out in _extracted_records(
        records, indexes, variant_set_id, stats, min_af
    ):
        yield (
            contig,
            _identity_payload(
                contig,
                rec["start"],
                rec["end"],
                rec.get("reference_bases", ""),
                rec.get("alternate_bases"),
            ),
            out,
        )


def _filtered_variants(variants, stats, min_af):
    """Counted + AF-filtered Variant stream (shared by both object-path
    fallbacks)."""

    def counted():
        for v in variants:
            stats.add(variants_read=1)
            yield v

    return af_filter(counted(), min_af)


def _keyed_from_variants(variants, indexes, stats, min_af):
    """Keyed-triple semantics over built Variant objects (the fallback
    when items are not raw dicts) — the same triple shape
    datasets._variant_triples produces."""
    return _variant_triples(
        _filtered_variants(variants, stats, min_af), indexes
    )


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


class _FailOnceShards:
    """The fail-once surface (``src._fail_once.add(shard)``) on the
    resilience fault plane: each added shard becomes a one-shot
    ``fixture.stream`` error rule on the source's plan."""

    def __init__(self, plan: FaultPlan):
        self._plan = plan

    def add(self, shard) -> None:
        self._plan.add_rule(
            FaultRule(
                site="fixture.stream",
                kind="error",
                times=1,
                match=str(shard),
            )
        )


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
        reads: Sequence = (),
        stats: Optional[IoStats] = None,
        fail_shards: Sequence[Shard] = (),
    ):
        self._variants = list(variants)
        self._callsets = list(callsets)
        self._reads = list(reads)
        self.stats = stats if stats is not None else IoStats()
        # Fault injection rides the resilience fault plane (a per-source
        # FaultPlan at site "fixture.stream"): ``fail_shards`` become
        # one-shot error rules keyed by shard, exercising the retry path
        # the reference delegates to Spark task re-execution.
        self.faults = FaultPlan()
        self._fail_once = _FailOnceShards(self.faults)
        for shard in fail_shards:
            self._fail_once.add(shard)
        self._variant_idx: Optional[_SortedIndex] = None
        self._read_idx: Optional[_SortedIndex] = None
        # Served fixtures take concurrent shard requests (threaded HTTP
        # handlers, shard-parallel clients): build each index once.
        self._idx_lock = threading.Lock()
        self._identity: Optional[str] = None

    @staticmethod
    def _variant_key(item):
        if isinstance(item, Variant):
            return item.contig, item.start
        return item["reference_name"], item["start"]

    @staticmethod
    def _read_key(item):
        if isinstance(item, Read):
            return item.reference_name, item.position
        return item["reference_name"], item["position"]

    def list_callsets(self, variant_set_id: str) -> List[Callset]:
        self.stats.add(requests=1)
        return [
            c for c in self._callsets if c.variant_set_id == variant_set_id
        ]

    def _shard_items(self, shard: Shard) -> list:
        """Stats/fault-injection/index preamble shared by both variant
        streaming paths."""
        self.stats.add(
            partitions=1, requests=1, reference_bases=shard.range
        )
        try:
            # Per-source fault plane (see __init__): one-shot fail_shards
            # rules plus whatever a test registered on ``self.faults``.
            self.faults.inject("fixture.stream", key=str(shard))
        except IOError as e:
            self.stats.add(io_exceptions=1)
            raise IOError(f"injected stream failure for {shard}") from e
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

    def stream_carrying_keyed(
        self,
        variant_set_id: str,
        shard: Shard,
        indexes: dict,
        min_allele_frequency: Optional[float] = None,
    ):
        """Fused multi-dataset fast path: (contig, identity payload,
        carrying indices) triples (see :func:`_carrying_keyed_records`)."""
        items = self._shard_items(shard)
        if any(isinstance(i, Variant) for i in items):
            yield from _keyed_from_variants(
                self._built(items, variant_set_id),
                indexes,
                self.stats,
                min_allele_frequency,
            )
            return
        yield from _carrying_keyed_records(
            items, indexes, variant_set_id, self.stats,
            min_allele_frequency,
        )

    def callset_order(self) -> List[str]:
        """Callset ids in ORDINAL order — the id space binary wire
        frames index into (for a fixture, construction order)."""
        return [c.id for c in self._callsets]

    def stream_carrying_frame(
        self,
        variant_set_id: str,
        shard: Shard,
        min_allele_frequency: Optional[float] = None,
    ):
        """One shard's carrying CSR pair in callset ORDINALS plus the
        variants_read count — the binary wire tier's payload
        (:mod:`~spark_examples_tpu_torch.genomics.wire`). Ordinals are
        positions in :meth:`callset_order`; the CLIENT remaps them to its
        dense sample indexes. Same stats behavior as
        :meth:`stream_carrying`; the count rides separately so the serving
        transport can forward it (client IoStats must match the record
        tiers)."""
        items = self._shard_items(shard)
        ord_of = {c.id: i for i, c in enumerate(self._callsets)}
        priv = IoStats()
        if any(isinstance(i, Variant) for i in items):
            lists = _carrying_variants(
                self._built(items, variant_set_id),
                ord_of,
                priv,
                min_allele_frequency,
            )
        else:
            lists = _carrying_records(
                items, ord_of, variant_set_id, priv, min_allele_frequency
            )
        pair = csr_pair_from_lists(lists)
        self.stats.add(variants_read=priv.variants_read)
        if pair is None:
            return (
                np.zeros(0, dtype=np.int64),
                np.zeros(1, dtype=np.int64),
                priv.variants_read,
            )
        return pair[0], pair[1], priv.variants_read

    def stream_reads(
        self, read_group_set_id: str, shard: Shard
    ) -> Iterator[Read]:
        self.stats.add(partitions=1, requests=1, reference_bases=shard.range)
        if self._read_idx is None:
            with self._idx_lock:
                if self._read_idx is None:
                    self._read_idx = _SortedIndex.build(
                        self._reads, self._read_key
                    )
        for item in self._read_idx.slice(shard):
            r = item if isinstance(item, Read) else read_from_record(item)
            if (
                read_group_set_id
                and r.read_group_set_id
                and r.read_group_set_id != read_group_set_id
            ):
                continue
            self.stats.add(reads_read=1)
            yield r

    def add_reads(self, reads: Sequence) -> None:
        """Attach read records so one cohort serves both pipelines."""
        self._reads = list(reads)
        self._read_idx = None
        self._identity = None

    def reads_records(self) -> list:
        return list(self._reads)

    def cohort_identity(self) -> str:
        """Content digest identifying this cohort (the ETag analog): a
        digest of the interchange export, computed once — a served
        fixture's records do not change (the only in-place mutator,
        :meth:`add_reads`, invalidates it). The JAX package's digest,
        byte for byte."""
        if self._identity is None:
            import hashlib

            h = hashlib.sha256()
            for name in ("callsets.json", "variants.jsonl", "reads.jsonl"):
                for line in self.export_lines(name):
                    h.update(line)
                    h.update(b"\n")
                h.update(b"\x00")
            self._identity = h.hexdigest()[:16]
        return self._identity

    def export_lines(self, name: str) -> Iterator[bytes]:
        """Serialized interchange-file lines for the whole-cohort export
        endpoint (the schema of :meth:`dump`, streamed instead of
        written)."""
        if name == "callsets.json":
            yield json.dumps(
                [
                    {
                        "id": c.id,
                        "name": c.name,
                        "variant_set_id": c.variant_set_id,
                    }
                    for c in self._callsets
                ]
            ).encode()
        elif name == "variants.jsonl":
            for rec in self._variants:
                if isinstance(rec, Variant):
                    rec = _variant_to_record(rec)
                yield json.dumps(rec).encode()
        elif name == "reads.jsonl":
            for rec in self._reads:
                if isinstance(rec, Read):
                    rec = _read_to_record(rec)
                yield json.dumps(rec).encode()
        else:
            raise KeyError(name)

    def dump(self, root: str) -> None:
        """Write the cohort as a JSONL directory readable by
        :class:`JsonlSource` (the JAX package's interchange schema, line
        for line)."""
        os.makedirs(root, exist_ok=True)
        with open(os.path.join(root, "callsets.json"), "w") as f:
            json.dump(
                [
                    {
                        "id": c.id,
                        "name": c.name,
                        "variant_set_id": c.variant_set_id,
                    }
                    for c in self._callsets
                ],
                f,
            )
        with open(os.path.join(root, "variants.jsonl"), "w") as f:
            for rec in self._variants:
                if isinstance(rec, Variant):
                    rec = _variant_to_record(rec)
                f.write(json.dumps(rec) + "\n")
        if self._reads:
            with open(os.path.join(root, "reads.jsonl"), "w") as f:
                for rec in self._reads:
                    if isinstance(rec, Read):
                        raise TypeError(
                            "dump() requires raw read records (dicts)"
                        )
                    f.write(json.dumps(rec) + "\n")


# Interchange-layout names, the JAX package's: the CSR sidecar, the line
# index, and the remote-mirror markers the cohort mirror
# (genomics/mirror.py) writes beside them.
SIDECAR_BASENAME = ".variants.csr.npz"
LINEIDX_BASENAME = ".variants.lineidx.npz"
MIRROR_COMPLETE_MARKER = ".complete"
MIRROR_IDENTITY_FILE = ".identity"
MIRROR_SIDECAR_OK = ".sidecar-ok"


class _LineIndex:
    """Byte-offset shard index over an UNCOMPRESSED ``variants.jsonl``.

    Staged-streaming (and, with the network tier, serving) a huge cohort
    must not require the parsed-record index: at all-autosomes scale
    (~56 KB per record) parsing every record into host memory costs
    minutes of CPU and several times more RAM than the file. This index
    keeps ONE small tuple per line — (contig, start, byte offset, byte
    length) — ~24 B/record in numpy arrays, so a shard query is a bisect
    plus seeks, and staged ingest parses only the shard's own window (the
    closest analog to the reference backend's storage-side slicing behind
    its gRPC streams, ``VariantsRDD.scala:205-211``).

    Built in one streaming pass (targeted field scan with a
    ``json.loads`` fallback per line) and persisted next to the file,
    keyed by (size, mtime_ns) exactly like the CSR sidecar. Layout
    mirrors ``_SortedIndex``: per-contig segments, rows sorted by start
    within each segment, half-open ``[start, end)`` bisect slicing (the
    STRICT shard-boundary contract), "chr"-lenient contig matching.
    """

    VERSION = 1

    def __init__(self, data: dict):
        self._starts = data["starts"]
        self._offsets = data["offsets"]
        self._lengths = data["lengths"]
        self._by = {
            _strip_chr(str(c)): (int(lo), int(hi))
            for c, lo, hi in zip(
                data["contigs"].tolist(),
                data["seg_lo"].tolist(),
                data["seg_hi"].tolist(),
            )
        }

    @property
    def total(self) -> int:
        return int(self._starts.shape[0])

    @staticmethod
    def _digest(path: str) -> str:
        st = os.stat(path)
        return (
            f"lineidx-v{_LineIndex.VERSION}|"
            f"{os.path.basename(path)}:{st.st_size}:{st.st_mtime_ns}"
        )

    @staticmethod
    def _extract_fields(line: bytes):
        """(contig, start) from one interchange line, or None → caller
        falls back to json.loads. Targeted scan, not a JSON parse: at
        56 KB/record the two header fields sit in the first ~100 bytes
        and a full parse per line is ~100× the cost.

        TOP-LEVEL GUARD: a key match past the record's first nested
        container (the '[' or '{' opening calls/info/alternate_bases)
        could be a key INSIDE a call — e.g. an info field literally
        named "start" — and silently index the record at the wrong
        coordinate. Any match beyond that point falls back to the real
        parse instead.
        """
        nested = len(line)
        for tok in (b"[", b"{"):
            p = line.find(tok, 1)  # skip the record's own opening brace
            if p >= 0:
                nested = min(nested, p)
        i = line.find(b'"reference_name"')
        if i < 0 or i > nested:
            return None
        contig = _scan_json_string(line, b'"reference_name"')
        if contig is None:
            return None
        i = line.find(b'"start"')
        if i < 0 or i > nested:
            return None
        i = line.find(b":", i)
        if i < 0:
            return None
        i += 1
        n = len(line)
        while i < n and line[i] in b" \t":
            i += 1
        j = i
        if j < n and line[j] in b"-":
            j += 1
        while j < n and line[j : j + 1].isdigit():
            j += 1
        if j == i:
            return None
        return contig, int(line[i:j])

    @classmethod
    def load_or_build(cls, root: str) -> "_LineIndex":
        path = os.path.join(root, "variants.jsonl")
        idx_path = os.path.join(root, LINEIDX_BASENAME)
        digest = cls._digest(path)
        if os.path.exists(idx_path):
            try:
                data = dict(np.load(idx_path, allow_pickle=False))
                if str(data["digest"]) == digest:
                    return cls(data)
            except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
                pass  # unreadable/stale → rebuild
        contigs: list = []
        starts: list = []
        offsets: list = []
        lengths: list = []
        with open(path, "rb") as f:
            off = 0
            for line in f:
                ln = len(line)
                stripped = line.rstrip(b"\r\n")
                if stripped:
                    fields = cls._extract_fields(stripped)
                    if fields is None:
                        rec = json.loads(stripped)
                        fields = (
                            str(rec["reference_name"]),
                            int(rec["start"]),
                        )
                    # Strip BEFORE grouping (exactly like _SortedIndex):
                    # a cohort mixing "chr1" and "1" spellings must land
                    # in ONE segment, not have one spelling's segment
                    # silently shadow the other's in the lookup dict.
                    contigs.append(_strip_chr(fields[0]))
                    starts.append(fields[1])
                    offsets.append(off)
                    lengths.append(len(stripped))
                off += ln
        order = sorted(
            range(len(starts)), key=lambda i: (contigs[i], starts[i])
        )
        seg_names: list = []
        seg_lo: list = []
        seg_hi: list = []
        for pos, i in enumerate(order):
            if not seg_names or contigs[i] != seg_names[-1]:
                if seg_names:
                    seg_hi.append(pos)
                seg_names.append(contigs[i])
                seg_lo.append(pos)
        if seg_names:
            seg_hi.append(len(order))
        data = {
            "digest": digest,
            "contigs": np.asarray(seg_names),
            "seg_lo": np.asarray(seg_lo, dtype=np.int64),
            "seg_hi": np.asarray(seg_hi, dtype=np.int64),
            "starts": np.asarray(
                [starts[i] for i in order], dtype=np.int64
            ),
            "offsets": np.asarray(
                [offsets[i] for i in order], dtype=np.int64
            ),
            "lengths": np.asarray(
                [lengths[i] for i in order], dtype=np.int64
            ),
        }
        tmp = f"{idx_path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "wb") as f:
                np.savez(f, **data)
            os.replace(tmp, idx_path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass  # read-only cohort dir: index lives in memory only
        return cls(data)

    def slice(self, shard) -> tuple:
        """(offsets, lengths) of lines with start in [shard.start,
        shard.end) on the shard's contig, sorted by start."""
        seg = self._by.get(_strip_chr(shard.contig))
        if seg is None:
            empty = np.empty(0, dtype=np.int64)
            return empty, empty
        lo, hi = seg
        window = self._starts[lo:hi]
        a = lo + bisect.bisect_left(window, shard.start)
        b = lo + bisect.bisect_left(window, shard.end)
        return self._offsets[a:b], self._lengths[a:b]

    @staticmethod
    def read_lines(f, offsets, lengths):
        """Yield raw line bytes for (offsets, lengths), coalescing
        file-adjacent rows into single sequential reads — for a cohort
        written in genomic order a whole shard is one seek + one read."""
        i, n = 0, len(offsets)
        while i < n:
            j = i
            # +1 for the newline between stored (stripped) line lengths.
            while (
                j + 1 < n
                and offsets[j + 1] == offsets[j] + lengths[j] + 1
            ):
                j += 1
            f.seek(int(offsets[i]))
            buf = f.read(int(offsets[j] + lengths[j] - offsets[i]))
            pos = 0
            for k in range(i, j + 1):
                yield buf[pos : pos + int(lengths[k])]
                pos += int(lengths[k]) + 1
            i = j + 1


def _scan_json_string(line: bytes, key: bytes):
    """Value of a top-level ``"key": "value"`` pair by byte scan; None on
    any shape surprise (missing, non-string, escapes) → json fallback."""
    i = line.find(key)
    if i < 0:
        return None
    i = line.find(b":", i + len(key))
    if i < 0:
        return None
    i += 1
    n = len(line)
    while i < n and line[i] in b" \t":
        i += 1
    if i >= n or line[i : i + 1] != b'"':
        return None
    j = line.find(b'"', i + 1)
    if j < 0 or b"\\" in line[i + 1 : j]:
        return None
    return line[i + 1 : j].decode("utf-8", "strict")


def csr_pair_from_lists(lists) -> Optional[tuple]:
    """Per-variant index lists → ONE ``(indices, offsets)`` CSR pair.

    The shard-assembly step shared by every wire-fed CSR tier (HTTP and
    gRPC transports): flat accumulation with a single array build per
    shard — a numpy array + concatenate node per variant would
    reintroduce the per-variant allocation overhead the CSR tier exists
    to eliminate. None for an empty shard window, matching the local
    sidecar tier's contract.
    """
    flat: list = []
    lens: list = []
    for lst in lists:
        flat.extend(lst)
        lens.append(len(lst))
    if not lens:
        return None
    offsets = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(np.asarray(lens, dtype=np.int64), out=offsets[1:])
    return np.asarray(flat, dtype=np.int64), offsets


def _line_vsid_matches(line: bytes, variant_set_id: str) -> bool:
    """The one variant-set rule (see _carrying_records) applied to a raw
    interchange line: falsy stored id is a wildcard, non-empty must
    equal. Byte scan with a json.loads fallback on shape surprises.

    TOP-LEVEL GUARD (the same rule _extract_fields applies): a key
    match past the record's first nested container could be a
    "variant_set_id" key INSIDE calls/info — trusting it would make
    this zero-parse path filter records differently from the parsed
    path's top-level ``rec.get("variant_set_id")``. Any match beyond
    that point falls back to the real parse instead.
    """
    if not variant_set_id:
        return True
    i = line.find(b'"variant_set_id"')
    if i < 0:
        return True  # absent → wildcard
    nested = len(line)
    for tok in (b"[", b"{"):
        p = line.find(tok, 1)  # skip the record's own opening brace
        if p >= 0:
            nested = min(nested, p)
    if i > nested:
        stored = json.loads(line).get("variant_set_id")
    else:
        stored = _scan_json_string(line, b'"variant_set_id"')
        if stored is None:
            stored = json.loads(line).get("variant_set_id")
    return not stored or stored == variant_set_id


def _load_sidecar_mmap(path: str):
    """The sidecar npz as zero-copy views over ONE sequential-readahead
    mmap of the file, or None when the layout forbids it (compressed
    members, object dtypes, or any parse anomaly — the caller then
    falls back to ``np.load``, which copies).

    ``np.savez`` stores members uncompressed (ZIP_STORED), so each
    ``.npy`` payload is a contiguous byte range of the file: parse the
    zip local headers, mmap the whole file once, hint the kernel that
    access is SEQUENTIAL (the sidecar is consumed front to back by the
    shard manifest), and serve every array as an ``np.frombuffer`` view.
    This is the cold-path re-read tier: after a partial cold run, the
    next run's sidecar pages stream in at disk readahead speed instead
    of being decompressed-copied into anonymous memory — and the page
    cache is shared across concurrent serving processes. There is no
    switch to turn the view off: only a layout anomaly of the file sends
    the caller to the copying loader.
    """
    try:
        with zipfile.ZipFile(path) as zf:
            infos = zf.infolist()
        if not infos or any(
            i.compress_type != zipfile.ZIP_STORED for i in infos
        ):
            return None
        with open(path, "rb") as f:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        if hasattr(mm, "madvise"):
            mm.madvise(mmap.MADV_SEQUENTIAL)
        view = memoryview(mm)
        data = {}
        for info in infos:
            ho = info.header_offset
            if mm[ho : ho + 4] != b"PK\x03\x04":
                return None
            nlen, elen = struct.unpack("<HH", mm[ho + 26 : ho + 30])
            off = ho + 30 + nlen + elen
            # The CRC check np.load would have done through ZipExtFile:
            # a corrupted-but-committed member must trigger the rebuild/
            # re-mirror fallback, never serve garbage ordinals. One
            # zero-copy sequential pass — exactly what the readahead
            # hint is for; still strictly cheaper than the copy loader.
            if (
                zlib.crc32(view[off : off + info.file_size]) & 0xFFFFFFFF
            ) != info.CRC:
                return None
            # The npy header is tiny; hand the parser a bounded window.
            fp = io.BytesIO(mm[off : off + min(info.file_size, 1 << 16)])
            version = npformat.read_magic(fp)
            shape, fortran, dtype = npformat._read_array_header(
                fp, version
            )
            if dtype.hasobject:
                return None
            count = 1
            for dim in shape:
                count *= int(dim)
            arr = np.frombuffer(
                mm, dtype=dtype, count=count, offset=off + fp.tell()
            ).reshape(shape, order="F" if fortran else "C")
            name = info.filename
            if name.endswith(".npy"):
                name = name[:-4]
            data[name] = arr
        return data
    except Exception:  # noqa: BLE001 — any layout anomaly: copy path
        return None


class _CsrCohort:
    """Columnar CSR sidecar for a JSONL cohort — parse once, mmap forever.

    Repeat runs over an on-disk cohort re-parsed the whole JSONL every
    time (json.loads per record dominates at chr20+ scale). The sidecar
    persists the carrying representation in numpy arrays keyed by the
    source files' (size, mtime) so any edit invalidates it:

    - per contig-kept variant (normalize_contig ≠ None): contig code,
      start, variant-set code, AF (NaN = absent) — everything the fused
      fast path filters on;
    - CSR call arrays whose values are CALLSET ORDINALS in callsets.json
      file order, remapped to the run's dense sample indexes at query
      time (the dense index is config-dependent; the file order is not).

    Serves the fused tiers (``stream_carrying``, ``stream_carrying_csr``,
    ``stream_carrying_keyed``) — full-record streaming still parses
    (those consumers need fields the sidecar doesn't keep). The file is
    the JAX package's, member for member: either package maps the
    other's sidecar without a rebuild.
    """

    VERSION = 2

    def __init__(self, data: dict):
        self._d = data
        # contig → (lo, hi) row range; starts sorted within each range.
        self.segments = {
            c: (int(lo), int(hi))
            for c, lo, hi in zip(
                data["contigs"].tolist(),
                data["seg_lo"].tolist(),
                data["seg_hi"].tolist(),
            )
        }
        # Per-query caches: the ordinal→dense-index lookup and the
        # variant-set masks are identical across a manifest's thousands
        # of shard queries. Thread-shape matters — shard-parallel ingest
        # queries this object from worker threads, and the multi-dataset
        # keyed path interleaves DIFFERENT variant_set_ids concurrently —
        # so the vsid masks live in a dict keyed by vsid (atomic get/set
        # under the GIL, values immutable once stored; a racing double
        # compute yields identical arrays). The lookup cache keeps the
        # single-slot identity check: every dataset of a run shares one
        # indexes dict, and the slot is written value-before-key.
        self._lookup_indexes = None
        self._lookup = None
        self._allowed_by_vsid: dict = {}

    @staticmethod
    def _digest(paths) -> str:
        parts = [f"v{_CsrCohort.VERSION}"]
        for p in paths:
            st = os.stat(p)
            parts.append(f"{os.path.basename(p)}:{st.st_size}:{st.st_mtime_ns}")
        return "|".join(parts)

    @staticmethod
    def _mirror_sidecar_trusted(root: str) -> bool:
        """Should a digest-mismatched sidecar be trusted anyway?

        A sidecar DOWNLOADED into a remote-cohort mirror can never match
        the local stat digest (the mirror's files have fresh mtimes, and
        a server storing .gz originals keyed different sizes). It is
        trusted exactly when the mirror protocol vouches for it: the dir
        is a completed mirror, and the ``.sidecar-ok`` marker the client
        wrote alongside the download matches the mirror's own identity.
        Mirrors are immutable by construction (populated in a staging
        dir, renamed complete), so the stat-based invalidation the digest
        provides for editable cohorts has nothing to catch here.
        """
        try:
            complete = os.path.exists(
                os.path.join(root, MIRROR_COMPLETE_MARKER)
            )
            with open(os.path.join(root, MIRROR_IDENTITY_FILE)) as f:
                ident = f.read().strip()
            with open(os.path.join(root, MIRROR_SIDECAR_OK)) as f:
                ok = f.read().strip()
        except OSError:
            return False
        return complete and bool(ident) and ident == ok

    @classmethod
    def load_or_build(
        cls, root: str, open_fn, native: bool = True
    ) -> "_CsrCohort":
        """The sidecar of ``root``: mapped when its digest matches the
        interchange files (or, in a completed cohort mirror, when the
        mirror protocol vouches for it), else rebuilt by one parse and
        written next to them (tmp file, then an atomic ``os.replace``; a
        read-only cohort directory serves the rebuilt arrays from
        memory).

        The parse is the native core's (:meth:`_parse_native`, on its
        auto thread count) unless the input is gzipped or the native
        parser refuses it, and the Python parse
        (:meth:`_parse_python`) then; ``native=False`` takes the Python
        parse and the Python identity hash throughout. Either way the
        sidecar is the same, member for member."""
        sidecar = os.path.join(root, SIDECAR_BASENAME)
        src_paths = []
        for name in ("variants.jsonl", "callsets.json"):
            p = os.path.join(root, name)
            src_paths.append(p + ".gz" if os.path.exists(p + ".gz") else p)
        try:
            digest = cls._digest(src_paths)
        except FileNotFoundError:
            # LIGHT mirror: the interchange files are absent BY DESIGN
            # (the client downloaded only callsets + this sidecar).
            # Acceptance then rests entirely on the mirror trust
            # protocol below; there is nothing to rebuild from.
            digest = None
        if os.path.exists(sidecar):
            try:
                # mmap-with-readahead view first (zero-copy re-reads);
                # np.load copy fallback on a layout anomaly.
                data = _load_sidecar_mmap(sidecar)
                if data is None:
                    data = dict(np.load(sidecar, allow_pickle=False))
                stored = str(data["digest"])
                if (digest is not None and stored == digest) or (
                    # Same FORMAT version required either way — a
                    # trusted mirror sidecar from a server running an
                    # incompatible layout must still rebuild.
                    stored.startswith(f"v{cls.VERSION}|")
                    and cls._mirror_sidecar_trusted(root)
                ):
                    return cls(data)
            except (
                OSError,
                ValueError,
                KeyError,
                EOFError,
                zipfile.BadZipFile,
            ):
                pass  # unreadable/corrupt/stale → rebuild
        if digest is None:
            raise FileNotFoundError(
                f"{root}: no variants.jsonl and no trusted mirror "
                "sidecar — a light mirror must carry its "
                f"{MIRROR_SIDECAR_OK} marker (re-mirror the cohort)"
            )

        # One full parse (native C++ when possible, Python otherwise) to
        # FILE-ORDERED columnar arrays, then one vectorized assembly into
        # the per-contig sorted layout.
        with open_fn("callsets.json") as f:
            callset_ids = [r["id"] for r in json.load(f)]
        parsed = cls._parse_native(root, callset_ids) if native else None
        if parsed is None:
            parsed = cls._parse_python(open_fn, callset_ids)
        data = cls._assemble(digest, callset_ids, *parsed, native=native)
        tmp = f"{sidecar}.{os.getpid()}.tmp"
        try:
            with open(tmp, "wb") as f:
                np.savez(f, **data)
            os.replace(tmp, sidecar)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass  # read-only cohort dir: serve from memory, no cache
        return cls(data)

    @staticmethod
    def _parse_native(root: str, callset_ids, threads: int = 0):
        """The native core's parse of an uncompressed variants.jsonl on
        ``threads`` threads (0 = the core's auto rule), or None for the
        Python parse to decide: a ``.gz`` input (the native parser does
        not decompress) or any parse anomaly (the native parser handles
        the interchange schema and refuses everything else, so it is fast
        without ever being wrong). The arrays are
        :meth:`_parse_python`'s, and the same for any thread count."""
        path = os.path.join(root, "variants.jsonl")
        # _open()'s preference: when a .gz exists it is the authoritative
        # file.
        if os.path.exists(path + ".gz") or not os.path.exists(path):
            return None
        lib = native_core.load()
        encoded = [cid.encode() for cid in callset_ids]
        offs = np.zeros(len(encoded) + 1, dtype=np.int64)
        if encoded:
            np.cumsum([len(e) for e in encoded], out=offs[1:])
        res = lib.parse_cohort_jsonl(
            path.encode(), b"".join(encoded), offs.ctypes.data,
            len(encoded), int(threads),
        )
        try:
            c = res.contents
            if c.error != 0:
                return None
            nv, nc = c.n_variants, c.n_calls

            def arr(ptr, n, dtype):
                # Copied out: the struct's memory is freed below.
                if n == 0:
                    return np.zeros(0, dtype=dtype)
                return np.ctypeslib.as_array(ptr, shape=(int(n),)).astype(
                    dtype, copy=True
                )

            def table(blob_ptr, offs_ptr, n):
                if n == 0:
                    return []
                offs = arr(offs_ptr, int(n) + 1, np.int64)
                raw = ctypes.string_at(blob_ptr, int(offs[-1]))
                return [
                    raw[offs[i] : offs[i + 1]].decode()
                    for i in range(int(n))
                ]

            return (
                table(c.contig_blob, c.contig_offs, c.n_contigs),
                arr(c.contig_code, nv, np.int32),
                arr(c.starts, nv, np.int64),
                table(c.vsid_blob, c.vsid_offs, c.n_vsids),
                arr(c.vsid_code, nv, np.int32),
                arr(c.afs, nv, np.float64),
                arr(c.offsets, nv + 1, np.int64),
                arr(c.ords, nc, np.int32),
                [],
                arr(c.ends, nv, np.int64),
                table(c.ref_blob, c.ref_offs, nv),
                table(c.alt_blob, c.alt_offs, nv),
            )
        finally:
            lib.cohort_csr_free(res)

    @staticmethod
    def _parse_python(open_fn, callset_ids):
        """The parse: json.loads per line -> file-ordered columnar
        arrays (the JAX package's pure-Python parse; the native parser,
        :meth:`_parse_native`, produces the same arrays)."""
        ord_of = {cid: i for i, cid in enumerate(callset_ids)}
        # Callset ids absent from callsets.json get ordinals past the
        # known table: the STAGED path only raises KeyError when a
        # QUERIED record references an unknown id, so the build must not
        # crash on out-of-scope records — carrying() resolves lazily and
        # raises with the true id only when such a record is actually
        # served.
        extra_ids: List[str] = []
        extra_of: dict = {}
        contig_table: List[str] = []
        contig_of: dict = {}
        vsid_table: List[str] = []
        vsid_of: dict = {}
        rec_contig, starts, rec_vsid, afs = [], [], [], []
        ends, refs, alts = [], [], []
        offs, ords = [0], []
        with open_fn("variants.jsonl") as f:
            for line in f:
                rec = json.loads(line)
                contig = normalize_contig(rec["reference_name"])
                if contig is None:
                    continue
                # Missing/non-numeric AF (af_value's None) stores as NaN:
                # with the filter OFF AF is untouched, with it ON the
                # record drops, identically to the staged/fused tiers.
                af = af_value((rec.get("info") or {}).get("AF"))
                af_val = np.nan if af is None else af
                for c in rec.get("calls", ()):
                    if any(g > 0 for g in c.get("genotype", ())):
                        cid = c["callset_id"]
                        code = ord_of.get(cid)
                        if code is None:
                            code = extra_of.get(cid)
                            if code is None:
                                code = len(callset_ids) + len(extra_of)
                                extra_of[cid] = code
                                extra_ids.append(cid)
                        ords.append(code)
                offs.append(len(ords))
                if contig not in contig_of:
                    contig_of[contig] = len(contig_table)
                    contig_table.append(contig)
                rec_contig.append(contig_of[contig])
                # Falsy stored ids (missing/null/"") are wildcards under
                # the one variant-set rule — store them uniformly as "".
                vsid = rec.get("variant_set_id") or ""
                if vsid not in vsid_of:
                    vsid_of[vsid] = len(vsid_table)
                    vsid_table.append(vsid)
                rec_vsid.append(vsid_of[vsid])
                starts.append(int(rec["start"]))
                # Identity fields (KeyError on missing end matches the
                # staged builder, which requires it). Non-string
                # ref/alt values make the IDENTITY invalid, not the
                # record: single-dataset ingest never reads them, and
                # the keyed path raises lazily only when such a record
                # is actually served — the same timing as the record
                # path's TypeError inside the payload builder.
                ends.append(int(rec["end"]))
                try:
                    ref = rec.get("reference_bases") or ""
                    if not isinstance(ref, str):
                        raise TypeError(ref)
                    alt = "".join(rec.get("alternate_bases") or ())
                except TypeError:
                    ref = alt = None
                refs.append(ref)
                alts.append(alt)
                afs.append(af_val)
        return (
            contig_table,
            np.array(rec_contig, np.int32),
            np.array(starts, np.int64),
            vsid_table,
            np.array(rec_vsid, np.int32),
            np.array(afs, np.float64),
            np.array(offs, np.int64),
            np.array(ords, np.int32),
            extra_ids,
            np.array(ends, np.int64),
            refs,
            alts,
        )

    @staticmethod
    def _assemble(
        digest,
        callset_ids,
        contig_table,
        rec_contig,
        starts,
        vsid_table,
        rec_vsid,
        afs,
        offsets,
        ords,
        extra_ids=(),
        ends=None,
        refs=None,
        alts=None,
        native=True,
    ):
        """File-ordered arrays -> per-contig sorted sidecar layout.

        ``extra_ids`` are callset ids seen in records but absent from
        callsets.json; their ordinals continue past the known table so
        queries can report the true id when raising."""

        def str_arr(values):
            # Inferred itemsize: a fixed "U<n>" would silently truncate
            # longer (e.g. URI-style) ids.
            return np.array(
                list(values), dtype=str if len(values) else "U1"
            )

        nv = len(starts)
        # Stable sort by (contig name, start) -- contigs ranked by their
        # sorted names; ties keep file order (lexsort is stable).
        rank = np.zeros(max(len(contig_table), 1), dtype=np.int64)
        order_c = sorted(
            range(len(contig_table)), key=lambda i: contig_table[i]
        )
        rank[order_c] = np.arange(len(order_c))
        rec_rank = (
            rank[rec_contig] if nv else np.zeros(0, np.int64)
        )
        order = np.lexsort((starts, rec_rank))
        starts_s = np.asarray(starts)[order]
        afs_s = np.asarray(afs)[order]
        # Variant-set codes re-numbered by first encounter in sorted
        # order (the sorted-walk interning of the original builder).
        vv = np.asarray(rec_vsid)[order]
        if nv:
            uniq, first = np.unique(vv, return_index=True)
            old_codes = uniq[np.argsort(first, kind="stable")]
            lookup = np.zeros(max(len(vsid_table), 1), dtype=np.int32)
            lookup[old_codes] = np.arange(
                len(old_codes), dtype=np.int32
            )
            vcode = lookup[vv]
            vsid_new = [vsid_table[int(c)] for c in old_codes]
        else:
            vcode = np.zeros(0, dtype=np.int32)
            vsid_new = []
        # CSR gather in the new order.
        lens = (offsets[1:] - offsets[:-1])[order]
        new_offs = np.zeros(nv + 1, dtype=np.int64)
        np.cumsum(lens, out=new_offs[1:])
        if len(ords):
            src_start = offsets[:-1][order]
            idx = (
                np.repeat(src_start, lens)
                + np.arange(int(lens.sum()))
                - np.repeat(new_offs[:-1], lens)
            )
            ords_s = ords[idx].astype(np.int32)
        else:
            ords_s = np.asarray(ords, dtype=np.int32)
        # Contig segments over the sorted rows: position in the sorted
        # name list IS the rank, by construction.
        seg_contigs = sorted(contig_table)
        rr_sorted = rec_rank[order]
        seg_lo, seg_hi = [], []
        for r, _cname in enumerate(seg_contigs):
            seg_lo.append(int(np.searchsorted(rr_sorted, r, "left")))
            seg_hi.append(int(np.searchsorted(rr_sorted, r, "right")))
        # Identity-hash column (cross-dataset join from the sidecar):
        # murmur3 over the exact payload bytes the staged path hashes
        # (VariantsPca.scala:62-78), stored as hex so numpy round-trips it.
        ends_s = np.asarray(ends)[order].astype(np.int64)
        contig_names = [seg_contigs[int(r)] for r in rr_sorted.tolist()]
        keys = []
        payloads = []
        slots = []
        for i, j in enumerate(order.tolist()):
            if refs[int(j)] is None:
                # Invalid identity fields: "" sentinel — carrying_keyed
                # raises lazily if such a record is ever served.
                keys.append("")
                continue
            keys.append(None)
            slots.append(i)
            payloads.append(
                _identity_payload(
                    contig_names[i],
                    int(starts_s[i]),
                    int(ends_s[i]),
                    refs[int(j)],
                    [alts[int(j)]] if alts[int(j)] else None,
                )
            )
        for slot, h in zip(slots, hash_payloads(payloads, native)):
            keys[slot] = h
        return {
            "digest": np.str_(digest),
            "contigs": str_arr(seg_contigs),
            "seg_lo": np.array(seg_lo, dtype=np.int64),
            "seg_hi": np.array(seg_hi, dtype=np.int64),
            "starts": starts_s.astype(np.int64),
            "vcode": vcode,
            "afs": afs_s.astype(np.float64),
            "offsets": new_offs,
            "ords": ords_s,
            "vsids": str_arr(vsid_new),
            "callset_ids": str_arr(list(callset_ids) + list(extra_ids)),
            "idkeys": np.array(keys, dtype="S32"),
        }

    def has_identity_keys(self) -> bool:
        return "idkeys" in self._d

    def carrying_keyed(self, shard, indexes, variant_set_id, stats, min_af):
        """(contig, identity KEY, carrying indices) triples — the keyed
        fast path served from the sidecar's precomputed hash column.
        Keys are hex strings; datasets._hashed passes them through
        unhashed. Empty call lists are KEPT (join semantics)."""
        for row_abs, calls in self._rows(
            shard, indexes, variant_set_id, stats, min_af, keep_empty=True
        ):
            key = self._d["idkeys"][row_abs].decode()
            if not key:
                raise TypeError(
                    f"record at {shard.contig}:"
                    f"{int(self._d['starts'][row_abs])} has non-string "
                    "identity fields (reference/alternate bases); it "
                    "cannot participate in a cross-dataset join"
                )
            yield (_strip_chr(shard.contig), key, calls)

    def carrying(self, shard, indexes, variant_set_id, stats, min_af):
        """Per-variant carrying index lists for the shard — semantics of
        :func:`_carrying_records` over the columnar arrays."""
        for _row, calls in self._rows(
            shard, indexes, variant_set_id, stats, min_af, keep_empty=False
        ):
            yield calls

    def _shard_keep(self, shard, indexes, variant_set_id, stats, min_af):
        """Shared vectorized shard prefix: (a, b, keep mask, lookup) —
        the row window, the vsid+AF keep mask (stats counted exactly as
        the row path always has: after the vsid filter, before AF), and
        the callset-ordinal → dense-index lookup table."""
        d = self._d
        seg = self.segments.get(_strip_chr(shard.contig))
        if seg is None:
            return None
        lo, hi = seg
        starts = d["starts"]
        a = lo + int(np.searchsorted(starts[lo:hi], shard.start, "left"))
        b = lo + int(np.searchsorted(starts[lo:hi], shard.end, "left"))
        if a == b:
            return None
        keep = np.ones(b - a, dtype=bool)
        if variant_set_id:
            allowed = self._allowed_by_vsid.get(variant_set_id)
            if allowed is None:
                allowed = np.array(
                    [
                        (not v) or v == variant_set_id
                        for v in d["vsids"].tolist()
                    ]
                )
                self._allowed_by_vsid[variant_set_id] = allowed
            keep &= allowed[d["vcode"][a:b]]
        stats.add(variants_read=int(keep.sum()))
        if min_af is not None:
            afs = d["afs"][a:b]
            with np.errstate(invalid="ignore"):
                keep &= afs >= min_af  # NaN compares False → dropped
        # Callset-ordinal → dense-index lookup; unknown ids must raise
        # KeyError exactly like the dict path (mapping(callsetId) throws).
        if self._lookup_indexes is not indexes:
            lookup = np.full(len(d["callset_ids"]), -1, dtype=np.int64)
            for i, cid in enumerate(d["callset_ids"].tolist()):
                if cid in indexes:
                    lookup[i] = indexes[cid]
            self._lookup, self._lookup_indexes = lookup, indexes
        return a, b, keep, self._lookup

    def carrying_csr(self, shard, indexes, variant_set_id, stats, min_af):
        """The shard's carrying lists as one CSR pair (indices, offsets)
        — numpy end to end, no per-variant Python lists.

        Row semantics are exactly :meth:`carrying` (keep_empty=False:
        variants with no carriers are dropped), without the
        array→list→array round-trip.

        Returns ``(indices, offsets)`` with ``offsets`` of length
        rows+1, or None for an empty window.
        """
        pre = self._shard_keep(shard, indexes, variant_set_id, stats, min_af)
        if pre is None:
            return None
        a, b, keep, lookup = pre
        d = self._d
        offsets = d["offsets"]
        rows = a + np.nonzero(keep)[0]
        lo = offsets[rows]
        lens = offsets[rows + 1] - lo
        nonempty = lens > 0
        lo, lens = lo[nonempty], lens[nonempty]
        if lo.size == 0:
            return None
        out_offs = np.zeros(lo.size + 1, dtype=np.int64)
        np.cumsum(lens, out=out_offs[1:])
        # Ragged gather of [lo_i, lo_i+len_i) ranges in one shot.
        pos = np.repeat(lo, lens) + (
            np.arange(out_offs[-1], dtype=np.int64)
            - np.repeat(out_offs[:-1], lens)
        )
        mapped = lookup[d["ords"][pos]]
        if (mapped < 0).any():
            bad = int(d["ords"][pos][mapped < 0][0])
            raise KeyError(str(d["callset_ids"][bad]))
        return mapped, out_offs

    def _rows(self, shard, indexes, variant_set_id, stats, min_af,
              keep_empty):
        """Shared shard query: yields (absolute row index, calls list)."""
        pre = self._shard_keep(shard, indexes, variant_set_id, stats, min_af)
        if pre is None:
            return
        a, b, keep, lookup = pre
        d = self._d
        offsets = d["offsets"]
        ords = d["ords"]
        for row in np.nonzero(keep)[0].tolist():
            o_lo, o_hi = offsets[a + row], offsets[a + row + 1]
            if o_lo == o_hi:
                if keep_empty:
                    yield a + row, []
                continue
            mapped = lookup[ords[o_lo:o_hi]]
            if (mapped < 0).any():
                bad = int(ords[o_lo:o_hi][mapped < 0][0])
                raise KeyError(str(d["callset_ids"][bad]))
            yield a + row, mapped.tolist()


class JsonlSource:
    """Newline-JSON cohort on disk: ``<dir>/callsets.json`` +
    ``<dir>/variants.jsonl[.gz]`` (+ optional ``reads.jsonl[.gz]``).

    The offline-ingest path (``pca --input-path <dir>``): a portable
    interchange format for cohorts, the JAX package's. The fused ingest
    tiers read the persistent CSR sidecar (:class:`_CsrCohort`, built on
    first use next to the files); the staged record path reads shard
    windows through the byte-offset line index (:class:`_LineIndex`), or a
    whole-file parsed index for a gzipped cohort.
    """

    def __init__(self, root: str, stats: Optional[IoStats] = None):
        self.root = root
        self.stats = stats if stats is not None else IoStats()
        self._csr: Optional[_CsrCohort] = None
        # Ordinal identity map for the binary wire tier: ONE dict object
        # reused across shard requests so _CsrCohort's single-slot
        # lookup cache (identity-keyed) hits on every frame query.
        self._ordinal_indexes: Optional[dict] = None
        # Shard-parallel ingest streams from worker threads; every
        # lazily-built shared structure (sidecar, record indexes) must be
        # built exactly once, not once per racing worker.
        self._lazy_lock = threading.Lock()
        # Parsed-record index (gzipped cohorts): parsed once into
        # per-contig lists sorted by start; each shard reads its
        # [start, end) slice by binary search.
        self._variant_index: Optional[_SortedIndex] = None
        self._read_index: Optional[_SortedIndex] = None
        # Byte-offset line index (uncompressed variants.jsonl only):
        # None = unresolved, False = unavailable (.gz / missing file).
        self._lineidx = None

    def _open(self, name: str):
        path = os.path.join(self.root, name)
        if os.path.exists(path + ".gz"):
            return gzip.open(path + ".gz", "rt")
        if name == "variants.jsonl" and not os.path.exists(path):
            if os.path.exists(
                os.path.join(self.root, MIRROR_SIDECAR_OK)
            ):
                # A LIGHT mirror holds callsets + sidecar only; raw
                # FileNotFoundError pointing into cache internals is not
                # an actionable message for the consumer that needs
                # records.
                raise FileNotFoundError(
                    f"{path}: this is a LIGHT cohort mirror (callsets + "
                    "CSR sidecar; serves the fused pca ingest tiers "
                    "only). Record-streaming consumers need "
                    "--mirror-mode full, which upgrades the mirror in "
                    "place on the next run"
                )
        return open(path, "rt")

    def _line_index(self) -> Optional[_LineIndex]:
        """The byte-offset shard index, or None when the cohort is
        gz-compressed (no byte addressing into a gzip stream) or the
        file is absent."""
        if self._lineidx is None:
            with self._lazy_lock:
                if self._lineidx is None:
                    path = os.path.join(self.root, "variants.jsonl")
                    if os.path.exists(path + ".gz") or not os.path.exists(
                        path
                    ):
                        self._lineidx = False
                    else:
                        self._lineidx = _LineIndex.load_or_build(self.root)
        return self._lineidx or None

    def ensure_serving_index(self) -> int:
        """Build (or load) every shard-serving index up front; → variant
        records indexed. ``serve-cohort`` calls this before accepting
        requests so the first shard of a large cohort does not pay an
        index build behind a client's socket timeout. Reads get the same
        treatment when the cohort ships them. The CSR sidecar backs the
        binary frame tier and the sidecar export; it is persisted, so
        only the first serve of a cohort pays it."""
        if os.path.exists(
            os.path.join(self.root, "reads.jsonl")
        ) or os.path.exists(os.path.join(self.root, "reads.jsonl.gz")):
            self._reads_index()
        self._ensure_csr()
        idx = self._line_index()
        if idx is not None:
            return idx.total
        return self._variants_index().total

    def _shard_records(self, shard: Shard) -> Iterator[dict]:
        """Parsed records for one shard window — windowed reads via the
        line index when available (memory bounded by the shard, not the
        cohort), whole-file parsed index otherwise (.gz cohorts)."""
        idx = self._line_index()
        if idx is None:
            yield from self._variants_index().slice(shard)
            return
        offsets, lengths = idx.slice(shard)
        with open(os.path.join(self.root, "variants.jsonl"), "rb") as f:
            for line in _LineIndex.read_lines(f, offsets, lengths):
                yield json.loads(line)

    def stream_variant_lines(
        self, variant_set_id: str, shard: Shard
    ) -> Iterator[bytes]:
        """Raw interchange lines for one shard — the zero-parse serving
        path (/variants passthrough) over the byte-offset line index.
        Same STRICT slicing and variant-set wildcard rule as
        :meth:`stream_variants`; contig-normalization drops are left to the
        client's builder (manifest shards only address numeric contigs)."""
        self.stats.add(
            partitions=1, requests=1, reference_bases=shard.range
        )
        idx = self._line_index()
        if idx is None:
            # gzipped cohorts: serialize from the parsed index.
            for rec in self._variants_index().slice(shard):
                stored = rec.get("variant_set_id")
                if variant_set_id and stored and stored != variant_set_id:
                    continue
                self.stats.add(variants_read=1)
                yield json.dumps(rec).encode()
            return
        offsets, lengths = idx.slice(shard)
        with open(os.path.join(self.root, "variants.jsonl"), "rb") as f:
            for line in _LineIndex.read_lines(f, offsets, lengths):
                if not _line_vsid_matches(line, variant_set_id):
                    continue
                self.stats.add(variants_read=1)
                yield line

    def cohort_identity(self) -> Optional[str]:
        """Cheap cohort digest for remote caching: (name, size, mtime_ns)
        of every interchange file — the same invalidation convention the
        CSR sidecar uses, and the JAX package's digest."""
        import hashlib

        h = hashlib.sha256()
        found = False
        for name in ("callsets.json", "variants.jsonl", "reads.jsonl"):
            for path in (
                os.path.join(self.root, name),
                os.path.join(self.root, name + ".gz"),
            ):
                if os.path.exists(path):
                    st = os.stat(path)
                    h.update(
                        f"{os.path.basename(path)}|{st.st_size}"
                        f"|{st.st_mtime_ns}\n".encode()
                    )
                    found = True
        return h.hexdigest()[:16] if found else None

    def export_lines(self, name: str) -> Iterator[bytes]:
        """Raw interchange-file lines (no parse — the export endpoint is
        a passthrough for file-backed cohorts)."""
        if name not in ("callsets.json", "variants.jsonl", "reads.jsonl"):
            raise KeyError(name)
        path = os.path.join(self.root, name)
        if not (os.path.exists(path) or os.path.exists(path + ".gz")):
            if name == "reads.jsonl":
                return  # reads are optional in the interchange layout
            raise FileNotFoundError(path)
        with self._open(name) as f:
            for line in f:
                line = line.rstrip("\n")
                if line:
                    yield line.encode()

    def ensure_sidecar(self) -> Optional[str]:
        """Build the CSR sidecar if needed; → its on-disk path, or None
        when it could not be persisted (read-only cohort directory). The
        serving side of ``/export-sidecar``: the file either package
        maps."""
        self._ensure_csr()
        path = os.path.join(self.root, SIDECAR_BASENAME)
        return path if os.path.exists(path) else None

    def _ensure_csr(self) -> _CsrCohort:
        if self._csr is None:
            with self._lazy_lock:
                if self._csr is None:
                    self._csr = _CsrCohort.load_or_build(
                        self.root, self._open
                    )
        return self._csr

    def _variants_index(self) -> _SortedIndex:
        if self._variant_index is None:
            with self._lazy_lock:
                if self._variant_index is None:
                    with self._open("variants.jsonl") as f:
                        self._variant_index = _SortedIndex.build(
                            (json.loads(line) for line in f),
                            lambda r: (r["reference_name"], r["start"]),
                        )
        return self._variant_index

    def _reads_index(self) -> _SortedIndex:
        if self._read_index is None:
            with self._lazy_lock:
                if self._read_index is None:
                    with self._open("reads.jsonl") as f:
                        self._read_index = _SortedIndex.build(
                            (json.loads(line) for line in f),
                            lambda r: (r["reference_name"], r["position"]),
                        )
        return self._read_index

    def list_callsets(self, variant_set_id: str) -> List[Callset]:
        self.stats.add(requests=1)
        with self._open("callsets.json") as f:
            rows = json.load(f)
        return [
            Callset(r["id"], r["name"], r.get("variant_set_id", ""))
            for r in rows
            if not variant_set_id
            or r.get("variant_set_id", variant_set_id) == variant_set_id
        ]

    def stream_variants(
        self, variant_set_id: str, shard: Shard
    ) -> Iterator[Variant]:
        self.stats.add(partitions=1, requests=1, reference_bases=shard.range)
        for rec in self._shard_records(shard):
            stored = rec.get("variant_set_id")
            # The one variant-set rule (see _carrying_records): falsy
            # stored id is a wildcard, non-empty must equal.
            if variant_set_id and stored and stored != variant_set_id:
                continue
            v = variant_from_record(rec)
            if v is None:
                continue
            self.stats.add(variants_read=1)
            yield v

    def stream_carrying(
        self,
        variant_set_id: str,
        shard: Shard,
        indexes: dict,
        min_allele_frequency: Optional[float] = None,
    ) -> Iterator[List[int]]:
        """Fused fast path over the persistent columnar sidecar (built on
        first use, reused across shards, runs, and processes — see
        :class:`_CsrCohort`)."""
        self.stats.add(partitions=1, requests=1, reference_bases=shard.range)
        # Ranged to exhaustion: the per-shard extraction latency.
        with rpc_range("jsonl", "stream_carrying"):
            yield from self._ensure_csr().carrying(
                shard,
                indexes,
                variant_set_id,
                self.stats,
                min_allele_frequency,
            )

    def stream_carrying_csr(
        self,
        variant_set_id: str,
        shard: Shard,
        indexes: dict,
        min_allele_frequency: Optional[float] = None,
    ):
        """CSR-direct fused ingest: the shard's carrying lists as ONE
        ``(indices, offsets)`` numpy pair straight off the sidecar — no
        per-variant Python lists. Identical row/stats/AF/KeyError
        semantics to :meth:`stream_carrying`; returns None for an empty
        shard window."""
        self.stats.add(partitions=1, requests=1, reference_bases=shard.range)
        with rpc_range("jsonl", "stream_carrying_csr"):
            return self._ensure_csr().carrying_csr(
                shard,
                indexes,
                variant_set_id,
                self.stats,
                min_allele_frequency,
            )

    def callset_order(self) -> List[str]:
        """Callset ids in ORDINAL order — the id space binary wire
        frames index into: callsets.json file order plus any sidecar
        extras (ids seen in records but absent from callsets.json),
        exactly the sidecar's own ordinal table."""
        return [
            str(c)
            for c in self._ensure_csr()._d["callset_ids"].tolist()
        ]

    def stream_carrying_frame(
        self,
        variant_set_id: str,
        shard: Shard,
        min_allele_frequency: Optional[float] = None,
    ):
        """One shard's carrying CSR pair in callset ORDINALS plus the
        variants_read count — the binary wire tier's payload, sliced
        straight off the sidecar with an identity ordinal map (zero
        parse, zero remap server-side; the CLIENT remaps to its dense
        indexes). Row/stats/AF semantics are exactly
        :meth:`stream_carrying_csr`'s."""
        csr = self._ensure_csr()
        if self._ordinal_indexes is None:
            with self._lazy_lock:
                if self._ordinal_indexes is None:
                    self._ordinal_indexes = {
                        str(cid): i
                        for i, cid in enumerate(
                            csr._d["callset_ids"].tolist()
                        )
                    }
        priv = IoStats()
        with rpc_range("jsonl", "stream_carrying_frame"):
            pair = csr.carrying_csr(
                shard,
                self._ordinal_indexes,
                variant_set_id,
                priv,
                min_allele_frequency,
            )
        self.stats.add(
            partitions=1,
            requests=1,
            reference_bases=shard.range,
            variants_read=priv.variants_read,
        )
        if pair is None:
            return (
                np.zeros(0, dtype=np.int64),
                np.zeros(1, dtype=np.int64),
                priv.variants_read,
            )
        return pair[0], pair[1], priv.variants_read

    def stream_carrying_keyed(
        self,
        variant_set_id: str,
        shard: Shard,
        indexes: dict,
        min_allele_frequency: Optional[float] = None,
    ):
        """Fused multi-dataset fast path: served from the sidecar's
        precomputed identity-hash column when available (format v2+),
        else from the parsed records."""
        self.stats.add(partitions=1, requests=1, reference_bases=shard.range)
        csr = self._ensure_csr()
        if csr.has_identity_keys():
            yield from csr.carrying_keyed(
                shard,
                indexes,
                variant_set_id,
                self.stats,
                min_allele_frequency,
            )
            return
        yield from _carrying_keyed_records(
            self._shard_records(shard),
            indexes,
            variant_set_id,
            self.stats,
            min_allele_frequency,
        )

    def stream_reads(
        self, read_group_set_id: str, shard: Shard
    ) -> Iterator[Read]:
        self.stats.add(partitions=1, requests=1, reference_bases=shard.range)
        for rec in self._reads_index().slice(shard):
            rgs = rec.get("read_group_set_id", "")
            if rgs and read_group_set_id and rgs != read_group_set_id:
                continue
            self.stats.add(reads_read=1)
            yield read_from_record(rec)
