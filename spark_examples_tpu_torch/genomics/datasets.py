"""Dataset assembly: AF filtering, multi-dataset join/merge, call extraction.

The host-side transformations between raw variant streams and the carrier
windows and blocks the device consumes — the semantics of
``VariantsPca.scala:96-168`` without the Spark shuffle machinery: identity
join/merge run in plain dictionaries keyed by the murmur3 variant identity,
then per-variant carrying-sample index lists flow straight into the window
and block builders (:mod:`spark_examples_tpu_torch.arrays.blocks`).
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

from spark_examples_tpu_torch.genomics.hashing import (
    _identity_payload,
    hash_payloads,
)
from spark_examples_tpu_torch.genomics.types import Variant, has_variation

__all__ = [
    "af_filter",
    "af_value",
    "carrying_sample_indices",
    "join_datasets",
    "merge_datasets",
    "calls_stream",
    "join_keyed",
    "merge_keyed",
    "calls_stream_keyed",
]


def af_value(af) -> Optional[float]:
    """``info["AF"][0]`` as a float, or ``None`` when absent or non-numeric.

    Non-numeric AF (the VCF "." missing marker, or any malformed value)
    counts as MISSING: under an active filter the record drops, in every
    tier — staged, fused record stream, and CSR sidecar (which stores it
    as NaN) — so the tiers stay behavior-identical on bad input. The
    reference would throw NumberFormatException here
    (``"AF".toDouble``-style, VariantsPca.scala:100-104); crashing a
    whole-cohort run on one missing marker is a bug, not parity to keep.
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


def _flatten_runs(runs):
    for _, group in runs:
        yield from group


def _aligned_chunks(
    streams: Sequence[Iterable],
    contig_of=lambda v: v.contig,
) -> Iterator[List[Iterable]]:
    """Align the streams into per-contig chunks for bounded-memory joins.

    The variant identity hash embeds the contig, so records on different
    contigs can never join — partitioning any identity join/merge by contig
    is semantically lossless, and it bounds the join state to one contig's
    variants instead of a whole cohort's (~40M+ at all-autosomes
    multi-dataset scale, where the reference shuffled across a cluster,
    VariantsPca.scala:136-148).

    PRECONDITION (the caller's promise, see ``contig_runs_unique``): each
    stream presents each contig as AT MOST ONE contiguous run. Identities
    in two different runs of the same contig would never meet; the seen-set
    below turns that silent wrongness into a loud error. Manifest-driven
    streams satisfy the precondition whenever the manifest visits each
    contig once (checked by the pipeline, not assumed).

    When run orders diverge — e.g. one dataset has no variants on some
    contig — the remainder of every stream is yielded as a single final
    chunk: unbounded again, but never wrong.

    Each yielded chunk must be fully consumed before the next is requested
    (itertools.groupby invalidates prior groups on advance); the consumers
    below do exactly that.
    """
    runs = [
        itertools.groupby(s, key=contig_of) for s in streams
    ]
    seen = set()
    while True:
        heads = []
        for r in runs:
            try:
                heads.append(next(r))
            except StopIteration:
                heads.append(None)
        if all(h is None for h in heads):
            return
        contigs = {h[0] for h in heads if h is not None}
        if contigs & seen:
            raise ValueError(
                f"contig(s) {sorted(contigs & seen)} appear in more than "
                "one run of a stream; contig-partitioned joins need "
                "unique contig runs (pass contig_runs_unique=False)"
            )
        if len(contigs) == 1 and all(h is not None for h in heads):
            seen.update(contigs)
            yield [h[1] for h in heads]
        else:
            yield [
                itertools.chain(
                    h[1] if h is not None else (), _flatten_runs(r)
                )
                for h, r in zip(heads, runs)
            ]
            return


def _variant_triples(stream, indexes):
    """Built Variants → the keyed-triple shape the join engine consumes
    (identity payload fields per VariantsPca.scala:62-78)."""
    for v in stream:
        yield (
            v.contig,
            _identity_payload(
                v.contig, v.start, v.end,
                v.reference_bases, v.alternate_bases,
            ),
            carrying_sample_indices(v, indexes),
        )


def join_datasets(
    a: Iterable[Variant],
    b: Iterable[Variant],
    indexes: Dict[str, int],
    contig_runs_unique: bool = False,
) -> Iterator[List[int]]:
    """Two-dataset inner join on variant identity (VariantsPca.scala:115-128).

    Yields concatenated carrying-sample index lists for variants present in
    both datasets — one row per matching (left record, right record) pair,
    exactly as the reference's RDD join does when an identity occurs more
    than once within a dataset.

    ``contig_runs_unique=True`` is the caller's promise that each stream
    presents each contig as at most one contiguous run (true for
    manifest-driven streams whose manifest visits each contig once); under
    it, join state is bounded per contig via :func:`_aligned_chunks`
    instead of growing with the whole cohort.
    """
    # Adapter over the keyed engine: staged and fused joins share ONE
    # state machine, so they cannot diverge by construction.
    return join_keyed(
        _variant_triples(a, indexes),
        _variant_triples(b, indexes),
        contig_runs_unique,
    )


def merge_datasets(
    streams: Sequence[Iterable[Variant]],
    indexes: Dict[str, int],
    contig_runs_unique: bool = False,
) -> Iterator[List[int]]:
    """N-way merge keeping variants present in *all* datasets.

    The reference unions all sets, groups by identity, and keeps groups of
    size == dataset count (VariantsPca.scala:136-148) — record count, not
    distinct-set count, replicated here. Group state is bounded per contig
    via :func:`_aligned_chunks` under the ``contig_runs_unique`` promise
    (see :func:`join_datasets`).
    """
    return merge_keyed(
        [_variant_triples(st, indexes) for st in streams],
        contig_runs_unique,
    )


def calls_stream(
    streams: Sequence[Iterable[Variant]],
    indexes: Dict[str, int],
    contig_runs_unique: bool = False,
) -> Iterator[List[int]]:
    """Dispatch 1/2/N datasets → per-variant index lists, dropping variants
    with no carrying samples (getCallsRdd, VariantsPca.scala:153-168)."""
    if len(streams) == 1:
        gen = (carrying_sample_indices(v, indexes) for v in streams[0])
    elif len(streams) == 2:
        gen = join_datasets(
            streams[0], streams[1], indexes, contig_runs_unique
        )
    else:
        gen = merge_datasets(streams, indexes, contig_runs_unique)
    for calls in gen:
        if calls:
            yield calls


# -- fused (keyed-triple) multi-dataset path ---------------------------------
#
# The fast-path twin of join/merge_datasets: sources emit
# (contig, identity payload, carrying indices) triples
# (sources._carrying_keyed_records) so no Call/Variant objects are built;
# payloads hash in batches (:func:`_hashed`).


def _hashed(triples, chunk: int = 65536):
    """(contig, payload, calls) → (identity key, calls), hashing payloads
    in bounded batches."""
    it = iter(triples)
    while True:
        block = list(itertools.islice(it, chunk))
        if not block:
            return
        # A str in the key slot is an ALREADY-HASHED identity (sidecar's
        # precomputed column); bytes are raw payloads to hash here.
        keys = hash_payloads(
            t[1] for t in block if not isinstance(t[1], str)
        )
        kit = iter(keys)
        for t in block:
            yield (t[1] if isinstance(t[1], str) else next(kit)), t[2]


def _triple_contig(t):
    return t[0]


def join_keyed(a, b, contig_runs_unique: bool = False):
    """Keyed-triple twin of :func:`join_datasets` — identical semantics
    (pair-per-record inner join, per-contig bounded state under the
    unique-runs contract), inputs already carrying-extracted."""
    chunk_pairs = (
        _aligned_chunks([a, b], contig_of=_triple_contig)
        if contig_runs_unique
        else iter([[a, b]])
    )
    for chunk_a, chunk_b in chunk_pairs:
        left: Dict[str, List[List[int]]] = {}
        for key, calls in _hashed(chunk_a):
            left.setdefault(key, []).append(calls)
        for key, calls in _hashed(chunk_b):
            rows = left.get(key)
            if rows is not None:
                for left_calls in rows:
                    yield left_calls + calls


def merge_keyed(streams, contig_runs_unique: bool = False):
    """Keyed-triple twin of :func:`merge_datasets` (present-in-all by
    record count, VariantsPca.scala:136-148)."""
    want = len(streams)
    chunk_sets = (
        _aligned_chunks(streams, contig_of=_triple_contig)
        if contig_runs_unique
        else iter([streams])
    )
    for chunks in chunk_sets:
        groups: Dict[str, List[int]] = {}
        counts: Dict[str, int] = {}
        for chunk in chunks:
            for key, calls in _hashed(chunk):
                counts[key] = counts.get(key, 0) + 1
                groups.setdefault(key, []).extend(calls)
        for key, calls in groups.items():
            if counts[key] == want:
                yield calls


def calls_stream_keyed(streams, contig_runs_unique: bool = False):
    """Multi-dataset dispatch over keyed triples, dropping variants with
    no carrying samples after concatenation (getCallsRdd semantics)."""
    if len(streams) < 2:
        # A single stream has no join semantics; the N-way merge would
        # silently DROP duplicate identities (count != want). Use
        # calls_stream / the carrying fast path for one dataset.
        raise ValueError(
            "calls_stream_keyed needs >= 2 datasets; got "
            f"{len(streams)}"
        )
    if len(streams) == 2:
        gen = join_keyed(streams[0], streams[1], contig_runs_unique)
    else:
        gen = merge_keyed(streams, contig_runs_unique)
    for calls in gen:
        if calls:
            yield calls
