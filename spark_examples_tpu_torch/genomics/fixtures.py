"""Synthetic cohort generation: hermetic, deterministic fixtures.

The Genomics v1 API is retired, so tests and benchmarks run against
generated cohorts with the same shape as the reference's inputs: a callset
per sample (1000-Genomes-style names), variants across a genomic region with
per-sample genotype calls, AF info fields, and a sprinkling of non-numeric
contigs that must be dropped by the builder (the ``VariantsRDD.scala:132-135``
semantics the hermetic fixture is meant to exercise — SURVEY.md §4).

The generator consumes numpy's ``default_rng(seed)`` stream exactly as the
JAX package's ``genomics/fixtures.py`` does, so the same seed and options
give the same cohort record for record: the port's counterpart of carrying
weights across.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from spark_examples_tpu_torch.genomics.shards import (
    BRCA1_REFERENCES,
    parse_references,
)
from spark_examples_tpu_torch.genomics.sources import Callset, FixtureSource

__all__ = [
    "synthetic_cohort",
    "cohort_record_stream",
    "cohort_callsets",
    "DEFAULT_VARIANT_SET_ID",
]

DEFAULT_VARIANT_SET_ID = "fixture-platinum"

_BASES = ("A", "C", "G", "T")


def _sample_name(i: int) -> str:
    return f"NA{20000 + i:05d}" if i % 2 == 0 else f"HG{i:05d}"


def synthetic_cohort(
    n_samples: int,
    n_variants: int,
    references: str = BRCA1_REFERENCES,
    variant_set_id: str = DEFAULT_VARIANT_SET_ID,
    seed: int = 0,
    population_structure: int = 2,
    dropped_contig_every: Optional[int] = None,
    reference_blocks_every: Optional[int] = None,
    sparse_calls: bool = False,
    rare_variant_af: Optional[float] = None,
    stats=None,
) -> FixtureSource:
    """Build an in-memory cohort with latent population structure.

    Samples are split into ``population_structure`` groups with different
    per-variant allele frequencies, so the PCoA has real signal to find
    (group separation along PC1) — making end-to-end output qualitatively
    checkable, not just numerically stable.

    ``dropped_contig_every``: every k-th variant is emitted on contig
    "chrX_alt" and must be dropped by ingest.

    ``reference_blocks_every``: every k-th record is a gVCF-style
    reference-matching block (referenceBases "N", no alternates, no calls)
    — the record class the Platinum Genomes sets interleave with variants
    and the search-variants examples count separately
    (SearchVariantsExample.scala:57-63, 104-112).

    ``sparse_calls``: omit hom-ref (0/0) calls from records — ~10× faster
    generation and memory at large N×V with identical pipeline results
    (non-carrying calls never reach the Gramian; N comes from the callset
    index, not from call lists). Dense is the default for realism.

    ``rare_variant_af``: cap every variant's allele frequency near this
    value (per-group AFs drawn in [0.5·af, 1.5·af) so the population
    structure survives) — the biobank-shaped rare-variant regime the
    sparse Gramian path exists for (~98% zeros at af ≈ 0.01). ``None``
    keeps the historical beta(0.4, 1.2) common-variant draw and an
    identical RNG stream (seeded cohorts and goldens are unchanged).
    """
    callsets = cohort_callsets(n_samples, variant_set_id)
    return FixtureSource(
        variants=list(
            cohort_record_stream(
                n_samples,
                n_variants,
                references=references,
                variant_set_id=variant_set_id,
                seed=seed,
                population_structure=population_structure,
                dropped_contig_every=dropped_contig_every,
                reference_blocks_every=reference_blocks_every,
                sparse_calls=sparse_calls,
                rare_variant_af=rare_variant_af,
            )
        ),
        callsets=callsets,
        stats=stats,
    )


def cohort_callsets(n_samples: int, variant_set_id: str) -> List[Callset]:
    return [
        Callset(
            id=f"{variant_set_id}-{i}",
            name=_sample_name(i),
            variant_set_id=variant_set_id,
        )
        for i in range(n_samples)
    ]


def cohort_record_stream(
    n_samples: int,
    n_variants: int,
    references: str = BRCA1_REFERENCES,
    variant_set_id: str = DEFAULT_VARIANT_SET_ID,
    seed: int = 0,
    population_structure: int = 2,
    dropped_contig_every: Optional[int] = None,
    reference_blocks_every: Optional[int] = None,
    sparse_calls: bool = False,
    rare_variant_af: Optional[float] = None,
):
    """The cohort generator as a RECORD STREAM — O(1) memory, so
    BASELINE-#4-scale cohorts (millions of variants, tens of GB of
    records) can be written straight to disk. Identical RNG consumption
    to the in-memory path (:func:`synthetic_cohort` wraps this), so
    seeded cohorts and goldens are unchanged.
    """
    if rare_variant_af is not None and not (0 < rare_variant_af <= 2 / 3):
        # The per-group draw spans [0.5·af, 1.5·af): af > 2/3 silently
        # saturates carrier probability past 1 (an ALL-carrier cohort —
        # the opposite of the requested rare shape) and af <= 0 yields
        # zero carriers everywhere. Refuse loudly instead.
        raise ValueError(
            f"rare_variant_af must be in (0, 2/3], got {rare_variant_af} "
            "(the per-group draw spans [0.5x, 1.5x) of the value)"
        )
    rng = np.random.default_rng(seed)
    regions = parse_references(references)
    callsets = cohort_callsets(n_samples, variant_set_id)
    ids = [c.id for c in callsets]
    names = [c.name for c in callsets]
    groups = rng.integers(0, population_structure, size=n_samples)

    # Spread variant positions across the configured regions.
    total_len = sum(end - start for _, start, end in regions)
    offsets = rng.choice(total_len, size=n_variants, replace=False) if (
        n_variants <= total_len
    ) else rng.integers(0, total_len, size=n_variants)
    offsets = np.sort(offsets)

    for vi in range(n_variants):
        off = int(offsets[vi])
        for contig, start, end in regions:
            if off < end - start:
                pos = start + off
                break
            off -= end - start
        reference_name = (
            "chrX_alt"
            if dropped_contig_every and vi % dropped_contig_every == 0
            else contig
        )
        if reference_blocks_every and vi % reference_blocks_every == 0:
            yield {
                "reference_name": reference_name,
                "start": pos,
                "end": pos + int(rng.integers(1, 200)),
                "reference_bases": "N",
                "variant_set_id": variant_set_id,
                "calls": [],
            }
            continue
        ref_base = _BASES[rng.integers(0, 4)]
        alt_base = _BASES[(rng.integers(1, 4) + _BASES.index(ref_base)) % 4]
        # Per-group allele frequency: structured signal for the PCoA.
        # The rare-variant regime draws ONLY when asked, so the default
        # RNG stream (and every seeded golden) is untouched.
        if rare_variant_af is not None:
            group_af = rare_variant_af * (
                0.5 + rng.random(population_structure)
            )
        else:
            group_af = rng.beta(0.4, 1.2, size=population_structure)
        carrier_p = group_af[groups]
        gts = rng.random(n_samples) < carrier_p
        carriers = np.nonzero(gts)[0]
        # One vectorized draw per carrier, consumed in carrier order —
        # bit-identical to the per-carrier scalar draws this replaces
        # (numpy Generators produce the same stream either way), so
        # seeded cohorts (incl. the committed golden) are unchanged.
        hom = np.zeros(n_samples, dtype=bool)
        hom[carriers] = rng.random(len(carriers)) < 0.3
        gts_l, hom_l = gts.tolist(), hom.tolist()
        sample_range = carriers.tolist() if sparse_calls else range(
            n_samples
        )
        calls = [
            {
                "callset_id": ids[s],
                "callset_name": names[s],
                "genotype": [1, 1] if hom_l[s]
                else ([0, 1] if gts_l[s] else [0, 0]),
            }
            for s in sample_range
        ]
        af = float(gts.mean())
        yield {
            "reference_name": reference_name,
            "start": pos,
            "end": pos + 1,
            "reference_bases": ref_base,
            "alternate_bases": [alt_base],
            "info": {"AF": [f"{af:.6f}"]},
            "variant_set_id": variant_set_id,
            "calls": calls,
        }
