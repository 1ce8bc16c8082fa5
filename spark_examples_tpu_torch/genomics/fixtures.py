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

import json
import os
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
    "dump_cohort_stream",
    "synthetic_reads",
    "synthetic_read_pairs",
    "synthetic_tumor_normal",
    "DEFAULT_VARIANT_SET_ID",
    "FIXTURE_READSET_ID",
    "NORMAL_READSET_ID",
    "TUMOR_READSET_ID",
]

DEFAULT_VARIANT_SET_ID = "fixture-platinum"
FIXTURE_READSET_ID = "fixture-readset"

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


def dump_cohort_stream(
    root: str,
    n_samples: int,
    n_variants: int,
    variant_set_id: str = DEFAULT_VARIANT_SET_ID,
    append: bool = False,
    **kw,
) -> None:
    """Write a cohort as a JSONL directory WITHOUT materializing it —
    the disk-scale twin of ``FixtureSource.dump`` for cohorts too large
    for memory. ``append=True`` adds another variant set's records and
    callsets to an existing directory (multi-dataset cohorts).
    """
    os.makedirs(root, exist_ok=True)
    for name in ("callsets.json.gz", "variants.jsonl.gz"):
        if os.path.exists(os.path.join(root, name)):
            # Readers treat .gz as authoritative; appending plain files
            # beside them would be silently invisible.
            raise ValueError(
                f"{root} holds gzipped cohort files ({name}); "
                "dump_cohort_stream writes plain JSONL only"
            )
    callsets_path = os.path.join(root, "callsets.json")
    rows = []
    if append and os.path.exists(callsets_path):
        with open(callsets_path) as f:
            rows = json.load(f)
    rows.extend(
        {
            "id": c.id,
            "name": c.name,
            "variant_set_id": c.variant_set_id,
        }
        for c in cohort_callsets(n_samples, variant_set_id)
    )
    with open(callsets_path, "w") as f:
        json.dump(rows, f)
    mode = "a" if append else "w"
    with open(os.path.join(root, "variants.jsonl"), mode) as f:
        for rec in cohort_record_stream(
            n_samples, n_variants, variant_set_id=variant_set_id, **kw
        ):
            f.write(json.dumps(rec) + "\n")


def synthetic_reads(
    n_reads: int,
    references: str = "11:6888648:6890648",
    read_len: int = 100,
    read_group_set_id: str = FIXTURE_READSET_ID,
    seed: int = 0,
    variant_positions: Optional[dict] = None,
    mean_quality: int = 35,
    stats=None,
) -> FixtureSource:
    """Generate aligned reads over a region from a latent haplotype.

    A deterministic reference haplotype is drawn for the region; reads copy
    it with ~1% base error, so per-position base-frequency tables have
    realistic consensus structure. ``variant_positions`` maps absolute
    position → (alt_base, fraction): that fraction of covering reads carry
    the alt — the tumor/normal injection hook for the Example-4 pipeline
    (reference DREAM synthetic set analog, SearchReadsExample.scala:171+).
    """
    rng = np.random.default_rng(seed)
    regions = parse_references(references)
    contig, start, end = regions[0]
    region_len = end - start
    haplotype = rng.integers(0, 4, size=region_len)
    variant_positions = variant_positions or {}

    records: List[dict] = []
    for ri in range(n_reads):
        pos = start + int(rng.integers(0, max(1, region_len - read_len)))
        codes = haplotype[pos - start : pos - start + read_len].copy()
        errs = rng.random(read_len) < 0.01
        codes[errs] = rng.integers(0, 4, size=int(errs.sum()))
        for vpos, (alt, frac) in variant_positions.items():
            off = vpos - pos
            if 0 <= off < read_len and rng.random() < frac:
                codes[off] = _BASES.index(alt)
        seq = "".join(_BASES[c] for c in codes)
        quals = np.clip(
            rng.normal(mean_quality, 5, size=read_len).astype(int), 2, 60
        )
        records.append(
            {
                "reference_name": contig,
                "position": pos,
                "aligned_sequence": seq,
                "aligned_quality": quals.tolist(),
                "cigar_ops": [("ALIGNMENT_MATCH", read_len)],
                "mapping_quality": int(
                    np.clip(rng.normal(50, 15), 0, 60)
                ),
                "fragment_name": f"read-{ri}",
                "read_group_set_id": read_group_set_id,
            }
        )
    return FixtureSource(reads=records, stats=stats)


def synthetic_read_pairs(
    n_pairs: int,
    read_len: int = 6,
    hap_len: int = 10,
    quality: int = 20,
    seed: int = 0,
):
    """Read×haplotype pairs with HAND-COMPUTABLE PairHMM likelihoods.

    The PairHMM golden tests need pairs whose likelihood can be derived
    on paper — without re-deriving ``synthetic_reads``' latent
    haplotype (an internal its tests must stay decoupled from). Every
    pair here has UNIFORM base quality and one of four known edit
    structures against its haplotype:

    - ``match``: the read is an exact substring — each matching
      alignment offset contributes
      ``(1/h) · (1-ε_ge) · (1-2ε_go)^{r-1} · (1-ε)^r`` through its
      all-match path (free-start deletion row → gap-close into M, then
      r matches), so that closed-form sum over offsets is a tight
      lower bound on the likelihood — hand-checkable to ~1%;
    - ``mismatch``: one substituted base mid-read (the dominant path
      trades one ``1-ε`` for ``ε/3``);
    - ``insert``: one extra base mid-read (the dominant path opens and
      closes one insertion);
    - ``delete``: one haplotype base skipped mid-read (one deletion).

    Returns a list of dicts: ``name``, ``kind``, ``offset`` (the true
    alignment offset), ``read``/``quals``/``hap`` numpy arrays in the
    kernel's code space. Deterministic per seed.
    """
    if hap_len < read_len + 2:
        raise ValueError(
            f"hap_len {hap_len} must exceed read_len {read_len} by >= 2 "
            "(the insert/delete structures need slack)"
        )
    rng = np.random.default_rng(seed)
    kinds = ("match", "mismatch", "insert", "delete")
    pairs = []
    for i in range(n_pairs):
        kind = kinds[i % len(kinds)]
        hap = rng.integers(0, 4, size=hap_len).astype(np.int8)
        off = int(rng.integers(0, hap_len - read_len - 1))
        read = hap[off : off + read_len].copy()
        mid = read_len // 2
        if kind == "mismatch":
            read[mid] = (read[mid] + 1 + int(rng.integers(0, 3))) % 4
        elif kind == "insert":
            read = np.insert(read, mid, (hap[off + mid] + 2) % 4)[
                :read_len
            ].astype(np.int8)
        elif kind == "delete":
            read = np.delete(
                np.append(read, hap[off + read_len]), mid
            ).astype(np.int8)
        pairs.append(
            {
                "name": f"pair-{i}-{kind}",
                "kind": kind,
                "offset": off,
                "read": read,
                "quals": np.full(read.size, quality, dtype=np.int32),
                "hap": hap,
            }
        )
    return pairs


NORMAL_READSET_ID = "fixture-normal"
TUMOR_READSET_ID = "fixture-tumor"


def synthetic_tumor_normal(
    n_reads: int,
    references: str = "1:100000000:100002000",
    seed: int = 0,
    n_somatic: int = 3,
    somatic_fraction: float = 0.6,
    stats=None,
) -> FixtureSource:
    """Two readsets over the same haplotype, tumor carrying somatic variants.

    The hermetic stand-in for the DREAM synthetic tumor/normal pair
    (SearchReadsExample.scala:35-37): identical seed → identical latent
    haplotype, with ``n_somatic`` positions where ``somatic_fraction`` of
    tumor reads carry an alternate base — the signal Example 4's diff
    pipeline must recover.
    """
    rng = np.random.default_rng(seed + 1)
    contig, start, end = parse_references(references)[0]
    # Replay synthetic_reads' haplotype draw (same seed, first draw) so the
    # somatic alt is guaranteed to differ from the reference base.
    haplotype = np.random.default_rng(seed).integers(0, 4, size=end - start)
    margin = min(200, (end - start) // 4)
    somatic = {}
    while len(somatic) < n_somatic:
        pos = int(rng.integers(start + margin, end - margin))
        alt = (int(haplotype[pos - start]) + int(rng.integers(1, 4))) % 4
        somatic[pos] = (_BASES[alt], somatic_fraction)
    normal = synthetic_reads(
        n_reads,
        references=references,
        read_group_set_id=NORMAL_READSET_ID,
        seed=seed,
    )
    tumor = synthetic_reads(
        n_reads,
        references=references,
        read_group_set_id=TUMOR_READSET_ID,
        seed=seed,
        variant_positions=somatic,
    )
    merged = FixtureSource(
        reads=normal._reads + tumor._reads, stats=stats
    )
    merged.somatic_positions = sorted(somatic)  # for tests
    return merged
