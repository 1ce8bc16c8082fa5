"""The port's synthetic cohort is the JAX package's, record for record.

The cohort plays the part of the weights a model port carries across: the
same seed and options must give the same callsets, the same records and
hence the same carrying lists through either package's fixture source.
"""

import numpy as np
import pytest

from spark_examples_tpu.genomics.fixtures import (
    synthetic_cohort as jax_synthetic_cohort,
)
from spark_examples_tpu.genomics.shards import Shard as JaxShard
from spark_examples_tpu_torch.genomics.fixtures import synthetic_cohort
from spark_examples_tpu_torch.genomics.shards import (
    BRCA1_REFERENCES,
    Shard,
    shards_for_references,
)

OPTIONS = [
    dict(seed=0),
    dict(seed=1, population_structure=3),
    dict(seed=2, rare_variant_af=0.05, sparse_calls=True),
    dict(seed=3, population_structure=3, rare_variant_af=0.01,
         sparse_calls=True),
    dict(seed=4, dropped_contig_every=5),
    dict(seed=5, reference_blocks_every=7, sparse_calls=True),
]


def _carrying(source, shard_cls, vsid, indexes, min_af=None):
    out = []
    for s in shards_for_references(BRCA1_REFERENCES, 20_000):
        out.extend(
            source.stream_carrying(
                vsid, shard_cls(s.contig, s.start, s.end), indexes, min_af
            )
        )
    return out


@pytest.mark.parametrize("opts", OPTIONS, ids=lambda o: str(o["seed"]))
def test_same_records_and_carrying_lists(opts):
    port = synthetic_cohort(40, 120, **opts)
    ref = jax_synthetic_cohort(40, 120, **opts)
    assert port._variants == ref._variants
    vsid = "fixture-platinum"
    assert [
        (c.id, c.name, c.variant_set_id) for c in port.list_callsets(vsid)
    ] == [(c.id, c.name, c.variant_set_id) for c in ref.list_callsets(vsid)]
    indexes = {c.id: i for i, c in enumerate(port.list_callsets(vsid))}
    for min_af in (None, 0.05):
        got = _carrying(port, Shard, vsid, indexes, min_af)
        want = _carrying(ref, JaxShard, vsid, indexes, min_af)
        assert got == want
        assert got  # the cohort carries variants at all
    assert port.stats.variants_read == ref.stats.variants_read


def test_staged_variant_stream_matches_the_fused_lists():
    # stream_variants → carrying indices (the --debug-datasets path) and
    # stream_carrying give the same lists, as in the JAX package.
    from spark_examples_tpu_torch.genomics.datasets import (
        carrying_sample_indices,
    )

    src = synthetic_cohort(30, 80, seed=6, dropped_contig_every=4)
    vsid = "fixture-platinum"
    indexes = {c.id: i for i, c in enumerate(src.list_callsets(vsid))}
    shard = Shard("17", 41196311, 41277499)
    staged = [
        carrying_sample_indices(v, indexes)
        for v in src.stream_variants(vsid, shard)
    ]
    assert [c for c in staged if c] == list(
        src.stream_carrying(vsid, shard, indexes)
    )


def test_rare_af_out_of_range_rejected():
    with pytest.raises(ValueError, match="rare_variant_af"):
        synthetic_cohort(4, 4, rare_variant_af=0.9)


def test_slice_cohort_head_matches():
    # The first records of the chip slice's cohort shape (N = 2504,
    # af 0.01, 3 populations) agree with the JAX package's generator.
    import itertools

    from spark_examples_tpu.genomics.fixtures import (
        cohort_record_stream as jax_stream,
    )
    from spark_examples_tpu_torch.genomics.fixtures import (
        cohort_record_stream,
    )

    kw = dict(seed=0, population_structure=3, rare_variant_af=0.01,
              sparse_calls=True)
    got = list(itertools.islice(cohort_record_stream(2504, 65536, **kw), 64))
    want = list(itertools.islice(jax_stream(2504, 65536, **kw), 64))
    assert got == want
    assert np.mean([len(r["calls"]) for r in got]) > 1


# -- reads --------------------------------------------------------------------

READS_OPTIONS = [
    dict(n_reads=200, seed=0),
    dict(n_reads=120, seed=3, read_len=700,
         references="1:100000000:100003000"),
    dict(n_reads=150, seed=7, read_group_set_id="other", mean_quality=20,
         variant_positions={6889000: ("T", 0.5), 6889500: ("G", 1.0)}),
    dict(n_reads=0, seed=1),
]


@pytest.mark.parametrize("opts", READS_OPTIONS,
                         ids=lambda o: f"{o['n_reads']}-{o['seed']}")
def test_same_read_records(opts):
    from spark_examples_tpu.genomics.fixtures import (
        synthetic_reads as jax_synthetic_reads,
    )
    from spark_examples_tpu_torch.genomics.fixtures import synthetic_reads

    opts = dict(opts)
    n = opts.pop("n_reads")
    got = synthetic_reads(n, **opts).reads_records()
    want = jax_synthetic_reads(n, **opts).reads_records()
    assert got == want and len(got) == n


@pytest.mark.parametrize("seed,n_somatic", [(0, 3), (4, 5)])
def test_same_tumor_normal_pair(seed, n_somatic):
    from spark_examples_tpu.genomics import fixtures as jax_fixtures
    from spark_examples_tpu_torch.genomics import fixtures

    got = fixtures.synthetic_tumor_normal(200, seed=seed,
                                          n_somatic=n_somatic)
    want = jax_fixtures.synthetic_tumor_normal(200, seed=seed,
                                               n_somatic=n_somatic)
    assert got.reads_records() == want.reads_records()
    assert got.somatic_positions == want.somatic_positions
    assert len(got.somatic_positions) == n_somatic
    for name in ("FIXTURE_READSET_ID", "NORMAL_READSET_ID",
                 "TUMOR_READSET_ID"):
        assert getattr(fixtures, name) == getattr(jax_fixtures, name)


@pytest.mark.parametrize("reads", ["none", "records", "tumor-normal"])
def test_cohort_identity_with_reads_is_the_jax_packages(reads):
    from spark_examples_tpu.genomics import fixtures as jax_fixtures
    from spark_examples_tpu_torch.genomics import fixtures

    port = synthetic_cohort(10, 30, seed=2)
    ref = jax_synthetic_cohort(10, 30, seed=2)
    before = port.cohort_identity()
    assert before == ref.cohort_identity()
    if reads == "records":
        port.add_reads(fixtures.synthetic_reads(
            40, seed=1).reads_records())
        ref.add_reads(jax_fixtures.synthetic_reads(
            40, seed=1).reads_records())
    elif reads == "tumor-normal":
        port.add_reads(fixtures.synthetic_tumor_normal(
            30, seed=2).reads_records())
        ref.add_reads(jax_fixtures.synthetic_tumor_normal(
            30, seed=2).reads_records())
    assert port.cohort_identity() == ref.cohort_identity()
    assert (port.cohort_identity() == before) == (reads == "none")
    assert list(port.export_lines("reads.jsonl")) == list(
        ref.export_lines("reads.jsonl"))
