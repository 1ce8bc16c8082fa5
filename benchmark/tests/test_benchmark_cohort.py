"""The cohort generator: deterministic per seed, and the shapes its
configuration states."""

import json
import os

import numpy as np
import pytest

from benchmark import cohort as cohort_mod
from benchmark.tests.conftest import BENCH, small_configs


def _config(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)


def _equal(a, b):
    return (a.ids == b.ids and np.array_equal(a.groups, b.groups)
            and np.array_equal(a.positions, b.positions)
            and np.array_equal(a.offsets, b.offsets)
            and np.array_equal(a.carriers, b.carriers)
            and np.array_equal(a.hom, b.hom))


@pytest.mark.parametrize("which", [0, 1])
def test_same_seed_same_cohort_and_bytes(tmp_path, which):
    config = small_configs()[which]
    seed = 2**31 + 12345  # past 32 signed bits: a run takes such seeds
    a = cohort_mod.draw(config, {}, seed)
    b = cohort_mod.draw(config, {}, seed)
    c = cohort_mod.draw(config, {}, seed + 1)
    assert _equal(a, b)
    assert not _equal(a, c)
    cohort_mod.write_jsonl(a, str(tmp_path / "a"), seed)
    cohort_mod.write_jsonl(b, str(tmp_path / "b"), seed)
    for name in ("callsets.json", "variants.jsonl"):
        assert (tmp_path / "a" / name).read_bytes() == (
            tmp_path / "b" / name).read_bytes()


def test_kg1000_superpopulations_and_spectrum():
    config = _config("kg1000-p3")
    cohort = cohort_mod.draw(config, {}, 7)
    sizes = np.bincount(cohort.groups)
    assert dict(zip(cohort_mod.population_sizes(config), sizes.tolist())) == {
        "AFR": 661, "EAS": 504, "EUR": 503, "SAS": 489, "AMR": 347}
    assert cohort.n == 2504 and cohort.sites == config["sites"]
    share = cohort.counts() / cohort.n
    # About 5 % carriers a site on average (the paper's 4.1-5.0 million
    # non-reference sites a genome of about 88 million); about half the
    # sites rare.
    assert 0.04 < share.mean() < 0.06
    assert 0.45 < (share < 0.01).mean() < 0.6
    assert share.min() > 0
    # Sites at the release's density from the segment's start.
    span = cohort.positions[-1] - cohort.positions[0]
    assert abs(cohort.sites / span * 1000 - config["site_density_per_kb"]) < 1
    assert cohort.positions[0] >= config["segment_start"]
    assert np.all(np.diff(cohort.positions) > 0)
    # Genotypes as the fixture draws them: 0/1, and 1/1 three times in ten.
    assert abs(cohort.hom.mean() - config["hom_share"]) < 0.01


def test_rare_mix_caps_the_carrier_share():
    config = small_configs()[0]
    cohort = cohort_mod.draw(config, {"af_max": 0.05, "sites": 2000}, 3)
    assert cohort.sites == 2000
    assert (cohort.counts() / cohort.n).max() < 0.05


def test_ukb_carrier_counts_and_groups():
    config = _config("ukb-wgs")
    small = dict(config, sites=4096)
    cohort = cohort_mod.draw(small, {}, 11)
    assert cohort.n == 490640
    assert sorted(np.bincount(cohort.groups).tolist()) == sorted(
        cohort_mod.population_sizes(config).values())
    k = cohort.counts()
    assert k.min() >= 1 and k.max() <= 1024
    # Log-uniform on [1, 1024]: the median near 32 carriers.
    assert 20 < np.median(k) < 48
    # Carriers of a site lie in one origin group, sorted and distinct.
    for s in range(0, 4096, 512):
        c = cohort.carriers[cohort.offsets[s]:cohort.offsets[s + 1]]
        assert np.all(np.diff(c) > 0)
        assert len(set(cohort.groups[c].tolist())) == 1


def test_written_cohort_reads_back_through_the_port(tmp_path):
    """The JSONL the generator writes is what the port's source reads: the
    same carrier lists, site by site."""
    from spark_examples_tpu_torch.genomics.shards import Shard
    from spark_examples_tpu_torch.genomics.sources import JsonlSource

    cohort = cohort_mod.draw(small_configs()[0], {"sites": 500}, 5)
    cohort_mod.write_jsonl(cohort, str(tmp_path), 5)
    source = JsonlSource(str(tmp_path))
    index = {c.id: i for i, c in enumerate(
        source.list_callsets(cohort.variant_set_id))}
    lists = list(source.stream_carrying(
        cohort.variant_set_id,
        Shard(cohort.contig, int(cohort.positions[0]),
              int(cohort.positions[-1]) + 1),
        index))
    assert len(lists) == cohort.sites
    for s, got in enumerate(lists):
        want = cohort.carriers[cohort.offsets[s]:cohort.offsets[s + 1]]
        assert sorted(got) == want.tolist()
