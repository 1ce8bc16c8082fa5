"""Multi-dataset join and merge: the port against the JAX package.

The identity join (two datasets, ``VariantsPca.scala:115-128``) and the
present-in-all merge (three or more, ``:136-148``) over built Variants
(``calls_stream``) and over keyed triples (``calls_stream_keyed``) must
give the JAX package's rows, in its order: duplicate identities join as a
cross product, multi-contig runs partition the state per contig, and
diverging contig runs fall back to the unbounded join. The driver's fused
multi-dataset route must equal its staged route and the JAX driver, over
an in-memory fixture of two and three sets and over a directory written
with ``dump_cohort_stream(append=True)`` and read through the CSR sidecar.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from spark_examples_tpu.genomics import datasets as jax_datasets
from spark_examples_tpu.genomics import fixtures as jax_fixtures
from spark_examples_tpu.genomics import sources as jax_sources
from spark_examples_tpu.genomics import types as jax_types
from spark_examples_tpu.models.pca import VariantsPcaDriver as JaxDriver
from spark_examples_tpu.utils.config import PcaConfig as JaxConfig
from spark_examples_tpu_torch.genomics import datasets
from spark_examples_tpu_torch.genomics import fixtures
from spark_examples_tpu_torch.genomics import sources
from spark_examples_tpu_torch.genomics import types
from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
from spark_examples_tpu_torch.utils.config import PcaConfig

PKGS = {
    "port": (types, datasets),
    "jax": (jax_types, jax_datasets),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _variants(t, spec):
    """[(contig, start, callset, genotype), ...] → one package's Variants."""
    return [
        t.Variant.build(
            contig, start, start + 1, "A",
            alternate_bases=["G"], variant_set_id="vs",
            calls=[t.Call(cid, cid, tuple(gt))],
        )
        for contig, start, cid, gt in spec
    ]


INDEX = {"a": 0, "b": 1, "c": 2, "d": 3}
CASES = {
    "join": [
        [("17", 1, "a", (0, 1)), ("17", 9, "a", (1, 1))],
        [("17", 1, "b", (0, 1))],
    ],
    "join-duplicates": [
        [("17", 1, "a", (0, 1)), ("17", 1, "b", (1, 1))],
        [("17", 1, "c", (0, 1)), ("17", 1, "d", (1, 1))],
    ],
    "join-multi-contig": [
        [("1", 5, "a", (0, 1)), ("2", 7, "a", (0, 1)),
         ("17", 9, "a", (0, 1))],
        [("1", 5, "b", (1, 1)), ("2", 8, "b", (1, 1)),
         ("17", 9, "b", (1, 1))],
    ],
    "join-divergent-runs": [
        [("1", 5, "a", (0, 1)), ("2", 7, "a", (1, 1))],
        [("2", 7, "b", (0, 1)), ("1", 5, "b", (1, 1))],
    ],
    "join-empty-side": [
        [("17", 1, "a", (0, 0)), ("17", 2, "a", (0, 0))],
        [("17", 1, "b", (0, 1)), ("17", 2, "b", (0, 0))],
    ],
    "merge": [
        [("17", 1, "a", (0, 1))],
        [("17", 1, "b", (0, 1))],
        [("17", 1, "c", (0, 1)), ("17", 2, "c", (0, 1))],
    ],
    "merge-multi-contig": [
        [("1", 1, "a", (0, 1)), ("2", 1, "a", (0, 1))],
        [("1", 1, "b", (0, 1)), ("2", 1, "b", (1, 0))],
        [("1", 1, "c", (0, 1)), ("2", 1, "c", (0, 1)),
         ("3", 4, "c", (1, 1))],
    ],
    "merge-duplicates": [
        [("17", 1, "a", (0, 1)), ("17", 1, "b", (0, 1))],
        [("17", 1, "c", (0, 1))],
        [("17", 1, "d", (0, 1)), ("17", 3, "d", (0, 1))],
    ],
}


def _rows(pkg, case, unique, keyed):
    t, d = PKGS[pkg]
    streams = [_variants(t, spec) for spec in CASES[case]]
    if keyed:
        triples = [d._variant_triples(s, INDEX) for s in streams]
        return list(d.calls_stream_keyed(triples, unique))
    return list(d.calls_stream(streams, INDEX, unique))


@pytest.mark.parametrize("keyed", [False, True], ids=["staged", "keyed"])
@pytest.mark.parametrize("unique", [False, True], ids=["whole", "per-contig"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_join_and_merge_equal_the_jax_package(case, unique, keyed):
    got = _rows("port", case, unique, keyed)
    want = _rows("jax", case, unique, keyed)
    assert got == want
    # Every case joins something, except a merge whose identity occurs
    # more often than there are datasets: present-in-all counts records.
    assert bool(got) != (case == "merge-duplicates")


def test_join_cross_product_and_merge_counts():
    assert sorted(_rows("port", "join-duplicates", False, False)) == [
        [0, 2], [0, 3], [1, 2], [1, 3]
    ]
    assert sorted(map(sorted, _rows("port", "merge", False, False))) == [
        [0, 1, 2]
    ]


def test_precomputed_keys_pass_through_unhashed():
    payload = datasets._identity_payload("17", 1, 2, "A", ["G"])
    key = datasets.hash_payloads([payload])[0]
    a = [("17", payload, [0]), ("17", key, [1])]
    b = [("17", key, [2])]
    got = list(datasets.calls_stream_keyed([iter(a), iter(b)]))
    want = list(jax_datasets.calls_stream_keyed([iter(a), iter(b)]))
    assert got == want == [[0, 2], [1, 2]]


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_repeated_contig_runs_are_a_loud_error(pkg):
    t, d = PKGS[pkg]
    spec = [("1", 1, "a", (0, 1)), ("2", 1, "a", (0, 1)),
            ("1", 5, "a", (0, 1))]
    streams = [_variants(t, spec), _variants(t, spec)]
    with pytest.raises(ValueError, match="more than one run"):
        list(d.calls_stream(streams, INDEX, contig_runs_unique=True))


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_keyed_calls_need_two_datasets(pkg):
    _, d = PKGS[pkg]
    with pytest.raises(ValueError, match=">= 2 datasets"):
        list(d.calls_stream_keyed([iter(())]))


# -- the driver --------------------------------------------------------------

N_SET = 10
REFS = "17:41196311:41196911"  # 600 bases: sets of 400 variants overlap
SETS = [("setA", 1), ("setB", 1), ("setC", 2)]
SETTINGS = dict(
    references=REFS, block_variants=32, sparse_density_threshold=0.4,
    bases_per_partition=200,
)


def _fixture(pkg_fixtures, pkg_sources, n_sets):
    records, callsets = [], []
    for vsid, seed in SETS[:n_sets]:
        records.extend(pkg_fixtures.cohort_record_stream(
            N_SET, 400, references=REFS, variant_set_id=vsid, seed=seed,
            population_structure=3,
        ))
        callsets.extend(pkg_fixtures.cohort_callsets(N_SET, vsid))
    return pkg_sources.FixtureSource(records, callsets)


def _run(driver):
    with contextlib.redirect_stdout(io.StringIO()):
        return driver.run()


def _port(source, n_sets, mode, **kw):
    conf = PcaConfig(
        device="cpu", pca_mode=mode,
        variant_set_ids=[v for v, _ in SETS[:n_sets]], **SETTINGS, **kw,
    )
    driver = VariantsPcaDriver(conf, source)
    return driver, _run(driver)


def _jax_g(source, n_sets, mode):
    conf = JaxConfig(
        pca_mode=mode, variant_set_ids=[v for v, _ in SETS[:n_sets]],
        **SETTINGS,
    )
    with contextlib.redirect_stdout(io.StringIO()):
        return np.asarray(JaxDriver(conf, source).ingest_gramian())


@pytest.mark.parametrize("mode", ["auto", "sparse"])
@pytest.mark.parametrize("n_sets", [2, 3])
def test_fused_multi_route_equals_staged_and_the_jax_driver(n_sets, mode):
    fused, fused_result = _port(
        _fixture(fixtures, sources, n_sets), n_sets, mode
    )
    assert fused._fused_multi_possible()
    staged, staged_result = _port(
        _fixture(fixtures, sources, n_sets), n_sets, mode,
        debug_datasets=True,
    )
    assert not staged._fused_multi_possible()
    want = _jax_g(_fixture(jax_fixtures, jax_sources, n_sets), n_sets, mode)
    g = fused.g.numpy()
    assert np.array_equal(g, staged.g.numpy())
    assert np.array_equal(g, want)
    assert g.shape == (n_sets * N_SET,) * 2 and g.sum() > 0
    assert fused_result == staged_result


@pytest.mark.parametrize("n_sets", [2, 3])
def test_appended_directory_joins_through_the_sidecar(tmp_path, n_sets):
    root = str(tmp_path / "multi")
    for i, (vsid, seed) in enumerate(SETS[:n_sets]):
        fixtures.dump_cohort_stream(
            root, N_SET, 400, variant_set_id=vsid, append=i > 0,
            references=REFS, seed=seed, population_structure=3,
        )
    disk, disk_result = _port(sources.JsonlSource(root), n_sets, "auto")
    assert disk.source._csr is not None  # keyed from the sidecar column
    mem, mem_result = _port(
        _fixture(fixtures, sources, n_sets), n_sets, "auto"
    )
    want = _jax_g(jax_sources.JsonlSource(root), n_sets, "auto")
    assert np.array_equal(disk.g.numpy(), mem.g.numpy())
    assert np.array_equal(disk.g.numpy(), want)
    assert disk_result == mem_result
    if n_sets == 2:
        # Twin sets: every sample's coordinates equal its twin's.
        by_name = {}
        for cid, pc1, pc2 in disk_result:
            by_name.setdefault(cid.split("-", 1)[1], []).append((pc1, pc2))
        for coords in by_name.values():
            np.testing.assert_allclose(coords[0], coords[1], atol=1e-6)
