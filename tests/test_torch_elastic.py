"""The port's elastic checkpoints against the JAX package's.

The twins of ``tests/test_elastic.py``, each on the port and held to the
JAX package in one process:

- the lane protocol (``utils/elastic.py``): units, lanes, the subset and
  partial-overlap rules, supersede, prune, the fingerprint, the lazy
  payload, under random crash interleavings; a lane file is the JAX
  package's key for key and dtype for dtype (its members stored where the
  JAX package deflates them), and each package's loader reads the other's
  lanes;
- the driver: an elastic G, after any crash point and resume, single or
  multi-dataset, over HTTP, is bit-identical to the uncheckpointed G and
  to the JAX package's; each package resumes a run the other left half
  done;
- process groups of gloo ranks: a four-rank run loses a rank for good,
  the others fail-stop, and a two-rank relaunch claims every lane and
  re-executes only the lost rank's unit (G bit-identical); a checkpoint
  directory the ranks do not share is caught before any ingest.
"""

import os
import socket
import subprocess
import sys
import textwrap
import zipfile

import numpy as np
import pytest
import torch

from spark_examples_tpu.genomics.fixtures import (
    synthetic_cohort as jax_synthetic_cohort,
)
from spark_examples_tpu.genomics.sources import (
    FixtureSource as JaxFixtureSource,
)
from spark_examples_tpu.models.pca import VariantsPcaDriver as JaxDriver
from spark_examples_tpu.utils import elastic as jax_elastic
from spark_examples_tpu.utils.config import PcaConfig as JaxConfig
from spark_examples_tpu_torch.genomics.fixtures import (
    DEFAULT_VARIANT_SET_ID,
    synthetic_cohort,
)
from spark_examples_tpu_torch.genomics.shards import (
    manifest_digest,
    shards_for_references,
)
from spark_examples_tpu_torch.genomics.sources import FixtureSource
from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
from spark_examples_tpu_torch.resilience import faults
from spark_examples_tpu_torch.resilience.faults import FaultPlan, FaultRule
from spark_examples_tpu_torch.utils import elastic
from spark_examples_tpu_torch.utils.config import PcaConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFS = "17:41196311:41277499"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- units --------------------------------------------------------------------


@pytest.mark.parametrize(
    "n,every", [(6, 2), (5, 2), (2, 0), (0, 4), (7, 3)],
    ids=["exact", "ragged", "clamped", "empty", "three"],
)
def test_unit_ranges_are_the_jax_packages(n, every):
    assert elastic.unit_ranges(n, every) == jax_elastic.unit_ranges(n, every)
    want = {(6, 2): [(0, 2), (2, 4), (4, 6)], (5, 2): [(0, 2), (2, 4), (4, 5)],
            (2, 0): [(0, 1), (1, 2)], (0, 4): []}
    if (n, every) in want:
        assert elastic.unit_ranges(n, every) == want[(n, every)]


class _S:
    def __init__(self, contig):
        self.contig = contig


@pytest.mark.parametrize(
    "contigs,every,want",
    [
        (("1", "1", "2", "2", "3"), 4, [(0, 4), (4, 5)]),
        (("1", "1", "1", "2"), 2, [(0, 3), (3, 4)]),
        (("17",) * 5, 2, [(0, 5)]),
        ((), 2, []),
    ],
    ids=["packs", "never-splits", "single-contig", "empty"],
)
def test_contig_aligned_units(contigs, every, want):
    shards = [_S(c) for c in contigs]
    assert elastic.unit_ranges_contig_aligned(shards, every) == want
    assert jax_elastic.unit_ranges_contig_aligned(shards, every) == want


# -- lanes --------------------------------------------------------------------


class TestLanes:
    def test_roundtrip(self, tmp_path):
        g = np.arange(9.0, dtype=np.float32).reshape(3, 3)
        elastic.save_lane(str(tmp_path), g, [2, 0], "d1")
        lanes = elastic.load_lanes(str(tmp_path), "d1", 3)
        assert len(lanes) == 1
        assert lanes[0].units == frozenset({0, 2})
        np.testing.assert_array_equal(lanes[0].load_g(), g)

    def test_a_tensor_is_saved_from_the_host(self, tmp_path):
        g = torch.arange(16, dtype=torch.float32).reshape(4, 4)
        elastic.save_lane(str(tmp_path), g, [0], "t")
        (lane,) = elastic.load_lanes(str(tmp_path), "t", 4)
        np.testing.assert_array_equal(lane.load_g(), g.numpy())

    def test_digest_and_shape_mismatch_ignored(self, tmp_path):
        elastic.save_lane(str(tmp_path), np.zeros((3, 3)), [0], "d1")
        assert elastic.load_lanes(str(tmp_path), "other", 3) == []
        assert elastic.load_lanes(str(tmp_path), "d1", 4) == []

    def test_absent_dir(self, tmp_path):
        assert elastic.load_lanes(str(tmp_path / "nope"), "d", 3) == []

    def test_subset_discarded(self, tmp_path):
        g1 = np.ones((2, 2), np.float32)
        elastic.save_lane(str(tmp_path), g1, [0], "d")
        elastic.save_lane(str(tmp_path), g1, [1], "d")
        elastic.save_lane(str(tmp_path), 3 * g1, [0, 1], "d")  # merged
        lanes = elastic.load_lanes(str(tmp_path), "d", 2)
        assert len(lanes) == 1
        assert lanes[0].units == frozenset({0, 1})
        np.testing.assert_array_equal(lanes[0].load_g(), 3 * g1)

    def test_partial_overlap_discarded_with_warning(self, tmp_path, capsys):
        g = np.ones((2, 2), np.float32)
        elastic.save_lane(str(tmp_path), g, [0, 1], "d")
        elastic.save_lane(str(tmp_path), g, [1, 2], "d")
        assert len(elastic.load_lanes(str(tmp_path), "d", 2)) == 1
        assert "partially overlaps" in capsys.readouterr().err

    def test_unreadable_lane_ignored(self, tmp_path, capsys):
        (tmp_path / "lane-deadbeef.npz").write_bytes(b"not a zip")
        elastic.save_lane(str(tmp_path), np.zeros((2, 2)), [0], "d")
        assert len(elastic.load_lanes(str(tmp_path), "d", 2)) == 1
        assert "unreadable" in capsys.readouterr().err

    def test_merge_supersede_deletes_old(self, tmp_path):
        g = np.ones((2, 2), np.float32)
        p1 = elastic.save_lane(str(tmp_path), g, [0], "d")
        p2 = elastic.save_lane(str(tmp_path), g, [1], "d")
        merged = elastic.merge_and_supersede(
            str(tmp_path), 2 * g, [0, 1], "d", [p1, p2]
        )
        assert os.path.exists(merged)
        assert not os.path.exists(p1) and not os.path.exists(p2)
        lanes = elastic.load_lanes(str(tmp_path), "d", 2)
        assert len(lanes) == 1 and lanes[0].units == frozenset({0, 1})

    def test_prune_stale_lanes(self, tmp_path):
        g = np.ones((2, 2), np.float32)
        old = elastic.save_lane(str(tmp_path), g, [0], "old-digest")
        sub = elastic.save_lane(str(tmp_path), g, [1], "d")
        live = elastic.save_lane(str(tmp_path), 2 * g, [1, 2], "d")
        bad = tmp_path / "lane-ffff.npz"
        bad.write_bytes(b"garbage")
        kept = elastic.load_lanes(str(tmp_path), "d", 2)
        assert elastic.prune_stale_lanes(str(tmp_path), "d", kept) == 2
        assert not os.path.exists(old) and not os.path.exists(sub)
        assert os.path.exists(live)
        assert bad.exists()  # unreadable files stay as evidence

    def test_prune_tmp_orphans_age_gated(self, tmp_path):
        stale = tmp_path / "tmpabc123.npz.tmp"
        stale.write_bytes(b"half-written")
        os.utime(stale, (1, 1))
        fresh = tmp_path / "tmpdef456.npz.tmp"
        fresh.write_bytes(b"in flight")
        assert elastic.prune_stale_lanes(str(tmp_path), "d", []) == 1
        assert not stale.exists() and fresh.exists()

    def test_corrupt_payload_detected_lazily(self, tmp_path):
        """The metadata members read fine and the g member is corrupt: the
        lane lists (a lazy load) and only ``load_g`` raises. The port
        stores g, so its bytes are corrupted in place."""
        g = np.random.default_rng(0).random((64, 64)).astype(np.float32)
        path = elastic.save_lane(str(tmp_path), g, [0], "d")
        data = bytearray(open(path, "rb").read())
        i = data.find(b"g.npy")
        assert i > 0
        for off in range(i + 60, i + 90):
            data[off] ^= 0xFF
        open(path, "wb").write(bytes(data))
        lanes = elastic.load_lanes(str(tmp_path), "d", 64)
        assert len(lanes) == 1
        with pytest.raises(Exception):
            lanes[0].load_g()

    def test_lane_without_g_shape_still_loads(self, tmp_path):
        import tempfile

        g = np.ones((3, 3), np.float32)
        fd, tmp = tempfile.mkstemp(dir=str(tmp_path), suffix=".npz.tmp")
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, g=g, units=np.asarray([1], np.int64),
                                run_digest=np.bytes_(b"d"))
        os.replace(tmp, str(tmp_path / "lane-oldformat.npz"))
        for loader in (elastic.load_lanes, jax_elastic.load_lanes):
            (lane,) = loader(str(tmp_path), "d", 3)
            assert lane.units == frozenset({1})
            np.testing.assert_array_equal(lane.load_g(), g)

    def test_fingerprint_is_the_jax_packages(self, tmp_path):
        g = np.zeros((2, 2))
        elastic.save_lane(str(tmp_path), g, [0], "d")
        elastic.save_lane(str(tmp_path), g, [1], "d")
        lanes = elastic.load_lanes(str(tmp_path), "d", 2)
        fp = elastic.lane_view_fingerprint(lanes)
        assert fp == elastic.lane_view_fingerprint(list(reversed(lanes)))
        assert fp == jax_elastic.lane_view_fingerprint(
            jax_elastic.load_lanes(str(tmp_path), "d", 2))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_lanes(writer, tmp_path):
    """The lane file's keys and dtypes are the JAX package's; the port
    stores its members where the JAX package deflates them, and either
    loader reads either file."""
    g = np.arange(16, dtype=np.float32).reshape(4, 4)
    save = elastic.save_lane if writer == "port" else jax_elastic.save_lane
    path = save(str(tmp_path), g, [3, 1], "digest|x")
    with zipfile.ZipFile(path) as z:
        members = {i.filename: i.compress_type for i in z.infolist()}
    assert set(members) == {"g.npy", "g_shape.npy", "units.npy",
                            "run_digest.npy"}
    want_type = zipfile.ZIP_STORED if writer == "port" else (
        zipfile.ZIP_DEFLATED)
    assert set(members.values()) == {want_type}
    with np.load(path) as z:
        assert z["g"].dtype == np.float32
        assert z["units"].dtype == np.int64
        assert z["g_shape"].tolist() == [4, 4]
    for loader in (elastic.load_lanes, jax_elastic.load_lanes):
        (lane,) = loader(str(tmp_path), "digest|x", 4)
        assert lane.units == frozenset({1, 3})
        np.testing.assert_array_equal(lane.load_g(), g)


@pytest.mark.parametrize("kind", ["torn", "error"])
def test_lane_write_fault_site(kind, tmp_path, capsys):
    """``checkpoint.lane_write``: a torn lane is discarded with a warning
    (its units re-execute); an error raises at the commit."""
    plan = FaultPlan(
        rules=[FaultRule(site="checkpoint.lane_write", kind=kind)])
    with faults.active_plan(plan):
        if kind == "error":
            with pytest.raises(faults.InjectedFault):
                elastic.save_lane(str(tmp_path), np.ones((2, 2)), [0], "d")
            return
        elastic.save_lane(str(tmp_path), np.ones((2, 2)), [0], "d")
    assert elastic.load_lanes(str(tmp_path), "d", 2) == []
    assert "unreadable" in capsys.readouterr().err


def test_lane_supersede_fault_leaves_subset_lanes(tmp_path):
    """``checkpoint.lane_supersede``: a crash between the merged lane's
    write and the deletions leaves the subsets, which the loader
    discards."""
    g = np.ones((2, 2), np.float32)
    p1 = elastic.save_lane(str(tmp_path), g, [0], "d")
    plan = FaultPlan(rules=[FaultRule(site="checkpoint.lane_supersede")])
    with faults.active_plan(plan):
        elastic.merge_and_supersede(str(tmp_path), 2 * g, [0, 1], "d", [p1])
    assert os.path.exists(p1)
    (lane,) = elastic.load_lanes(str(tmp_path), "d", 2)
    assert lane.units == frozenset({0, 1})


def test_random_crash_interleavings(tmp_path):
    """Under any interleaving of unit completions, merges and crashes
    (the supersede deletions applied fully, in part or not at all), the
    lanes left are disjoint, each payload is exactly its units' sum, and
    completing the uncovered units rebuilds the whole: the JAX package's
    property, on the port's lanes."""
    pytest.importorskip("hypothesis")
    import shutil
    import tempfile

    from hypothesis import given, settings, strategies as st

    n_units = 6

    def unit_vec(u):
        g = np.zeros((n_units, 1), np.float32)
        g[u, 0] = 1.0
        return g

    proc = st.tuples(st.integers(0, n_units), st.integers(0, 2))

    @settings(max_examples=40, deadline=None)
    @given(scenarios=st.lists(proc, min_size=1, max_size=3), data=st.data())
    def run(scenarios, data):
        d = tempfile.mkdtemp(dir=str(tmp_path))
        try:
            world = len(scenarios)
            for p, (completed, crash_mode) in enumerate(scenarios):
                mine = list(range(n_units))[p::world]
                covered, own = [], []
                g = np.zeros((n_units, 1), np.float32)
                for u in mine[: min(completed, len(mine))]:
                    covered.append(u)
                    g = g + unit_vec(u)
                    new = elastic.save_lane(d, g, covered, "dig")
                    if crash_mode == 0:
                        for old in own:
                            os.remove(old)
                        own = [new]
                    elif crash_mode == 1 and own:
                        keep = data.draw(st.integers(0, len(own) - 1))
                        for i, old in enumerate(own):
                            if i != keep:
                                os.remove(old)
                        own = [own[keep], new]
                    else:
                        own = own + [new]
            lanes = elastic.load_lanes(d, "dig", n_units)
            assert [lane.units for lane in lanes] == [
                lane.units for lane in jax_elastic.load_lanes(d, "dig",
                                                              n_units)]
            seen = set()
            total = np.zeros((n_units, 1), np.float32)
            for lane in lanes:
                assert lane.units.isdisjoint(seen)
                seen |= lane.units
                payload = lane.load_g()
                want = np.zeros((n_units, 1), np.float32)
                for u in lane.units:
                    want += unit_vec(u)
                np.testing.assert_array_equal(payload, want)
                total += payload
            for u in range(n_units):
                if u not in seen:
                    total += unit_vec(u)
            np.testing.assert_array_equal(
                total, np.ones((n_units, 1), np.float32))
        finally:
            shutil.rmtree(d, ignore_errors=True)

    run()


# -- the driver ---------------------------------------------------------------


def _settings(tmp_path, **kw):
    base = dict(
        variant_set_ids=[DEFAULT_VARIANT_SET_ID],
        bases_per_partition=20_000,  # BRCA1 region → 5 shards
        block_variants=64,
        checkpoint_dir=str(tmp_path / "ck"),
        checkpoint_every=2,  # → 3 units: [0,2) [2,4) [4,5)
        elastic_checkpoint=True,
    )
    base.update(kw)
    return base


def _conf(tmp_path, **kw):
    return PcaConfig(device="cpu", **_settings(tmp_path, **kw))


def _jax_conf(tmp_path, **kw):
    return JaxConfig(**_settings(tmp_path, **kw))


_PLAIN = {}


def _plain_gramian(n=12, v=100):
    """The uncheckpointed G, the same in both packages (asserted)."""
    if (n, v) not in _PLAIN:
        kw = dict(variant_set_ids=[DEFAULT_VARIANT_SET_ID],
                  bases_per_partition=20_000, block_variants=64)
        port = VariantsPcaDriver(PcaConfig(device="cpu", **kw),
                                 synthetic_cohort(n, v))
        g = port.ingest_gramian().numpy()
        jax_g = JaxDriver(JaxConfig(**kw),
                          jax_synthetic_cohort(n, v)).ingest_gramian()
        np.testing.assert_array_equal(g, np.asarray(jax_g))
        _PLAIN[(n, v)] = g
    return _PLAIN[(n, v)]


def _elastic_g(conf, src):
    return VariantsPcaDriver(conf, src).get_similarity_matrix_checkpointed()


def test_requires_checkpoint_dir():
    conf = PcaConfig(variant_set_ids=[DEFAULT_VARIANT_SET_ID],
                     elastic_checkpoint=True, device="cpu")
    with pytest.raises(ValueError, match="--checkpoint-dir"):
        VariantsPcaDriver(conf, synthetic_cohort(4, 10))


def test_multi_dataset_needs_keyed_source(tmp_path):
    class Bare:
        def __init__(self, inner):
            self._inner = inner
            self.stats = inner.stats

        def list_callsets(self, vsid):
            return self._inner.list_callsets(vsid)

        def stream_variants(self, vsid, shard):
            return self._inner.stream_variants(vsid, shard)

    conf = PcaConfig(variant_set_ids=[DEFAULT_VARIANT_SET_ID, "other"],
                     checkpoint_dir=str(tmp_path), elastic_checkpoint=True,
                     device="cpu")
    driver = VariantsPcaDriver(conf, Bare(synthetic_cohort(4, 10)))
    with pytest.raises(ValueError, match="stream_carrying_keyed"):
        driver.get_similarity_matrix_checkpointed()


def test_a_pod_refuses_elastic(tmp_path, monkeypatch):
    driver = VariantsPcaDriver(_conf(tmp_path), synthetic_cohort(12, 100))
    monkeypatch.setattr(driver, "_mesh_spans_processes", lambda: True)
    with pytest.raises(ValueError, match="host-local"):
        driver.get_similarity_matrix_checkpointed()


class TestElasticPipeline:
    def test_matches_plain_and_jax(self, tmp_path):
        g = _elastic_g(_conf(tmp_path), synthetic_cohort(12, 100))
        np.testing.assert_array_equal(g.numpy(), _plain_gramian())
        want = JaxDriver(_jax_conf(tmp_path / "j"), jax_synthetic_cohort(
            12, 100)).get_similarity_matrix_checkpointed()
        np.testing.assert_array_equal(g.numpy(), np.asarray(want))

    def test_resume_skips_covered_units(self, tmp_path):
        conf = _conf(tmp_path)
        g1 = _elastic_g(conf, synthetic_cohort(12, 100))
        src2 = synthetic_cohort(12, 100)
        g2 = _elastic_g(conf, src2)
        assert src2.stats.partitions == 0
        np.testing.assert_array_equal(g1.numpy(), g2.numpy())

    def test_resume_after_failure_matches_plain(self, tmp_path):
        conf = _conf(tmp_path)
        shards = shards_for_references(conf.references, 20_000)
        src = synthetic_cohort(12, 100)
        src._fail_once.add(shards[3])  # inside unit 1 ([2,4))
        with pytest.raises(IOError):
            _elastic_g(conf, src)
        assert len(os.listdir(os.path.join(conf.checkpoint_dir,
                                           "elastic"))) == 1
        src2 = synthetic_cohort(12, 100)
        g = _elastic_g(conf, src2)
        assert src2.stats.partitions == 3
        np.testing.assert_array_equal(g.numpy(), _plain_gramian())

    def test_changed_round_width_invalidates(self, tmp_path):
        _elastic_g(_conf(tmp_path), synthetic_cohort(12, 100))
        conf2 = _conf(tmp_path, checkpoint_every=3)
        src = synthetic_cohort(12, 100)
        g = _elastic_g(conf2, src)
        assert src.stats.partitions == 5
        np.testing.assert_array_equal(g.numpy(), _plain_gramian())
        lanes = [f for f in os.listdir(os.path.join(conf2.checkpoint_dir,
                                                    "elastic"))
                 if f.startswith("lane-")]
        assert len(lanes) == 1

    def test_corrupt_claimed_lane_reexecuted(self, tmp_path, monkeypatch,
                                             capsys):
        conf = _conf(tmp_path)
        _elastic_g(conf, synthetic_cohort(12, 100))

        def boom(self):
            raise zipfile.BadZipFile("Bad CRC-32 for file 'g.npy'")

        monkeypatch.setattr(elastic.Lane, "load_g", boom)
        src = synthetic_cohort(12, 100)
        g = _elastic_g(conf, src)
        monkeypatch.undo()
        assert src.stats.partitions == 5
        np.testing.assert_array_equal(g.numpy(), _plain_gramian())
        assert "unreadable" in capsys.readouterr().err

    def test_full_driver_run_elastic(self, tmp_path):
        result = VariantsPcaDriver(
            _conf(tmp_path), synthetic_cohort(15, 120)
        ).run()
        want = JaxDriver(_jax_conf(tmp_path / "j"),
                         jax_synthetic_cohort(15, 120)).run()
        plain = VariantsPcaDriver(
            PcaConfig(variant_set_ids=[DEFAULT_VARIANT_SET_ID],
                      block_variants=64, device="cpu"),
            synthetic_cohort(15, 120),
        ).run()
        for other in (want, plain):
            np.testing.assert_allclose(
                np.array([r[1:] for r in result]),
                np.array([r[1:] for r in other]), atol=1e-4)


@pytest.mark.parametrize("fail_shard", [0, 1, 2, 3, 4])
def test_resume_bit_equal_from_any_crash_point(tmp_path, fail_shard):
    conf = _conf(tmp_path, checkpoint_every=1)
    shards = shards_for_references(conf.references, 20_000)
    src = synthetic_cohort(12, 100)
    src._fail_once.add(shards[fail_shard])
    with pytest.raises(IOError):
        _elastic_g(conf, src)
    src2 = synthetic_cohort(12, 100)
    g = _elastic_g(conf, src2)
    assert src2.stats.partitions == len(shards) - fail_shard
    np.testing.assert_array_equal(g.numpy(), _plain_gramian())


@pytest.mark.parametrize("first", ["port", "jax"])
def test_each_package_resumes_the_other(first, tmp_path):
    """A run of one package fails in unit 1; the other package resumes its
    lane, re-ingests units 1 and 2 and lands on the plain G."""
    shards = shards_for_references(REFS, 20_000)
    if first == "port":
        src = synthetic_cohort(12, 100)
        src._fail_once.add(shards[3])
        with pytest.raises(IOError):
            _elastic_g(_conf(tmp_path), src)
        src2 = jax_synthetic_cohort(12, 100)
        g = np.asarray(JaxDriver(_jax_conf(tmp_path), src2)
                       .get_similarity_matrix_checkpointed())
    else:
        src = jax_synthetic_cohort(12, 100)
        src._fail_once.add(shards[3])
        with pytest.raises(IOError):
            JaxDriver(_jax_conf(tmp_path),
                      src).get_similarity_matrix_checkpointed()
        src2 = synthetic_cohort(12, 100)
        g = _elastic_g(_conf(tmp_path), src2).numpy()
    assert src2.stats.partitions == 3
    np.testing.assert_array_equal(g, _plain_gramian())


# -- multi-dataset units ------------------------------------------------------

MULTI_REFS = "17:41196311:41236311,20:100000:140000"  # 2 contigs, 4 shards


def _merged(pkg="port"):
    make, source = ((synthetic_cohort, FixtureSource) if pkg == "port"
                    else (jax_synthetic_cohort, JaxFixtureSource))
    a = make(8, 60, references=MULTI_REFS, variant_set_id="setA", seed=1)
    b = make(8, 60, references=MULTI_REFS, variant_set_id="setB", seed=1)
    return source(variants=a._variants + b._variants,
                  callsets=a._callsets + b._callsets)


def _multi_conf(tmp_path, **kw):
    kw.setdefault("references", MULTI_REFS)
    kw.setdefault("variant_set_ids", ["setA", "setB"])
    return _conf(tmp_path, **kw)


def _plain_join_gramian():
    kw = dict(variant_set_ids=["setA", "setB"], references=MULTI_REFS,
              bases_per_partition=20_000, block_variants=64)
    driver = VariantsPcaDriver(PcaConfig(device="cpu", **kw), _merged())
    g = driver.get_similarity_matrix(driver.get_calls_fused_multi()).numpy()
    jax_driver = JaxDriver(JaxConfig(**kw), _merged("jax"))
    np.testing.assert_array_equal(g, np.asarray(
        jax_driver.get_similarity_matrix(
            jax_driver.get_calls_fused_multi())))
    return g


class TestElasticMultiDataset:
    def test_matches_plain_join_and_jax(self, tmp_path):
        g = _elastic_g(_multi_conf(tmp_path), _merged())
        np.testing.assert_array_equal(g.numpy(), _plain_join_gramian())
        jax_conf = JaxConfig(**_settings(
            tmp_path / "j", references=MULTI_REFS,
            variant_set_ids=["setA", "setB"]))
        want = JaxDriver(jax_conf, _merged("jax"))\
            .get_similarity_matrix_checkpointed()
        np.testing.assert_array_equal(g.numpy(), np.asarray(want))

    def test_crash_and_resume_bit_equal(self, tmp_path):
        conf = _multi_conf(tmp_path)
        shards = conf.shards()
        assert len(shards) == 4
        src = _merged()
        src._fail_once.add(shards[2])
        with pytest.raises(IOError):
            _elastic_g(conf, src)
        src2 = _merged()
        g = _elastic_g(conf, src2)
        assert src2.stats.partitions == 4  # 2 shards × 2 dataset streams
        np.testing.assert_array_equal(g.numpy(), _plain_join_gramian())

    def test_resume_skips_everything_when_done(self, tmp_path):
        conf = _multi_conf(tmp_path)
        _elastic_g(conf, _merged())
        src = _merged()
        _elastic_g(conf, src)
        assert src.stats.partitions == 0

    def test_nonunique_contig_runs_rejected(self, tmp_path):
        conf = _multi_conf(
            tmp_path,
            references="17:41196311:41216311,20:100000:120000,"
            "17:41216311:41236311",
        )
        with pytest.raises(ValueError, match="contiguous manifest run"):
            _elastic_g(conf, _merged())

    def test_full_driver_run(self, tmp_path):
        result = VariantsPcaDriver(_multi_conf(tmp_path), _merged()).run()
        assert len(result) == 16
        assert {r[0].split("-")[0] for r in result} == {"setA", "setB"}
        jax_conf = JaxConfig(**_settings(
            tmp_path / "j", references=MULTI_REFS,
            variant_set_ids=["setA", "setB"]))
        want = JaxDriver(jax_conf, _merged("jax")).run()
        np.testing.assert_allclose(np.array([r[1:] for r in result]),
                                   np.array([r[1:] for r in want]),
                                   atol=1e-4)


def test_server_outage_then_resume(tmp_path):
    """Elastic checkpoints over HTTP: the server dies mid-run, the units
    done are lanes, and a fresh server and client fetch only the rest; G
    is the plain G."""
    from spark_examples_tpu_torch.genomics.service import (
        GenomicsServiceServer,
        HttpVariantSource,
    )

    cohort = synthetic_cohort(12, 100)
    server = GenomicsServiceServer(cohort).start()

    class DiesBeforeShard(HttpVariantSource):
        def __init__(self, url, die_at):
            super().__init__(url)
            self._die_at, self._seen = die_at, 0

        def _tick(self):
            self._seen += 1
            if self._seen == self._die_at:
                server.stop()

        def stream_carrying(self, vsid, shard, indexes, min_af):
            self._tick()
            yield from super().stream_carrying(vsid, shard, indexes, min_af)

        def stream_carrying_csr(self, vsid, shard, indexes, min_af):
            self._tick()
            return super().stream_carrying_csr(vsid, shard, indexes, min_af)

    conf = _conf(tmp_path, checkpoint_every=1, ingest_workers=1)
    with pytest.raises(IOError):
        _elastic_g(conf, DiesBeforeShard(
            f"http://127.0.0.1:{server.port}", die_at=4))
    assert len(os.listdir(os.path.join(conf.checkpoint_dir, "elastic"))) >= 1
    server2 = GenomicsServiceServer(cohort).start()
    try:
        http = HttpVariantSource(f"http://127.0.0.1:{server2.port}")
        g = _elastic_g(conf, http)
        assert http.stats.partitions == 2
    finally:
        server2.stop()
    np.testing.assert_array_equal(g.numpy(), _plain_gramian())


# -- process groups: gloo ranks -----------------------------------------------


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(script, argv, n, timeout=120):
    env = {**os.environ, "PYTHONPATH": ROOT, "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(_free_port()), "WORLD_SIZE": str(n)}
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), *map(str, argv)],
            env={**env, "RANK": str(i), "LOCAL_RANK": str(i)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for i in range(n)
    ]
    try:
        logs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [p.returncode for p in procs], logs


_SHRINK_WORKER = textwrap.dedent(
    """
    import json, os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from spark_examples_tpu_torch.parallel import distributed
    assert distributed.initialize_from_env("cpu")
    from spark_examples_tpu_torch.genomics.fixtures import (
        DEFAULT_VARIANT_SET_ID, synthetic_cohort)
    from spark_examples_tpu_torch.genomics.shards import (
        shards_for_references)
    from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
    from spark_examples_tpu_torch.utils.config import PcaConfig

    ck, phase = sys.argv[1], sys.argv[2]
    pid = distributed.process_index()
    conf = PcaConfig(
        variant_set_ids=[DEFAULT_VARIANT_SET_ID], bases_per_partition=20_000,
        block_variants=32, checkpoint_dir=ck, checkpoint_every=1,
        elastic_checkpoint=True, collective_timeout=8.0, device="cpu")
    source = synthetic_cohort(10, 80, seed=5)
    if phase == "die" and pid == 3:
        # A permanent death mid-ingest: rank 3's only unit is unit 3.
        shards = shards_for_references(conf.references, 20_000)
        orig = source._shard_items
        def dying(shard):
            if shard == shards[3]:
                os._exit(13)
            return orig(shard)
        source._shard_items = dying
    g = VariantsPcaDriver(conf, source).get_similarity_matrix_checkpointed()
    with open(os.path.join(ck, f"result-{pid}.json"), "w") as f:
        json.dump({"g": g.numpy().tolist(),
                   "partitions": source.stats.partitions}, f)
    """
)


def _drill_digest():
    shards = shards_for_references(REFS, 20_000)
    return (f"{manifest_digest(shards)}|{DEFAULT_VARIANT_SET_ID}"
            f"|af=None|every=1|elastic")


def test_elastic_shrink_world_resume(tmp_path):
    """Four ranks; rank 3 dies for good in its unit; the others fail-stop
    (the collective watchdog) instead of hanging; a relaunch at TWO ranks
    claims every lane and re-executes only unit 3. G, summed over the two
    ranks, is the uninterrupted G bit for bit, and the JAX package's
    loader reads the lanes under the JAX digest."""
    import json

    script = tmp_path / "worker.py"
    script.write_text(_SHRINK_WORKER)
    ck = tmp_path / "ck"
    codes, logs = _spawn(script, [ck, "die"], 4)
    assert codes[3] == 13, logs[3][-1500:]
    assert all(c not in (0, None) for c in codes[:3]), [
        log[-800:] for log in logs]
    covered = set()
    for lane in jax_elastic.load_lanes(str(ck / "elastic"), _drill_digest(),
                                       10):
        covered |= lane.units
    assert covered == {0, 1, 2, 4}
    codes, logs = _spawn(script, [ck, "resume"], 2)
    assert codes == [0, 0], [log[-1500:] for log in logs]
    results = [json.loads((ck / f"result-{r}.json").read_text())
               for r in range(2)]
    assert sum(r["partitions"] for r in results) == 1  # unit 3 alone
    assert "Elastic resume: 4/5 units" in logs[0]
    kw = dict(variant_set_ids=[DEFAULT_VARIANT_SET_ID],
              bases_per_partition=20_000, block_variants=32)
    g_plain = VariantsPcaDriver(PcaConfig(device="cpu", **kw),
                                synthetic_cohort(10, 80, seed=5))\
        .ingest_gramian().numpy()
    for r in results:
        np.testing.assert_array_equal(np.asarray(r["g"], np.float32),
                                      g_plain)


_UNSHARED_WORKER = textwrap.dedent(
    """
    import os, sys
    import torch
    torch.set_num_threads(1)
    from spark_examples_tpu_torch.parallel import distributed
    assert distributed.initialize_from_env("cpu")
    from spark_examples_tpu_torch.genomics.fixtures import (
        DEFAULT_VARIANT_SET_ID, synthetic_cohort)
    from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
    from spark_examples_tpu_torch.utils.config import PcaConfig

    # Each rank its OWN directory: the misconfiguration the write probe
    # must catch before any ingest.
    conf = PcaConfig(
        variant_set_ids=[DEFAULT_VARIANT_SET_ID], bases_per_partition=20_000,
        block_variants=32,
        checkpoint_dir=sys.argv[1] + f"-{distributed.process_index()}",
        checkpoint_every=1, elastic_checkpoint=True,
        collective_timeout=30.0, device="cpu")
    source = synthetic_cohort(10, 80, seed=5)
    try:
        VariantsPcaDriver(conf, source).get_similarity_matrix_checkpointed()
    except RuntimeError as e:
        assert "probe" in str(e), e
        assert source.stats.partitions == 0
        os._exit(21)
    os._exit(0)
    """
)


def test_elastic_unshared_dir_detected_before_work(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_UNSHARED_WORKER)
    codes, logs = _spawn(script, [tmp_path / "ck"], 2)
    assert codes == [21, 21], [log[-1500:] for log in logs]
