"""Checkpointed ingest of the port against the JAX package.

The cases of the JAX package's ``tests/test_checkpoint.py`` (snapshot
round trip, checkpointed vs plain, resume skipping completed shards,
resume after a failure in the second group), its torn-snapshot cases
(``tests/test_resilience.py``), the checkpointed CSR route at several
worker counts (``tests/test_parallel_ingest.py``) and the ``sparse``
refusal (``tests/test_sparse_gramian.py``), each on the port and held to
the JAX package in one process:

- G of a checkpointed run, and of a run killed in its second group and
  resumed, is bit-identical to the uncheckpointed port run and to the JAX
  package's G; the tests count the shards ingested after the resume;
- the snapshot file is the JAX package's, key for key and dtype for
  dtype, and each package resumes from the other's snapshot with an equal
  run digest;
- coordinates of the checkpointed ``pca`` are within 1e-4 of the JAX
  package's.
"""

import os
import zipfile

import numpy as np
import pytest
import torch

from spark_examples_tpu.genomics.fixtures import (
    synthetic_cohort as jax_synthetic_cohort,
)
from spark_examples_tpu.genomics.sources import JsonlSource as JaxJsonl
from spark_examples_tpu.models.pca import VariantsPcaDriver as JaxDriver
from spark_examples_tpu.resilience import faults as jax_faults
from spark_examples_tpu.utils import checkpoint as jax_checkpoint
from spark_examples_tpu.utils.config import PcaConfig as JaxConfig
from spark_examples_tpu_torch.genomics.fixtures import (
    DEFAULT_VARIANT_SET_ID,
    synthetic_cohort,
)
from spark_examples_tpu_torch.genomics.shards import (
    manifest_digest,
    shards_for_references,
)
from spark_examples_tpu_torch.genomics.sources import JsonlSource
from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
from spark_examples_tpu_torch.resilience import faults
from spark_examples_tpu_torch.resilience.faults import FaultPlan, FaultRule
from spark_examples_tpu_torch.utils import checkpoint
from spark_examples_tpu_torch.utils.checkpoint import (
    load_snapshot,
    save_snapshot,
)
from spark_examples_tpu_torch.utils.config import PcaConfig

COORD_TOL = 1e-4
REFS = "17:41196311:41277499"
SNAP = "gramian_snapshot.npz"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _settings(tmp_path, **kw):
    settings = dict(
        variant_set_ids=[DEFAULT_VARIANT_SET_ID],
        bases_per_partition=20_000,  # BRCA1 region → 5 shards
        block_variants=64,
        checkpoint_dir=str(tmp_path / "ck"),
        checkpoint_every=2,
    )
    settings.update(kw)
    return settings


def _port(settings):
    return PcaConfig(device="cpu", **settings)


def _plain(settings):
    return {
        k: v for k, v in settings.items()
        if k not in ("checkpoint_dir", "checkpoint_every")
    }


def _host(g):
    return g.cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)


def _coords(result):
    return np.array([[pc1, pc2] for _, pc1, pc2 in result])


def _digest(settings, vsid=DEFAULT_VARIANT_SET_ID, af=None):
    shards = shards_for_references(
        settings.get("references", PcaConfig.references),
        settings["bases_per_partition"],
    )
    return f"{manifest_digest(shards)}|{vsid}|af={af}"


class TestSnapshotRoundTrip:
    def test_save_load(self, tmp_path):
        g = np.arange(9.0).reshape(3, 3)
        save_snapshot(str(tmp_path), g, shards_done=4, run_digest="abc")
        ck = load_snapshot(str(tmp_path), "abc", 3)
        assert ck is not None and ck.shards_done == 4
        np.testing.assert_array_equal(ck.g, g)

    def test_digest_mismatch_ignored(self, tmp_path):
        save_snapshot(str(tmp_path), np.zeros((2, 2)), 1, "abc")
        assert load_snapshot(str(tmp_path), "other", 2) is None
        assert load_snapshot(str(tmp_path), "abc", 5) is None

    def test_absent_dir(self, tmp_path):
        assert load_snapshot(str(tmp_path / "nope"), "x", 2) is None

    def test_a_tensor_is_saved_from_the_host(self, tmp_path):
        g = torch.arange(16, dtype=torch.float32).reshape(4, 4)
        save_snapshot(str(tmp_path), g, 2, "t")
        ck = load_snapshot(str(tmp_path), "t", 4)
        assert ck.g.dtype == np.float32
        np.testing.assert_array_equal(ck.g, g.numpy())

    def test_unreadable_snapshot_warns_and_is_discarded(
            self, tmp_path, capsys):
        save_snapshot(str(tmp_path), np.ones((3, 3), np.float32), 1, "d")
        path = tmp_path / SNAP
        path.write_bytes(path.read_bytes()[:20])
        assert load_snapshot(str(tmp_path), "d", 3) is None
        assert "unreadable Gramian snapshot" in capsys.readouterr().err


class TestSnapshotFormat:
    """The file the JAX package writes from its driver's G, key for key
    and dtype for dtype, and the port's from its own."""

    @pytest.fixture(scope="class")
    def pair(self, tmp_path_factory):
        tmp = tmp_path_factory.mktemp("fmt")
        settings = _settings(tmp)
        out = {}
        for name, drv in (
            ("jax", JaxDriver(
                JaxConfig(**{**settings, "checkpoint_dir": str(tmp / "j")}),
                jax_synthetic_cohort(12, 100))),
            ("port", VariantsPcaDriver(
                _port({**settings, "checkpoint_dir": str(tmp / "p")}),
                synthetic_cohort(12, 100))),
        ):
            g = drv.get_similarity_matrix_checkpointed()
            path = os.path.join(drv.conf.checkpoint_dir, SNAP)
            with np.load(path) as z:
                out[name] = (
                    _host(g), {k: (z[k].dtype, z[k].shape) for k in z},
                    {k: z[k] for k in z}, drv.conf.checkpoint_dir,
                )
        return out

    def test_keys_and_dtypes_are_the_jax_packages(self, pair):
        jax_types, port_types = pair["jax"][1], pair["port"][1]
        assert sorted(jax_types) == ["g", "run_digest", "shards_done"]
        assert port_types == jax_types
        assert jax_types["g"][0] == np.float32
        assert jax_types["shards_done"][0] == np.int64
        assert jax_types["run_digest"][0].kind == "S"

    def test_contents_are_equal(self, pair):
        jax_z, port_z = pair["jax"][2], pair["port"][2]
        np.testing.assert_array_equal(port_z["g"], jax_z["g"])
        assert int(port_z["shards_done"]) == int(jax_z["shards_done"]) == 5
        assert bytes(port_z["run_digest"]) == bytes(jax_z["run_digest"])
        np.testing.assert_array_equal(pair["port"][0], pair["jax"][0])

    def test_the_port_stores_where_the_jax_package_deflates(self, pair):
        """The one difference of the two files: the port writes its
        members stored, the JAX package deflated. Each package's loader
        reads both to the same snapshot."""
        kinds = {}
        for name in ("jax", "port"):
            path = os.path.join(pair[name][3], SNAP)
            with zipfile.ZipFile(path) as zf:
                kinds[name] = {i.compress_type for i in zf.infolist()}
        assert kinds == {"jax": {zipfile.ZIP_DEFLATED},
                         "port": {zipfile.ZIP_STORED}}
        digest = bytes(pair["jax"][2]["run_digest"]).decode()
        for name in ("jax", "port"):
            for load in (load_snapshot, jax_checkpoint.load_snapshot):
                ck = load(pair[name][3], digest, 12)
                assert ck is not None and ck.shards_done == 5
                assert ck.g.dtype == np.float32
                np.testing.assert_array_equal(ck.g, pair["jax"][2]["g"])


class TestCheckpointedPipeline:
    def test_checkpointed_matches_plain(self, tmp_path):
        settings = _settings(tmp_path)
        driver = VariantsPcaDriver(_port(settings), synthetic_cohort(15, 120))
        result = driver.run()
        plain = VariantsPcaDriver(
            _port(_plain(settings)), synthetic_cohort(15, 120)
        )
        plain_result = plain.run()
        np.testing.assert_array_equal(_host(driver.g), _host(plain.g))
        np.testing.assert_allclose(
            _coords(result), _coords(plain_result), atol=COORD_TOL
        )
        jax_result = JaxDriver(
            JaxConfig(**{**settings, "checkpoint_dir": str(tmp_path / "j")}),
            jax_synthetic_cohort(15, 120),
        ).run()
        np.testing.assert_allclose(
            _coords(result), _coords(jax_result), atol=COORD_TOL
        )

    def test_resume_skips_completed_shards(self, tmp_path):
        conf = _port(_settings(tmp_path))
        src = synthetic_cohort(12, 100)
        g_full = _host(
            VariantsPcaDriver(conf, src).get_similarity_matrix_checkpointed()
        )
        assert src.stats.partitions == 5
        # Fresh driver + fresh source: the snapshot says all shards are
        # done, so the resume re-ingests nothing.
        src2 = synthetic_cohort(12, 100)
        g_resumed = VariantsPcaDriver(
            conf, src2
        ).get_similarity_matrix_checkpointed()
        assert isinstance(g_resumed, torch.Tensor)
        assert src2.stats.partitions == 0
        np.testing.assert_array_equal(g_full, _host(g_resumed))

    def test_resume_after_partial_failure(self, tmp_path, capsys):
        """Kill ingest in the second group (a fault on shard 3); the
        resume ingests the 3 shards after the snapshot and matches the
        uninterrupted port and JAX Gramians bit for bit."""
        settings = _settings(tmp_path)
        conf = _port(settings)
        shards = shards_for_references(conf.references, 20_000)
        src = synthetic_cohort(12, 100)
        src._fail_once.add(shards[3])
        with pytest.raises(IOError):
            VariantsPcaDriver(conf, src).get_similarity_matrix_checkpointed()
        ck = load_snapshot(conf.checkpoint_dir, _digest(settings), 12)
        assert ck is not None and ck.shards_done == 2

        src2 = synthetic_cohort(12, 100)
        capsys.readouterr()
        g = _host(
            VariantsPcaDriver(conf, src2).get_similarity_matrix_checkpointed()
        )
        assert "Resuming from snapshot: 2/5 shards done." in (
            capsys.readouterr().out
        )
        assert src2.stats.partitions == 3  # shards ingested after resume

        plain = VariantsPcaDriver(
            _port(_plain(settings)), synthetic_cohort(12, 100)
        )
        data = plain.get_data()
        calls = plain.get_calls([plain.filter_dataset(d) for d in data])
        np.testing.assert_array_equal(
            g, _host(plain.get_similarity_matrix(calls))
        )
        jax_g = np.asarray(JaxDriver(
            JaxConfig(**_plain(settings)), jax_synthetic_cohort(12, 100)
        ).ingest_gramian())
        np.testing.assert_array_equal(g, jax_g)

    def test_ingest_order_completion_is_manifest_order_when_checkpointed(
            self, tmp_path):
        settings = _settings(tmp_path, ingest_order="completion")
        src = synthetic_cohort(12, 100)
        g = _host(VariantsPcaDriver(_port(settings), src).ingest_gramian())
        plain = _host(VariantsPcaDriver(
            _port(_plain(settings)), synthetic_cohort(12, 100)
        ).ingest_gramian())
        np.testing.assert_array_equal(g, plain)

    def test_an_empty_manifest_gives_a_zero_gramian(self, tmp_path):
        settings = _settings(tmp_path, references="17:1:2")
        g = VariantsPcaDriver(
            _port(settings), synthetic_cohort(6, 20)
        ).get_similarity_matrix_checkpointed()
        np.testing.assert_array_equal(_host(g), np.zeros((6, 6)))


class TestAcrossPackages:
    """A snapshot written by each package resumes in the other."""

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_each_package_resumes_the_others_snapshot(
            self, tmp_path, writer, capsys):
        settings = _settings(tmp_path)
        shards = shards_for_references(
            PcaConfig.references, settings["bases_per_partition"]
        )
        if writer == "jax":
            src = jax_synthetic_cohort(12, 100)
            src._fail_once.add(shards[3])
            drv = JaxDriver(JaxConfig(**settings), src)
        else:
            src = synthetic_cohort(12, 100)
            src._fail_once.add(shards[3])
            drv = VariantsPcaDriver(_port(settings), src)
        with pytest.raises(IOError):
            drv.get_similarity_matrix_checkpointed()
        digest = _digest(settings)
        with np.load(os.path.join(settings["checkpoint_dir"], SNAP)) as z:
            assert bytes(z["run_digest"]).decode() == digest
            assert int(z["shards_done"]) == 2
        ck = jax_checkpoint.load_snapshot(
            settings["checkpoint_dir"], digest, 12
        )
        assert ck is not None and ck.shards_done == 2

        capsys.readouterr()
        if writer == "jax":
            src2 = synthetic_cohort(12, 100)
            g = _host(VariantsPcaDriver(
                _port(settings), src2
            ).get_similarity_matrix_checkpointed())
        else:
            src2 = jax_synthetic_cohort(12, 100)
            g = np.asarray(JaxDriver(
                JaxConfig(**settings), src2
            ).get_similarity_matrix_checkpointed())
        assert "Resuming from snapshot: 2/5 shards done." in (
            capsys.readouterr().out
        )
        assert src2.stats.partitions == 3
        want = np.asarray(JaxDriver(
            JaxConfig(**_plain(settings)), jax_synthetic_cohort(12, 100)
        ).ingest_gramian())
        np.testing.assert_array_equal(g, want)

    def test_sharded_snapshots_read_across_packages(self, tmp_path):
        import jax.numpy as jnp

        g = np.arange(36, dtype=np.float32).reshape(6, 6)
        tiles = [((slice(0, 3), slice(None)), g[:3]),
                 ((slice(3, 6), slice(None)), torch.from_numpy(g[3:]))]
        checkpoint.save_sharded_snapshot(str(tmp_path / "p"), tiles, 6, 7,
                                         "d")
        done, got = jax_checkpoint.load_sharded_snapshot(
            str(tmp_path / "p"), "d", 6)
        assert done == 7
        np.testing.assert_array_equal(got[((0, 3), (0, 6))], g[:3])
        np.testing.assert_array_equal(got[((3, 6), (0, 6))], g[3:])

        jax_checkpoint.save_sharded_snapshot(
            str(tmp_path / "j"), jnp.asarray(g), 9, "e")
        done, got = checkpoint.load_sharded_snapshot(
            str(tmp_path / "j"), "e", 6)
        assert done == 9
        key = checkpoint.index_key((slice(None), slice(None)), (6, 6))
        assert key == jax_checkpoint.index_key(
            (slice(None), slice(None)), (6, 6)) == ((0, 6), (0, 6))
        np.testing.assert_array_equal(got[key], g)
        assert checkpoint.load_sharded_snapshot(
            str(tmp_path / "j"), "other", 6) is None


@pytest.fixture(scope="module")
def chaos_cohort(tmp_path_factory):
    """One dumped cohort + its fault-free port result (the baseline every
    run must match exactly) and the JAX package's."""
    root = str(tmp_path_factory.mktemp("cohort") / "c")
    synthetic_cohort(10, 80, seed=3).dump(root)
    baseline = VariantsPcaDriver(
        _port(_chaos()), JsonlSource(root)
    ).run()
    jax_baseline = JaxDriver(JaxConfig(**_chaos()), JaxJsonl(root)).run()
    return root, baseline, jax_baseline


def _chaos(**kw):
    kw.setdefault("variant_set_ids", [DEFAULT_VARIANT_SET_ID])
    kw.setdefault("references", REFS)
    kw.setdefault("bases_per_partition", 20_000)
    kw.setdefault("block_variants", 16)
    kw.setdefault("ingest_workers", 2)
    kw.setdefault("shard_retries", 1)
    return kw


class TestTornSnapshots:
    def test_torn_checkpoint_writes_and_resume_identical(
            self, chaos_cohort, tmp_path, capsys):
        root, baseline, jax_baseline = chaos_cohort
        conf = _port(_chaos(checkpoint_dir=str(tmp_path / "ck"),
                            checkpoint_every=2))
        plan = FaultPlan(seed=31, rules=[FaultRule(
            site="checkpoint.snapshot_write", kind="torn", times=None)])
        with faults.active_plan(plan):
            result = VariantsPcaDriver(conf, JsonlSource(root)).run()
        # Every snapshot written this run was torn — the in-memory
        # accumulator is unaffected, results identical.
        assert plan.fired_total >= 1
        np.testing.assert_array_equal(_coords(result), _coords(baseline))
        # Resume over the torn snapshot: the tolerant loader discards it
        # with a warning and re-ingests — identical again, not a crash.
        capsys.readouterr()
        resumed = VariantsPcaDriver(conf, JsonlSource(root)).run()
        assert "unreadable Gramian snapshot" in capsys.readouterr().err
        np.testing.assert_array_equal(_coords(resumed), _coords(baseline))
        np.testing.assert_allclose(
            _coords(resumed), _coords(jax_baseline), atol=COORD_TOL)

    def test_crash_after_torn_snapshot_then_resume(
            self, chaos_cohort, tmp_path):
        """A torn snapshot AND a mid-run worker death (no shard
        retries): the run dies, the resume discards the torn file and
        completes identically — as the JAX package does under the same
        plan."""
        root, baseline, jax_baseline = chaos_cohort
        settings = _chaos(checkpoint_dir=str(tmp_path / "ck2"),
                          checkpoint_every=2)
        rules = [
            dict(site="checkpoint.snapshot_write", kind="torn", times=1),
            dict(site="ingest.shard", kind="error", times=1, after=2),
        ]
        plan = FaultPlan(rules=[FaultRule(**r) for r in rules])
        with faults.active_plan(plan):
            with pytest.raises(IOError):
                VariantsPcaDriver(_port(settings), JsonlSource(root)).run()
        resumed = VariantsPcaDriver(_port(settings), JsonlSource(root)).run()
        np.testing.assert_array_equal(_coords(resumed), _coords(baseline))

        jax_settings = {**settings, "checkpoint_dir": str(tmp_path / "j")}
        jax_plan = jax_faults.FaultPlan(
            rules=[jax_faults.FaultRule(**r) for r in rules])
        with jax_faults.active_plan(jax_plan):
            with pytest.raises(IOError):
                JaxDriver(JaxConfig(**jax_settings), JaxJsonl(root)).run()
        assert jax_plan.fired_total == plan.fired_total == 2
        jax_resumed = JaxDriver(
            JaxConfig(**jax_settings), JaxJsonl(root)).run()
        np.testing.assert_allclose(
            _coords(resumed), _coords(jax_resumed), atol=COORD_TOL)


class TestCsrRoute:
    @pytest.fixture(scope="class")
    def cohort_dir(self, tmp_path_factory):
        root = str(tmp_path_factory.mktemp("csr") / "c")
        synthetic_cohort(24, 300, seed=5).dump(root)
        return root

    @pytest.mark.parametrize("workers", [1, 3])
    def test_checkpointed_csr_route_identical(
            self, cohort_dir, tmp_path, workers):
        settings = dict(
            variant_set_ids=[DEFAULT_VARIANT_SET_ID],
            bases_per_partition=20_000,
            block_variants=32,
            ingest_workers=workers,
        )
        base = _host(VariantsPcaDriver(
            _port({**settings, "ingest_workers": 1}), JsonlSource(cohort_dir)
        ).ingest_gramian())
        driver = VariantsPcaDriver(
            _port({**settings, "checkpoint_dir": str(tmp_path / "ck"),
                   "checkpoint_every": 2}),
            JsonlSource(cohort_dir),
        )
        assert driver._fused_csr_possible()
        g = _host(driver.get_similarity_matrix_checkpointed())
        np.testing.assert_array_equal(g, base)
        jax_g = np.asarray(JaxDriver(
            JaxConfig(**settings, checkpoint_dir=str(tmp_path / "j"),
                      checkpoint_every=2),
            JaxJsonl(cohort_dir),
        ).get_similarity_matrix_checkpointed())
        np.testing.assert_array_equal(g, jax_g)


class TestRefusals:
    """The JAX driver's refusals of a checkpoint, before any ingest and in
    its order."""

    @pytest.mark.parametrize(
        "kw,match",
        [
            (dict(pca_mode="sparse"), "--pca-mode sparse does not compose"),
            (dict(pca_mode="sketch"), "--pca-mode sketch does not compose"),
            (dict(samples=["x"]), "do not compose with checkpointed"),
        ],
        ids=["sparse", "sketch", "restricted"],
    )
    def test_refused_before_ingest(self, kw, match):
        settings = dict(checkpoint_dir="/nonexistent", **kw)
        with pytest.raises(ValueError, match=match):
            VariantsPcaDriver(_port(settings), None)
        if "samples" not in kw:
            with pytest.raises(ValueError, match=match):
                JaxDriver(JaxConfig(**settings), None)

    def test_sparse_refusal_comes_before_the_sketch_precise_one(self):
        conf = dict(pca_mode="sparse", checkpoint_dir="/x", precise=True)
        with pytest.raises(ValueError, match="sparse does not compose"):
            VariantsPcaDriver(_port(conf), None)

    def test_elastic_checkpoint_names_item_8(self):
        with pytest.raises(NotImplementedError, match="item 8"):
            VariantsPcaDriver(
                _port(dict(checkpoint_dir="/x", elastic_checkpoint=True)),
                None,
            )
