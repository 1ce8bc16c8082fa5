"""Ingest resilience of the port against the JAX package.

- Speculation: the six cases of the JAX package's
  ``tests/test_speculation.py::TestSpeculation`` over the port's
  ``ordered_parallel_map``, with the same shrunken eligibility knobs.
- The drivers under the same fault plans: ``--speculative-ingest``, the
  ``ingest.shard``, ``ingest.build`` and ``ingest.stream`` sites with
  ``--shard-retries``, and ``FixtureSource``'s own ``fixture.stream``
  plane. Each case runs the port's driver and the JAX package's on the same
  cohort under the same plan: the port's coordinates must equal its
  fault-free run's exactly and the JAX driver's within 1e-4, both plans
  must fire the same number of faults, and with ``--shard-retries 1`` both
  drivers raise an ``IOError`` naming the site.
- ``--shard-retry-deadline`` stops the retries; the CLI parses the three
  flags with the JAX package's defaults.
"""

import contextlib
import io
import threading
import time

import numpy as np
import pytest
import torch

from spark_examples_tpu.cli import main as jax_cli
from spark_examples_tpu.genomics.fixtures import (
    synthetic_cohort as jax_synthetic_cohort,
)
from spark_examples_tpu.genomics.sources import JsonlSource as JaxJsonl
from spark_examples_tpu.models.pca import VariantsPcaDriver as JaxDriver
from spark_examples_tpu.resilience import faults as jax_faults
from spark_examples_tpu.utils.config import PcaConfig as JaxConfig
from spark_examples_tpu_torch.cli import main as cli
from spark_examples_tpu_torch.genomics.fixtures import (
    DEFAULT_VARIANT_SET_ID,
    synthetic_cohort,
)
from spark_examples_tpu_torch.genomics.shards import shards_for_references
from spark_examples_tpu_torch.genomics.sources import (
    FixtureSource,
    JsonlSource,
)
from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
from spark_examples_tpu_torch.resilience import faults
from spark_examples_tpu_torch.utils import concurrency
from spark_examples_tpu_torch.utils.concurrency import ordered_parallel_map
from spark_examples_tpu_torch.utils.config import PcaConfig

REFS = "17:41196311:41277499"
COORD_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture()
def fast_thresholds(monkeypatch):
    """Shrink the eligibility knobs so tests run in milliseconds."""
    monkeypatch.setattr(concurrency, "SPECULATION_MIN_COMPLETED", 3)
    monkeypatch.setattr(concurrency, "SPECULATION_FLOOR_SECONDS", 0.02)
    monkeypatch.setattr(concurrency, "SPECULATION_MULTIPLIER", 3.0)


# -- speculation in ordered_parallel_map --------------------------------------


class TestSpeculation:
    def test_wedged_head_unblocked_by_duplicate(self, fast_thresholds):
        """First attempt at item 7 wedges until released; the speculative
        duplicate completes and the stream finishes correctly."""
        release = threading.Event()
        attempts = {}
        lock = threading.Lock()
        speculated = []

        def fn(i):
            with lock:
                n = attempts[i] = attempts.get(i, 0) + 1
            if i == 7 and n == 1:
                release.wait(30)  # the wedge: far past any threshold
            return i * i

        out = []
        for r in ordered_parallel_map(
            fn, range(12), workers=4, speculate=True,
            on_speculate=speculated.append,
        ):
            out.append(r)
            if r == 49:
                release.set()  # let the wedged original finish
        assert out == [i * i for i in range(12)]
        assert speculated == [7]
        assert attempts[7] == 2  # exactly one duplicate

    def test_no_speculation_when_disabled(self, fast_thresholds):
        attempts = {}
        lock = threading.Lock()

        def fn(i):
            with lock:
                attempts[i] = attempts.get(i, 0) + 1
            if i == 5:
                time.sleep(0.4)  # slow but finite
            return i

        out = list(ordered_parallel_map(fn, range(10), workers=4))
        assert out == list(range(10))
        assert all(v == 1 for v in attempts.values())

    def test_not_eligible_before_min_completed(self, monkeypatch):
        monkeypatch.setattr(concurrency, "SPECULATION_MIN_COMPLETED", 100)
        speculated = []

        def fn(i):
            if i == 0:
                time.sleep(0.3)
            return i

        out = list(ordered_parallel_map(
            fn, range(8), workers=4, speculate=True,
            on_speculate=speculated.append,
        ))
        assert out == list(range(8))
        assert speculated == []

    def test_failed_original_defers_to_speculative_survivor(
        self, fast_thresholds
    ):
        blow_up = threading.Event()
        attempts = {}
        lock = threading.Lock()

        def fn(i):
            with lock:
                n = attempts[i] = attempts.get(i, 0) + 1
            if i == 6 and n == 1:
                blow_up.wait(30)
                raise IOError("original died slowly")
            return i + 100

        speculated = []
        results = []
        for r in ordered_parallel_map(
            fn, range(10), workers=4, speculate=True,
            on_speculate=speculated.append,
        ):
            results.append(r)
            if r == 106:
                blow_up.set()  # the duplicate won; let the original die
        assert results == [i + 100 for i in range(10)]
        assert speculated == [6]

    def test_both_attempts_failing_surfaces_error(self, fast_thresholds):
        def fn(i):
            if i == 4:
                time.sleep(0.5)
                raise IOError("shard is truly broken")
            return i

        with pytest.raises(IOError, match="truly broken"):
            list(ordered_parallel_map(
                fn, range(10), workers=4, speculate=True
            ))

    def test_serial_path_ignores_speculation(self):
        out = list(ordered_parallel_map(
            lambda i: i, range(5), workers=1, speculate=True
        ))
        assert out == list(range(5))


def test_a_raise_leaves_no_worker_thread_running(fast_thresholds):
    """The generator's exit joins both pools: after the error surfaces no
    attempt of the map is still running."""
    before = set(threading.enumerate())

    def fn(i):
        time.sleep(0.01)
        if i == 9:
            raise IOError("late failure")
        return i

    with pytest.raises(IOError):
        list(ordered_parallel_map(fn, range(20), workers=4, speculate=True))
    leftover = [t for t in threading.enumerate()
                if t not in before and t.is_alive()]
    assert leftover == []


# -- the drivers under the same plans ------------------------------------------


def _port_conf(**kw):
    kw.setdefault("variant_set_ids", [DEFAULT_VARIANT_SET_ID])
    kw.setdefault("references", REFS)
    kw.setdefault("bases_per_partition", 20_000)
    kw.setdefault("block_variants", 16)
    kw.setdefault("ingest_workers", 2)
    return PcaConfig(device="cpu", **kw)


def _jax_conf(**kw):
    kw.setdefault("variant_set_ids", [DEFAULT_VARIANT_SET_ID])
    kw.setdefault("references", REFS)
    kw.setdefault("bases_per_partition", 20_000)
    kw.setdefault("block_variants", 16)
    kw.setdefault("ingest_workers", 2)
    return JaxConfig(**kw)


def _coords(result):
    return np.array([[pc1, pc2] for _, pc1, pc2 in result])


def _port_run(source, plan=None, **kw):
    with faults.active_plan(plan), contextlib.redirect_stdout(io.StringIO()):
        driver = VariantsPcaDriver(_port_conf(**kw), source)
        result = driver.run()
    return _coords(result), driver


def _jax_run(source, plan=None, **kw):
    with jax_faults.active_plan(plan), contextlib.redirect_stdout(
        io.StringIO()
    ):
        return _coords(JaxDriver(_jax_conf(**kw), source).run())


def _plans(seed, *rules):
    """The same plan in each package's own FaultPlan class."""
    spec = {"seed": seed, "rules": [dict(r) for r in rules]}
    return (
        faults.FaultPlan.from_dict(spec),
        jax_faults.FaultPlan.from_dict(spec),
    )


@pytest.fixture(scope="module")
def chaos_cohort(tmp_path_factory):
    """One dumped cohort and both drivers' fault-free coordinates."""
    root = str(tmp_path_factory.mktemp("cohort") / "c")
    synthetic_cohort(10, 80, seed=3).dump(root)
    port, _ = _port_run(JsonlSource(root))
    jax = _jax_run(JaxJsonl(root))
    assert np.abs(port - jax).max() <= COORD_TOL
    return root, port, jax


def _assert_same_result(chaos, port, jax):
    _, port_base, jax_base = chaos
    np.testing.assert_array_equal(port, port_base)
    assert np.abs(port - jax).max() <= COORD_TOL
    assert np.abs(jax - jax_base).max() <= COORD_TOL


@pytest.mark.parametrize(
    "case, rules, retries",
    [
        ("worker-death-and-slow-lanes",
         [dict(site="ingest.shard", kind="error", times=2),
          dict(site="ingest.shard", kind="stall", times=2, stall_s=0.01)],
         4),
        ("block-builder-death",
         [dict(site="ingest.build", kind="error", times=2)], 3),
        ("stream-error", [dict(site="ingest.stream", kind="error", times=2)],
         3),
        ("stream-stall", [dict(site="ingest.stream", kind="stall", times=2,
                               stall_s=0.01)], 3),
        ("stream-truncate",
         [dict(site="ingest.stream", kind="truncate", times=2)], 3),
    ],
    ids=lambda v: v if isinstance(v, str) else "",
)
def test_faults_retried_to_the_fault_free_result(
    chaos_cohort, case, rules, retries
):
    root = chaos_cohort[0]
    port_plan, jax_plan = _plans(23, *rules)
    port, _ = _port_run(JsonlSource(root), port_plan, shard_retries=retries)
    jax = _jax_run(JaxJsonl(root), jax_plan, shard_retries=retries)
    _assert_same_result(chaos_cohort, port, jax)
    want = sum(r["times"] for r in rules)
    assert port_plan.fired_total == jax_plan.fired_total == want
    assert {f.site for f in port_plan.injected} == {
        f.site for f in jax_plan.injected
    }


@pytest.mark.parametrize(
    "site, kind",
    [("ingest.shard", "error"), ("ingest.build", "error"),
     ("ingest.stream", "error"), ("ingest.stream", "truncate")],
)
def test_one_attempt_fails_loudly_in_both_drivers(chaos_cohort, site, kind):
    root = chaos_cohort[0]
    port_plan, jax_plan = _plans(5, dict(site=site, kind=kind, times=1))
    with pytest.raises(IOError, match=site):
        _port_run(JsonlSource(root), port_plan, shard_retries=1)
    with pytest.raises(IOError, match=site):
        _jax_run(JaxJsonl(root), jax_plan, shard_retries=1)
    assert port_plan.fired_total == jax_plan.fired_total == 1


def test_the_retry_deadline_stops_retrying(chaos_cohort):
    """An unbounded fault with a generous attempt count: the per-shard
    deadline ends the retries and the last error surfaces."""
    root = chaos_cohort[0]
    for run, plan in zip((_port_run, _jax_run), _plans(
            3, dict(site="ingest.shard", kind="error", times=None))):
        source = (JsonlSource if run is _port_run else JaxJsonl)(root)
        t0 = time.monotonic()
        with pytest.raises(IOError, match="ingest.shard"):
            run(source, plan, shard_retries=1000,
                shard_retry_deadline=0.3)
        assert time.monotonic() - t0 < 10
        assert 1 < plan.fired_total < 1000


def _fixture_pair():
    return (
        synthetic_cohort(12, 100, seed=2),
        jax_synthetic_cohort(12, 100, seed=2),
    )


def test_speculative_ingest_matches_plain_in_both_drivers(fast_thresholds):
    """--speculative-ingest gives a bit-identical G (the duplicate's result
    IS the original's), in both packages."""
    port_src, jax_src = _fixture_pair()
    settings = dict(bases_per_partition=20_000, block_variants=64)
    spec = VariantsPcaDriver(
        _port_conf(ingest_workers=4, speculative_ingest=True, **settings),
        port_src,
    )
    g = spec.get_similarity_matrix(spec.get_calls_fused()).numpy()
    plain = VariantsPcaDriver(_port_conf(**settings), port_src)
    calls = plain.get_calls([plain.filter_dataset(d)
                             for d in plain.get_data()])
    np.testing.assert_array_equal(
        g, plain.get_similarity_matrix(calls).numpy()
    )
    jax = JaxDriver(
        _jax_conf(ingest_workers=4, speculative_ingest=True, **settings),
        jax_src,
    )
    np.testing.assert_array_equal(
        g, np.asarray(jax.get_similarity_matrix(jax.get_calls_fused()))
    )


def test_a_stalled_shard_is_speculated_in_both_drivers(
    chaos_cohort, fast_thresholds, capsys
):
    """One ``ingest.shard`` stall on a shard with eight before it (times=1,
    so the duplicate is not stalled): each driver launches a duplicate of
    it, prints the reference's line, and its coordinates stay the
    fault-free run's. (On a loaded host another shard may pass the
    straggler threshold too; each shard is speculated at most once.) ``--speculative-ingest`` takes the fused lists, not the CSR
    tier. (The run still returns only after the stalled original ends:
    leaving the map joins every attempt.)"""
    root = chaos_cohort[0]
    shards = shards_for_references(REFS, 5_000)
    late = str(shards[9])
    kw = dict(bases_per_partition=5_000, ingest_workers=4,
              speculative_ingest=True, shard_retries=2)
    port_plan, jax_plan = _plans(
        1, dict(site="ingest.shard", kind="stall", times=1, stall_s=1.5,
                match=late))
    base, _ = _port_run(JsonlSource(root), bases_per_partition=5_000)
    np.testing.assert_array_equal(base, chaos_cohort[1])
    port, driver = _port_run(JsonlSource(root), port_plan, **kw)
    assert driver._speculated_shards >= 1
    assert not driver._fused_csr_possible()
    jax = _jax_run(JaxJsonl(root), jax_plan, **kw)
    err = capsys.readouterr().err
    assert err.count(f"Speculating straggler shard {late} "
                     "(duplicate attempt launched).") == 2
    assert (f"Speculative shard attempts on this host: "
            f"{driver._speculated_shards}.") in err
    _assert_same_result(chaos_cohort, port, jax)
    assert port_plan.fired_total == jax_plan.fired_total == 1


class TestFixtureFaultPlane:
    def test_fail_once_surface_preserved_on_the_plan(self):
        src = synthetic_cohort(4, 10, seed=1)
        shard = shards_for_references(REFS, 100_000)[0]
        src._fail_once.add(shard)
        with pytest.raises(IOError, match="injected stream failure"):
            list(src.stream_variants("", shard))
        assert src.stats.io_exceptions == 1
        assert len(list(src.stream_variants("", shard))) == 10
        assert src.faults.fired_total == 1

    def test_fail_shards_constructor_arg(self):
        shard = shards_for_references(REFS, 100_000)[0]
        src = FixtureSource(variants=[], fail_shards=[shard])
        with pytest.raises(IOError):
            list(src.stream_variants("", shard))
        assert list(src.stream_variants("", shard)) == []

    @pytest.mark.parametrize("retries", [1, 2])
    def test_a_failing_fixture_shard_in_both_drivers(self, retries):
        """``fixture.stream`` through the drivers: retried to the
        fault-free coordinates, or raised at one attempt."""
        port_src, jax_src = _fixture_pair()
        kw = dict(bases_per_partition=20_000, ingest_workers=2)
        base, _ = _port_run(synthetic_cohort(12, 100, seed=2), **kw)
        jax_base = _jax_run(jax_synthetic_cohort(12, 100, seed=2), **kw)
        shard = shards_for_references(REFS, 20_000)[1]
        port_src._fail_once.add(shard)
        jax_src._fail_once.add(shard)
        if retries == 1:
            with pytest.raises(IOError, match="injected stream failure"):
                _port_run(port_src, shard_retries=1, **kw)
            with pytest.raises(IOError, match="injected stream failure"):
                _jax_run(jax_src, shard_retries=1, **kw)
        else:
            port, _ = _port_run(port_src, shard_retries=2, **kw)
            jax = _jax_run(jax_src, shard_retries=2, **kw)
            np.testing.assert_array_equal(port, base)
            assert np.abs(port - jax).max() <= COORD_TOL
            assert np.abs(jax - jax_base).max() <= COORD_TOL
        assert port_src.stats.io_exceptions == jax_src.stats.io_exceptions
        assert port_src.stats.io_exceptions == 1
        assert port_src.faults.fired_total == jax_src.faults.fired_total


def test_the_cli_parses_the_three_flags_with_the_jax_defaults():
    port = vars(cli.build_parser().parse_args(["pca"]))
    ref = vars(jax_cli.build_parser().parse_args(["pca"]))
    for name in ("speculative_ingest", "shard_retries",
                 "shard_retry_deadline"):
        assert port[name] == ref[name], name
    argv = ["pca", "--speculative-ingest", "--shard-retries", "3",
            "--shard-retry-deadline", "2.5"]
    conf = cli.pca_config_from_args(cli.build_parser().parse_args(argv))
    assert (conf.speculative_ingest, conf.shard_retries,
            conf.shard_retry_deadline) == (True, 3, 2.5)


def test_the_fault_plane_counts_exactly_under_contention():
    """The per-rule hit counter under many more threads than cores and a
    shortened switch interval: exactly ``times`` faults fire, and every
    hit is counted."""
    import sys

    plan = faults.FaultPlan(rules=[
        faults.FaultRule(site="ingest.build", kind="error", times=37)
    ])
    raised = []
    lock = threading.Lock()

    def hammer(worker):
        for i in range(200):
            try:
                plan.inject("ingest.build", key=f"{worker}:{i}")
            except faults.InjectedFault:
                with lock:
                    raised.append(1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer, args=(w,))
                   for w in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(raised) == plan.fired_total == 37
    assert plan._hits == [32 * 200]
