"""The port's obs core against the JAX package's.

The same operations through both packages' registries, tracers and
telemetry sessions must give the same Prometheus series (names, labels,
values), the same Chrome trace events (names, kinds, args, nesting) and the
same snapshot; the port's artifacts also pass the repository's trace and
metrics validator (``scripts/validate_trace.py``). Each ambient span is one
``torch.profiler`` range; the driver's counters carry the JAX package's
names and values.
"""

import contextlib
import importlib.util
import io
import json
import os
import threading

import numpy as np
import pytest
import torch

from spark_examples_tpu import obs as jax_obs
from spark_examples_tpu.genomics.fixtures import (
    synthetic_cohort as jax_synthetic_cohort,
)
from spark_examples_tpu.models.pca import VariantsPcaDriver as JaxDriver
from spark_examples_tpu.utils.config import PcaConfig as JaxConfig
from spark_examples_tpu.utils.tracing import StageTimer as JaxStageTimer
from spark_examples_tpu_torch import obs
from spark_examples_tpu_torch.genomics.fixtures import (
    DEFAULT_VARIANT_SET_ID,
    synthetic_cohort,
)
from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
from spark_examples_tpu_torch.obs.manifest import MANIFEST_SCHEMA
from spark_examples_tpu_torch.utils.config import PcaConfig
from spark_examples_tpu_torch.utils.stats import IoStats
from spark_examples_tpu_torch.utils.tracing import StageTimer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _validator():
    spec = importlib.util.spec_from_file_location(
        "validate_trace", os.path.join(ROOT, "scripts", "validate_trace.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record(pkg_obs, registry):
    """One fixed sequence of metric operations, seeded values."""
    rng = np.random.default_rng(5)
    registry.counter("jobs_total", "Jobs").labels(kind="a").inc(3)
    registry.counter("jobs_total").labels(kind="b").inc()
    registry.counter("plain_total", "No labels").inc(2.5)
    registry.gauge("depth", "Queue depth").set(7)
    registry.gauge("depth").inc(-2)
    h = registry.histogram("lat_seconds", "Latency")
    for v in rng.exponential(0.3, size=50):
        h.labels(method="m").observe(float(v))
    registry.histogram("one_seconds", buckets=(0.1, 1.0)).observe(0.5)


def _own_lines(text):
    """Exposition lines minus the collector-backed IoStats series (each
    package sums its own live sources)."""
    return [l for l in text.splitlines() if "genomics_io_" not in l]


def test_prometheus_series_and_snapshot_match():
    port, ref = obs.MetricsRegistry(), jax_obs.MetricsRegistry()
    _record(obs, port)
    _record(jax_obs, ref)
    assert _own_lines(port.to_prometheus()) == _own_lines(ref.to_prometheus())
    got, want = port.snapshot(), ref.snapshot()
    for kind in ("counters", "gauges"):
        strip = lambda d: {k: v for k, v in d.items()
                           if "genomics_io_" not in k}
        assert strip(got[kind]) == strip(want[kind])
    assert got["histograms"] == want["histograms"]


def test_counters_refuse_decrements_and_kind_clashes():
    for pkg in (obs, jax_obs):
        reg = pkg.MetricsRegistry()
        with pytest.raises(ValueError):
            reg.counter("c").inc(-1)
        reg.counter("x")
        with pytest.raises(ValueError):
            reg.gauge("x")


def test_counter_is_exact_under_threads():
    c = obs.MetricsRegistry().counter("n_total").labels(t="x")
    threads = [
        threading.Thread(target=lambda: [c.inc() for _ in range(2000)])
        for _ in range(8)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert c.value == 16000


def _trace_ops(tracer):
    with tracer.span("outer", shard="17:0-10"):
        tracer.instant("retry_backoff", scope="p", attempt=1)
        with tracer.span("inner"):
            tracer.counter("queue", depth=3)
        with tracer.span("inner", block=2):
            pass
    tracer.instant("mark")


def _shape(tracer):
    """(name, ph, args, parent) per event, in order; parents by nesting."""
    events = [e for e in tracer.to_chrome()["traceEvents"] if e["ph"] != "M"]
    spans = [e for e in events if e["ph"] == "X"]
    out = []
    for e in events:
        parent = None
        for s in spans:
            if s is not e and s["ts"] <= e["ts"] and (
                e["ts"] + e.get("dur", 0) <= s["ts"] + s["dur"]
            ):
                if parent is None or s["dur"] < parent["dur"]:
                    parent = s
        out.append((e["name"], e["ph"], e.get("args"),
                    None if parent is None else parent["name"]))
    return out


def test_chrome_trace_events_match_in_names_and_nesting():
    port, ref = obs.SpanTracer(), jax_obs.SpanTracer()
    _trace_ops(port)
    _trace_ops(ref)
    assert _shape(port) == _shape(ref)
    assert port.stage_counts() == ref.stage_counts()
    doc = port.to_chrome()
    assert doc["otherData"]["process_index"] == 0
    assert doc["traceEvents"][0]["ph"] == "M"


def test_trace_context_and_dropped_events():
    for pkg in (obs, jax_obs):
        tracer = pkg.SpanTracer(max_events=2)
        with pkg.trace_context("job-1"):
            with tracer.span("a"):
                pass
            tracer.instant("b")
        tracer.instant("c")
        names = [e["name"] for e in tracer.to_chrome()["traceEvents"]]
        assert names[-1] == "tracer_events_dropped"
        assert [e["name"] for e in tracer.events_for_trace("job-1")] == [
            "a", "b"]


def _ambient_ops(pkg_obs):
    with pkg_obs.span("stage", n=4):
        pkg_obs.instant("note", text="x")
        pkg_obs.observe_rpc("http", "/callsets", 0.004)
        pkg_obs.count_retry("http", "/variants-csr")
        with pkg_obs.rpc_timer("jsonl", "stream_carrying_csr"):
            pass
        with pytest.raises(IOError):
            with pkg_obs.rpc_timer("http", "/variants"):
                raise IOError("down")
        pkg_obs.counter("inflight", jobs=1)


def test_sessions_record_the_same_series_and_events(tmp_path):
    results = []
    for name, pkg_obs in (("port", obs), ("jax", jax_obs)):
        paths = {k: str(tmp_path / f"{name}.{k}") for k in
                 ("trace", "prom", "manifest")}
        with pkg_obs.telemetry_session(
            trace_out=paths["trace"], metrics_out=paths["prom"],
            manifest_out=paths["manifest"], command="pca",
        ) as session:
            _ambient_ops(pkg_obs)
            snap = session.registry.snapshot()
        names = [(e["name"], e["ph"]) for e in json.load(
            open(paths["trace"]))["traceEvents"] if e["ph"] != "M"]
        counts = {k: v["count"] for k, v in snap["histograms"].items()}
        own = {k: v for k, v in snap["counters"].items()
               if "genomics_io_" not in k}
        results.append((names, counts, own))
        assert os.path.exists(paths["prom"] + ".jsonl")
        if name == "port":
            validate = _validator()
            assert validate.validate_trace(paths["trace"]) == []
            assert validate.validate_metrics(paths["prom"]) == []
            manifest = json.load(open(paths["manifest"]))
            assert manifest["schema"] == MANIFEST_SCHEMA
            assert manifest["outcome"] == "ok"
            assert manifest["environment"]["torch"]["version"] == (
                torch.__version__)
            assert "stage" in manifest["stages"]
    assert results[0] == results[1]
    assert not obs.collection_active()


def test_a_failed_run_still_writes_its_artifacts(tmp_path):
    trace = tmp_path / "t.json"
    manifest = tmp_path / "m.json"
    with pytest.raises(RuntimeError):
        with obs.telemetry_session(trace_out=str(trace),
                                   manifest_out=str(manifest)):
            with obs.span("ingest.fetch"):
                raise RuntimeError("boom")
    names = {e["name"] for e in json.load(open(trace))["traceEvents"]}
    assert {"run", "ingest.fetch", "run_failed"} <= names
    assert json.load(open(manifest))["outcome"] == "error"


def _range_count(fn, name):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(e.name == name for e in prof.events())


def test_each_span_opens_one_profiler_range():
    def body():
        with obs.span("gramian.sparse.window", route="scatter"):
            torch.ones(4).sum()

    assert _range_count(body, "gramian.sparse.window") == 1
    with obs.telemetry_session():
        assert _range_count(body, "gramian.sparse.window") == 1
    timer = StageTimer()
    assert _range_count(lambda: _stage(timer), "pca") == 1


def _stage(timer):
    with timer.stage("pca"):
        timer.note("fused eig residual 1e-7")


def test_stage_timer_report_matches_the_jax_package():
    reports = []
    for timer in (StageTimer(), JaxStageTimer()):
        for name in ("ingest+gramian", "pca", "ingest+gramian"):
            with timer.stage(name):
                timer.note(f"in {name}")
        timer.note("outside")
        timer.seconds = {k: 0.25 for k in timer.seconds}
        reports.append(timer.report())
    assert reports[0] == reports[1]


def test_io_stats_reach_the_registry_through_the_collector():
    reg = obs.MetricsRegistry()

    def requests():
        return reg.snapshot()["counters"]["genomics_io_requests_total"]

    before = requests()
    stats = IoStats()
    stats.add(requests=5)
    assert requests() == before + 5
    del stats  # retired into the collector's totals, not lost
    assert requests() == before + 5


SPARSE = dict(variant_set_ids=[DEFAULT_VARIANT_SET_ID], pca_mode="sparse",
              block_variants=64, sparse_density_threshold=0.6)


def _driver_counters(pkg_obs, make_driver):
    with pkg_obs.telemetry_session() as session, contextlib.redirect_stdout(
        io.StringIO()
    ):
        make_driver().run()
        counters = session.registry.snapshot()["counters"]
        names = {e["name"] for e in session.tracer.to_chrome()["traceEvents"]}
    return counters, names


@pytest.mark.parametrize("mode", ["sparse", "sketch"])
def test_driver_counters_carry_the_jax_packages_names_and_values(mode):
    kw = dict(SPARSE, pca_mode=mode)
    got, got_names = _driver_counters(obs, lambda: VariantsPcaDriver(
        PcaConfig(device="cpu", **kw),
        synthetic_cohort(64, 800, seed=3, population_structure=3)))
    want, want_names = _driver_counters(jax_obs, lambda: JaxDriver(
        JaxConfig(**kw),
        jax_synthetic_cohort(64, 800, seed=3, population_structure=3)))
    family = ("sparse_gramian_windows_total" if mode == "sparse"
              else "sketch_windows_total")
    pick = lambda c: {k: v for k, v in c.items() if k.startswith(family)}
    assert pick(got) and pick(got) == pick(want)
    if mode == "sparse":
        assert got["sparse_gramian_nnz_total"] == want[
            "sparse_gramian_nnz_total"]
        assert {"gramian.sparse.accumulate",
                "gramian.sparse.window"} <= got_names & want_names
    else:
        assert {"gramian.sketch.accumulate", "gramian.sketch.window",
                "gramian.sketch.finish"} <= got_names & want_names
    assert {"ingest+gramian", "pca", "emit"} <= got_names & want_names


def test_csr_ingest_counts_built_blocks_like_the_jax_package(tmp_path):
    synthetic_cohort(48, 400, seed=3, population_structure=2).dump(
        str(tmp_path))
    from spark_examples_tpu.genomics.sources import (
        JsonlSource as JaxJsonlSource,
    )
    from spark_examples_tpu_torch.genomics.sources import JsonlSource

    kw = dict(variant_set_ids=[DEFAULT_VARIANT_SET_ID], pca_mode="auto",
              block_variants=64)
    got, got_names = _driver_counters(obs, lambda: VariantsPcaDriver(
        PcaConfig(device="cpu", **kw), JsonlSource(str(tmp_path))))
    want, want_names = _driver_counters(jax_obs, lambda: JaxDriver(
        JaxConfig(**kw), JaxJsonlSource(str(tmp_path))))
    total = lambda c: sum(v for k, v in c.items()
                          if k.startswith("ingest_blocks_built_total"))
    assert total(got) == total(want) > 0
    assert {"ingest.stream", "ingest.fetch", "ingest.build"} <= (
        got_names & want_names)
