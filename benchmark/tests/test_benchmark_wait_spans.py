"""The readers of the port's wait spans and per-sample host loops on a
hand-made timeline: ``feed_wait_ms``, ``shard_wait_ms``, ``callsets_s`` and
``rows_s`` count nested ranges once on a thread, sum over threads, divide
by the jobs, and read nothing where the program opens no such range (as a
program that predates the spans does not)."""

import types

import pytest

from benchmark import spec as spec_mod
from benchmark.tests.conftest import ROOT
from benchmark.trace import Trace

NEW = ("feed_wait_ms", "shard_wait_ms", "callsets_s", "rows_s")


def _read(metric, ranges, jobs=2):
    ranges = {"bench.window": [(1, 0, 1000)], **ranges}
    trace = Trace([], ranges, {}, (0, 1000))
    run = types.SimpleNamespace(jobs=[object()] * jobs, trace=trace)
    return spec_mod.load(ROOT).reader(metric)(run)


def test_the_readers_are_declared_with_their_layers():
    doc = spec_mod.load(ROOT).doc
    metrics = {m["name"]: m for m in doc["per_layer"]}
    layers = {"feed_wait_ms": "feed", "shard_wait_ms": "sidecar",
              "callsets_s": "driver and callsets", "rows_s": "emission"}
    for name, layer in layers.items():
        m = metrics[name]
        assert (m["source"], m["moves"], m["layer"]) == (
            "program_span", "job_s", layer)
    assert metrics["feed_wait_ms"]["workloads"] == ["kg1000.chrom"]
    assert not {"workloads"} & (set(metrics["shard_wait_ms"])
                                | set(metrics["callsets_s"])
                                | set(metrics["rows_s"]))


def test_feed_wait_sums_threads_and_clips_to_the_window():
    # Thread 1: 100 + 50 us; thread 4: 30 us, and 20 of 40 in the window.
    ranges = {"feed.wait": [(1, 10, 110), (1, 200, 250), (4, 300, 330),
                            (4, 980, 1020)]}
    assert _read("feed_wait_ms", ranges) == pytest.approx(0.2 / 2)


def test_shard_wait_counts_only_its_own_name():
    ranges = {"shard.wait": [(2, 0, 400), (3, 100, 200)],
              "ingest.fetch": [(5, 0, 1000)],
              "ingest.stream": [(2, 0, 1000)]}
    assert _read("shard_wait_ms", ranges, jobs=1) == pytest.approx(0.5)


def test_nested_callset_ranges_count_once_a_thread():
    # A table built inside another's range on the job's thread counts
    # once; a table built on another thread counts beside it.
    ranges = {"callsets.index": [(1, 100, 500), (1, 150, 450),
                                 (7, 0, 100)],
              "bench.construct": [(1, 90, 600)]}
    assert _read("callsets_s", ranges) == pytest.approx(500e-6 / 2)


def test_rows_ranges_are_merged_by_prefix():
    ranges = {"rows.tuples": [(1, 0, 100)],
              "rows.sort": [(1, 200, 300), (1, 250, 280)],
              "rows.write": [(1, 300, 600)],
              "emit": [(1, 200, 600)],
              "rowsum": [(1, 700, 800)]}
    assert _read("rows_s", ranges, jobs=1) == pytest.approx(500e-6)


@pytest.mark.parametrize("metric", NEW)
def test_nothing_to_read_without_the_span(metric):
    ranges = {"ingest.fetch": [(2, 0, 300)], "emit": [(1, 0, 500)],
              "bench.construct": [(1, 500, 600)]}
    assert _read(metric, ranges) is None
