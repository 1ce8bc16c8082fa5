"""The port's own spans: the hand-off waits of ingest and the feed, the
per-sample host loops, and the tracer's clock.

A ``pca`` job under a CPU ``torch.profiler`` over every thread opens
``callsets.index`` and the ``rows.*`` ranges once each on the job's
thread (with an ``-pca.tsv`` file too, and on the rows' Python route), a
``feed.wait`` range a block pulled from the feed and a ``shard.wait`` range
a shard pulled from the fetch pool, each with one more for the pull that
finds the end.
:func:`obs.waited` closes its span before it yields, so the consumer's
work is never counted as waiting. A ``--trace-out`` file and a
``--trace-dir`` profiler trace of one run place a span at the same
instant, each against its own ``baseTimeNanoseconds``.
"""

import collections
import contextlib
import io
import json
import os
import threading
import time

import pytest
import torch

from spark_examples_tpu_torch import obs
from spark_examples_tpu_torch.cli import main as cli
from spark_examples_tpu_torch.genomics.fixtures import (
    DEFAULT_VARIANT_SET_ID,
    synthetic_cohort,
)
from spark_examples_tpu_torch.genomics.sources import JsonlSource
from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
from spark_examples_tpu_torch.utils.config import PcaConfig
from spark_examples_tpu_torch.utils.tracing import (
    CALLSETS_INDEX,
    FEED_WAIT,
    GRAMIAN_ACCUMULATE,
    INGEST_FETCH,
    ROWS_SORT,
    ROWS_TUPLES,
    ROWS_WRITE,
    SHARD_WAIT,
    SKETCH_ACCUMULATE,
)

ONCE_A_JOB = (CALLSETS_INDEX, ROWS_TUPLES, ROWS_SORT, ROWS_WRITE)


def _profiled_job(root, **conf):
    """Construct and run one job under a CPU profiler over every thread:
    ``{name: [thread, ...]}`` of its ranges, and the job's thread."""
    from torch.profiler import ProfilerActivity, profile

    with profile(
        activities=[ProfilerActivity.CPU],
        experimental_config=torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True),
    ) as prof, contextlib.redirect_stdout(io.StringIO()):
        VariantsPcaDriver(
            PcaConfig(device="cpu", variant_set_ids=[DEFAULT_VARIANT_SET_ID],
                      bases_per_partition=20000, block_variants=64, **conf),
            JsonlSource(root),
        ).run()
    threads = collections.defaultdict(list)
    for e in prof.events():
        threads[e.name].append(e.thread)
    (job_thread,) = threads["ingest+gramian"]
    return threads, job_thread


@pytest.fixture(scope="module")
def cohort_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cohort"))
    synthetic_cohort(48, 400, seed=3, population_structure=2).dump(root)
    return root


@pytest.mark.parametrize("workers", [1, 3])
def test_a_dense_job_names_its_waits_and_its_row_loops(cohort_dir, workers):
    threads, job = _profiled_job(cohort_dir, pca_mode="auto",
                                 ingest_workers=workers)
    for name in ONCE_A_JOB:
        assert threads[name] == [job], name
    blocks = len(threads[GRAMIAN_ACCUMULATE])
    shards = len(threads[INGEST_FETCH])
    assert blocks > 1 and shards > 1
    # One a block or shard pulled, and one for the pull that finds the end.
    assert len(threads[FEED_WAIT]) == blocks + 1
    assert set(threads[FEED_WAIT]) == {job}
    assert len(threads[SHARD_WAIT]) == shards + 1
    if workers > 1:  # the builder pool's feeder thread slices the windows
        assert job not in threads[SHARD_WAIT]


def test_a_sketch_job_waits_for_shards_on_its_own_thread(cohort_dir):
    threads, job = _profiled_job(cohort_dir, pca_mode="sketch",
                                 sketch_power_iters=1)
    for name in ONCE_A_JOB:
        assert threads[name] == [job], name
    passes = len(threads[SKETCH_ACCUMULATE])
    shards = len(threads[INGEST_FETCH])
    assert passes >= 2 and shards > passes
    # Every pass re-streams the shards, each stream one pull past its end.
    assert len(threads[SHARD_WAIT]) == shards + passes
    assert set(threads[SHARD_WAIT]) == {job}
    assert FEED_WAIT not in threads


def test_a_job_writing_its_tsv_opens_each_row_range_once(cohort_dir,
                                                         tmp_path):
    threads, job = _profiled_job(cohort_dir, pca_mode="auto",
                                 output_path=str(tmp_path / "run"))
    for name in ONCE_A_JOB:
        assert threads[name] == [job], name
    assert (tmp_path / "run-pca.tsv").stat().st_size > 0


def test_the_python_rows_open_each_row_range_once(cohort_dir, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    driver = VariantsPcaDriver(
        PcaConfig(device="cpu", variant_set_ids=[DEFAULT_VARIANT_SET_ID],
                  bases_per_partition=20000,
                  output_path=str(tmp_path / "run")),
        JsonlSource(cohort_dir),
    )
    with contextlib.redirect_stdout(io.StringIO()):
        rows = driver.run()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            driver.emit_result(rows, native=False)
    names = collections.Counter(e.name for e in prof.events())
    assert names[ROWS_SORT] == 1 and names[ROWS_WRITE] == 1
    assert names[ROWS_TUPLES] == 0


def _items(n, produce_s, closed):
    try:
        for i in range(n):
            time.sleep(produce_s)
            yield i
    finally:
        closed.set()


def test_waited_counts_the_producer_and_not_the_consumer():
    closed = threading.Event()
    with obs.telemetry_session() as session:
        got = []
        for item in obs.waited(_items(3, 0.03, closed), "test.wait"):
            with obs.span("test.work"):  # the consumer's own work
                time.sleep(0.05)
                got.append(item)
        events = session.tracer.to_chrome()["traceEvents"]
    assert got == [0, 1, 2] and closed.is_set()
    waits = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e["name"] == "test.wait"]
    work = [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e["name"] == "test.work"]
    assert len(waits) == 4 and len(work) == 3  # three items and the end
    # Each item's pull holds the producer's 30 ms, and no wait overlaps
    # the consumer's work.
    assert all(d >= 30e3 * 0.99 for d in sorted(b - a for a, b in waits)[1:])
    assert all(wb <= ka or kb <= wa for wa, wb in waits for ka, kb in work)


def test_waited_closes_what_it_wraps_when_abandoned():
    closed = threading.Event()
    pulls = obs.waited(_items(5, 0.0, closed), "test.wait")
    assert next(pulls) == 0
    pulls.close()
    assert closed.is_set()


def test_waited_passes_a_producer_error_on():
    def failing():
        yield 1
        raise IOError("shard lost")

    pulls = obs.waited(failing(), "test.wait")
    assert next(pulls) == 1
    with pytest.raises(IOError, match="shard lost"):
        next(pulls)


def _start_ns(doc, name):
    event = next(e for e in doc["traceEvents"]
                 if e.get("name") == name and e.get("ph") == "X")
    return event["ts"] * 1000 + doc["baseTimeNanoseconds"]


def test_trace_out_and_trace_dir_share_one_clock(tmp_path, capsys):
    trace_out = tmp_path / "run.trace.json"
    trace_dir = tmp_path / "profile"
    assert cli.main([
        "pca", "--fixture-samples", "24", "--fixture-variants", "300",
        "--fixture-seed", "5", "--bases-per-partition", "20000",
        "--block-variants", "32", "--device", "cpu",
        "--trace-out", str(trace_out), "--trace-dir", str(trace_dir),
    ]) == 0
    capsys.readouterr()
    (profile,) = [f for f in os.listdir(trace_dir)
                  if f.endswith(".pt.trace.json")]
    with open(trace_out) as f:
        ours = json.load(f)
    with open(trace_dir / profile) as f:
        theirs = json.load(f)
    gap_ns = abs(_start_ns(ours, "ingest+gramian")
                 - _start_ns(theirs, "ingest+gramian"))
    assert gap_ns < 1e6
    assert abs(ours["baseTimeNanoseconds"] / 1e9 - time.time()) < 600
