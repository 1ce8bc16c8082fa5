"""Per-stage wall-clock: the report block every pipeline run prints.

A stage is timed on the host clock. Device work is asynchronous, so a
caller that times device work ends its stage with a device synchronize
(the driver does); otherwise the stage measures the enqueue. Each stage is
an ambient :func:`spark_examples_tpu_torch.obs.span` — one
``torch.profiler.record_function`` range of the same name, so a profiler
window over a run can split each stage's host and device time, and a
trace event when a telemetry session collects — and each note an instant
event, as in the JAX package.

The span names of the ingest and Gramian layers, the JAX package's, live
here so the code that opens them and the measurement scripts that read
their profiler ranges agree. Inside the dense-blockwise Gramian three
split the ingest stage: :data:`INGEST_PACK` (the host bit-pack of one
block, in the feed's producer thread), :data:`INGEST_PUT` (staging one
block into pinned memory and enqueueing its copy) and
:data:`GRAMIAN_ACCUMULATE` (enqueueing one block's unpack, product and
add). The sketch engine has three of its own: :data:`SKETCH_ACCUMULATE`
(one streamed pass over the windows), :data:`SKETCH_WINDOW` (one window's
panel update) and :data:`SKETCH_FINISH` (the host float64 eigensolve).
The CSR-direct ingest has :data:`INGEST_STREAM` (the whole shard stream),
:data:`INGEST_FETCH` (one shard's extraction, from the sidecar or the
wire) and :data:`INGEST_BUILD` (one CSR window built into a bit-packed
block, in a builder thread); and a source's per-shard extraction is an
:func:`rpc_range` (the JAX package's ``rpc_timer`` latency sample).

The port's own spans, which the JAX package does not open, name what the
stages above leave unlabelled. Two are waits at a hand-off, each pull an
:func:`~spark_examples_tpu_torch.obs.waited` span: :data:`FEED_WAIT`
(the product's thread waiting for the feed's next staged block) and
:data:`SHARD_WAIT` (the window slicer waiting on the fetch pool for the
next shard's CSR pair). The rest wrap the per-sample host loops, once each
a job, never per row: :data:`CALLSETS_INDEX` (the callset table read and
built), :data:`ROWS_TUPLES` (the coordinates made rows), :data:`ROWS_SORT`
(the rows named and sorted) and :data:`ROWS_WRITE` (the rows printed and
written). Two split the eigensolve of a tile grid: :data:`PCOA_TILES_SUMS`
(G's row sums read from the tiles, once a job) and
:data:`PCOA_TILES_PRODUCT` (one product C·Q of the implicitly centred
grid against the iteration's panel).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

from spark_examples_tpu_torch import obs

__all__ = [
    "CALLSETS_INDEX",
    "FEED_WAIT",
    "GRAMIAN_ACCUMULATE",
    "INGEST_BUILD",
    "INGEST_FETCH",
    "INGEST_PACK",
    "INGEST_PUT",
    "INGEST_STREAM",
    "PCOA_TILES_PRODUCT",
    "PCOA_TILES_SUMS",
    "SKETCH_ACCUMULATE",
    "SKETCH_FINISH",
    "ROWS_SORT",
    "ROWS_TUPLES",
    "ROWS_WRITE",
    "SHARD_WAIT",
    "SKETCH_WINDOW",
    "StageTimer",
    "profiler_trace",
    "rpc_range",
]

INGEST_PACK = "ingest.pack"
INGEST_PUT = "ingest.put"
INGEST_STREAM = "ingest.stream"
INGEST_FETCH = "ingest.fetch"
INGEST_BUILD = "ingest.build"
GRAMIAN_ACCUMULATE = "gramian.accumulate"
SKETCH_ACCUMULATE = "gramian.sketch.accumulate"
SKETCH_WINDOW = "gramian.sketch.window"
SKETCH_FINISH = "gramian.sketch.finish"
FEED_WAIT = "feed.wait"
SHARD_WAIT = "shard.wait"
CALLSETS_INDEX = "callsets.index"
ROWS_TUPLES = "rows.tuples"
ROWS_SORT = "rows.sort"
ROWS_WRITE = "rows.write"
PCOA_TILES_SUMS = "pcoa.tiles.sums"
PCOA_TILES_PRODUCT = "pcoa.tiles.product"


@contextlib.contextmanager
def rpc_range(transport: str, method: str) -> Iterator[None]:
    """One source request: a span named ``<transport>.<method>``
    (``jsonl.stream_carrying_csr``) and, under a telemetry session, a
    ``genomics_rpc_latency_seconds`` sample (``obs.rpc_timer``)."""
    with obs.span(f"{transport}.{method}"), obs.rpc_timer(
        transport, method
    ):
        yield


@contextlib.contextmanager
def profiler_trace(trace_dir: Optional[str], device=None) -> Iterator[None]:
    """A ``torch.profiler`` trace of the block when a directory is given
    (``--trace-dir``), no-op otherwise: CPU activity on every thread (the
    feed's producer and the block builders too), and CUDA activity when
    ``device`` is the card. The trace is written into ``trace_dir`` as
    ``<host>_<pid>.<ns>.pt.trace.json`` (Chrome trace events, read by
    Perfetto) by ``tensorboard_trace_handler``, which needs no tensorboard
    package. Every obs span is a ``record_function`` range, so the trace
    splits each stage's host and device time by name."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(
        activities=activities,
        on_trace_ready=tensorboard_trace_handler(trace_dir),
        experimental_config=torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True
        ),
    ):
        yield


class StageTimer:
    """Accumulates wall-clock per named stage; prints a report block.

    Stages may also attach short diagnostic notes (e.g. the spectral gap
    ratio of the eigensolve) which print alongside the timings. The report
    format is the JAX package's.

    Thread-safe: the active-stage stack is thread-local and the
    ``seconds``/``notes`` accumulation is lock-guarded, so the same stage
    name timed on several threads sums correctly.
    """

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = {}
        self.notes: Dict[str, List[str]] = {}
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def note(self, text: str) -> None:
        """Attach a note to the currently running stage ("" outside any
        stage, which still prints); also an instant event on the trace."""
        stack = self._stack()
        key = stack[-1] if stack else ""
        with self._lock:
            self.notes.setdefault(key, []).append(text)
        obs.instant("note", stage=key, text=text)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        self._stack().append(name)
        try:
            with obs.span(name):
                yield
        finally:
            self._stack().pop()
            dt = time.perf_counter() - t0
            with self._lock:
                self.seconds[name] = self.seconds.get(name, 0.0) + dt

    def report(self) -> str:
        with self._lock:
            seconds = dict(self.seconds)
            notes = {k: list(v) for k, v in self.notes.items()}
        total = sum(seconds.values())
        lines = ["Stage wall-clock", "----------------"]
        for name, secs in seconds.items():
            pct = 100.0 * secs / total if total else 0.0
            lines.append(f"{name}: {secs:.3f}s ({pct:.1f}%)")
            lines.extend(f"  {n}" for n in notes.get(name, ()))
        lines.extend(f"{n}" for n in notes.get("", ()))
        lines.append(f"total: {total:.3f}s")
        return "\n".join(lines)
