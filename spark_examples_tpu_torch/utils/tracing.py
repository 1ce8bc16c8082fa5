"""Per-stage wall-clock: the report block every pipeline run prints.

A stage is timed on the host clock. Device work is asynchronous, so a
caller that times device work ends its stage with a device synchronize
(the driver does); otherwise the stage measures the enqueue. Each stage
is also a ``torch.profiler.record_function`` range of the same name, so
a profiler window over a run can split each stage's host and device time.

Inside the dense-blockwise Gramian three more ranges, named after the JAX
package's spans, split the ingest stage: :data:`INGEST_PACK` (the host
bit-pack of one block, in the feed's producer thread), :data:`INGEST_PUT`
(staging one block into pinned memory and enqueueing its copy) and
:data:`GRAMIAN_ACCUMULATE` (enqueueing one block's unpack, product and
add). The sketch engine has three of its own: :data:`SKETCH_ACCUMULATE`
(one streamed pass over the windows), :data:`SKETCH_WINDOW` (one window's
panel update) and :data:`SKETCH_FINISH` (the host float64 eigensolve).

The CSR-direct ingest of an on-disk cohort adds the JAX package's ingest
spans as ranges: :data:`INGEST_STREAM` (the whole shard stream),
:data:`INGEST_FETCH` (one shard's sidecar extraction) and
:data:`INGEST_BUILD` (one CSR window built into a bit-packed block, in a
builder thread); and a source's per-shard extraction is an
:func:`rpc_range` (the JAX package's ``rpc_timer`` latency sample).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, List

from torch.profiler import record_function

__all__ = [
    "GRAMIAN_ACCUMULATE",
    "INGEST_BUILD",
    "INGEST_FETCH",
    "INGEST_PACK",
    "INGEST_PUT",
    "INGEST_STREAM",
    "SKETCH_ACCUMULATE",
    "SKETCH_FINISH",
    "SKETCH_WINDOW",
    "StageTimer",
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


def rpc_range(transport: str, method: str) -> record_function:
    """The range of one source request, named ``<transport>.<method>``
    (``jsonl.stream_carrying_csr``)."""
    return record_function(f"{transport}.{method}")


class StageTimer:
    """Accumulates wall-clock per named stage; prints a report block.

    Stages may also attach short diagnostic notes (e.g. the spectral gap
    ratio of the eigensolve) which print alongside the timings. The report
    format is the JAX package's.
    """

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = {}
        self.notes: Dict[str, List[str]] = {}
        self._stack: List[str] = []

    def note(self, text: str) -> None:
        """Attach a note to the currently running stage ("" outside any
        stage, which still prints)."""
        key = self._stack[-1] if self._stack else ""
        self.notes.setdefault(key, []).append(text)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        self._stack.append(name)
        try:
            with record_function(name):
                yield
        finally:
            self._stack.pop()
            self.seconds[name] = (
                self.seconds.get(name, 0.0) + time.perf_counter() - t0
            )

    def report(self) -> str:
        total = sum(self.seconds.values())
        lines = ["Stage wall-clock", "----------------"]
        for name, secs in self.seconds.items():
            pct = 100.0 * secs / total if total else 0.0
            lines.append(f"{name}: {secs:.3f}s ({pct:.1f}%)")
            lines.extend(f"  {n}" for n in self.notes.get(name, ()))
        lines.extend(f"{n}" for n in self.notes.get("", ()))
        lines.append(f"total: {total:.3f}s")
        return "\n".join(lines)
