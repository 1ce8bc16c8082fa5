"""Per-stage wall-clock: the report block every pipeline run prints.

A stage is timed on the host clock. Device work is asynchronous, so a
caller that times device work ends its stage with a device synchronize
(the driver does); otherwise the stage measures the enqueue. Each stage
is also a ``torch.profiler.record_function`` range of the same name, so
a profiler window over a run can split each stage's host and device time.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, List

from torch.profiler import record_function

__all__ = ["StageTimer"]


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
