"""Ingest observability — the accumulator system.

Parity with ``VariantsRddStats`` (VariantsRDD.scala:160-180): named
counters fed by the data plane and pretty-printed as a block at job end
(``VariantsCommon.scala:68-73``). Counters are per-process; threads share
them through a lock. The ``report()`` block is byte-identical to the
reference's.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

__all__ = ["IoStats", "COUNTER_FIELDS"]

# The accumulator fields, in report() order.
COUNTER_FIELDS = (
    "partitions",
    "reference_bases",
    "requests",
    "unsuccessful_responses",
    "io_exceptions",
    "variants_read",
    "reads_read",
)


@dataclass(eq=False)
class IoStats:
    partitions: int = 0
    reference_bases: int = 0
    requests: int = 0
    unsuccessful_responses: int = 0
    io_exceptions: int = 0
    variants_read: int = 0
    reads_read: int = 0
    _lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    def add(self, **deltas: int) -> None:
        with self._lock:
            for name, d in deltas.items():
                setattr(self, name, getattr(self, name) + d)

    def report(self) -> str:
        """The formatted block of VariantsRDD.scala:168-180."""
        return (
            "Variants API stats\n"
            "------------------\n"
            f"# of partitions: {self.partitions}\n"
            f"# of reference bases requested: {self.reference_bases}\n"
            f"# of API requests: {self.requests}\n"
            f"# of unsuccessful responses: {self.unsuccessful_responses}\n"
            f"# of IO exceptions: {self.io_exceptions}\n"
            f"# of variants read: {self.variants_read}\n"
            f"# of reads read: {self.reads_read}\n"
        )
