"""Ingest observability — the accumulator system.

Parity with ``VariantsRddStats`` (VariantsRDD.scala:160-180): named
counters fed by the data plane and pretty-printed as a block at job end
(``VariantsCommon.scala:68-73``). Counters are per-process; threads share
them through a lock. The ``report()`` block is byte-identical to the
reference's.

Registry backing, the JAX package's: every live ``IoStats`` instance is
visible to the telemetry metrics registry
(:mod:`spark_examples_tpu_torch.obs.metrics`) as
``genomics_io_<counter>_total``, summed over instances by a collector
evaluated at scrape/manifest time, not on the hot path (``add`` runs once
per ingested record).
"""

from __future__ import annotations

import threading
import weakref
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


# Live instances for the registry collector (weak: a dropped source's
# stats must not leak). A dying instance retires its final counts into
# ``_retired`` from ``__del__``, so a source collected before the run's
# manifest is written still contributes its records.
_instances: "weakref.WeakSet[IoStats]" = weakref.WeakSet()
_retired = dict.fromkeys(COUNTER_FIELDS, 0)
_retired_lock = threading.Lock()


def _collect_io_stats():
    """Registry collector: counters summed over live + retired IoStats."""
    with _retired_lock:
        totals = dict(_retired)
    for inst in list(_instances):
        for name in COUNTER_FIELDS:
            totals[name] += getattr(inst, name)
    for name in COUNTER_FIELDS:
        yield (
            f"genomics_io_{name}_total",
            "counter",
            f"IoStats accumulator '{name}' summed over sources "
            "(VariantsRDD.scala:160-180 parity counters)",
            {},
            float(totals[name]),
        )


def _register_collector() -> None:
    from spark_examples_tpu_torch.obs.metrics import register_collector

    register_collector(_collect_io_stats)


_register_collector()


# eq=False keeps the default identity hash: instances live in the
# collector's WeakSet.
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

    def __post_init__(self) -> None:
        _instances.add(self)

    @classmethod
    def untracked(cls) -> "IoStats":
        """An instance invisible to the registry collector, for merged
        views (``allreduce_host_stats``) whose counts are copies of
        tracked instances: tracking them would count a multi-process
        run's ``genomics_io_*_total`` twice."""
        inst = cls()
        _instances.discard(inst)
        inst._untracked = True
        return inst

    def __del__(self) -> None:
        try:
            if getattr(self, "_untracked", False):
                return
            with _retired_lock:
                for name in COUNTER_FIELDS:
                    _retired[name] += getattr(self, name)
        except Exception:  # interpreter shutdown: module globals are gone
            pass

    def add(self, **deltas: int) -> None:
        with self._lock:
            for name, d in deltas.items():
                setattr(self, name, getattr(self, name) + d)

    def as_vector(self):
        """The counters in :data:`COUNTER_FIELDS` order, for merging
        across processes."""
        return [getattr(self, f) for f in COUNTER_FIELDS]

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
