"""Metrics registry: counters, gauges, latency histograms.

The JAX package's ``obs/metrics.py``, unchanged in behaviour. Two output
surfaces, one store:

- :meth:`MetricsRegistry.to_prometheus` — the Prometheus text exposition
  format (``# HELP``/``# TYPE`` + samples; histograms as cumulative
  ``_bucket{le=...}`` + ``_sum`` + ``_count``), scrape-able or dump-able
  to a file next to a run;
- :meth:`MetricsRegistry.snapshot` / :meth:`write_jsonl` — a
  machine-readable dict (one JSONL line per dump) the run manifest
  embeds, with histogram summaries (count/sum/mean + bucket-interpolated
  p50/p90/p99) instead of raw bucket vectors.

Concurrency model: one lock per metric child guards its numeric state;
label-child creation is guarded by the parent metric's lock; registry
registration by the registry lock. ``inc``/``observe`` are safe from any
thread.

**Collectors** keep the ingest accumulators off the hot path:
``utils.stats.IoStats`` increments per record, so backing each ``add``
onto a registry counter would double the ingest locking cost for a number
nobody reads mid-flight. Instead a collector callback — registered once at
import by ``utils/stats.py`` — sums every live ``IoStats`` instance at
*collection* time, so the parity accumulators appear in every exposition
and manifest at zero per-record cost. Collectors are module-global: any
registry (a session's fresh one included) sees them.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from spark_examples_tpu_torch.obs import flightrec

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "set_registry",
    "register_collector",
    "rpc_timer",
    "observe_rpc",
    "count_retry",
    "DEFAULT_LATENCY_BUCKETS",
]

# Latency buckets (seconds) sized for this system's two regimes: local
# index slices (~µs-ms) and remote shard streams (~0.1-60 s; the round-5
# stalls sat at >60 s, which lands in the +Inf bucket — visible).
DEFAULT_LATENCY_BUCKETS = (
    0.0005,
    0.002,
    0.01,
    0.05,
    0.1,
    0.25,
    0.5,
    1.0,
    2.5,
    5.0,
    10.0,
    30.0,
    60.0,
)

LabelItems = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelItems:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _format_labels(items: LabelItems, extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in items]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Metric:
    """Shared parent: name/help, children keyed by label items."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str = "") -> None:
        self.name = name
        self.help = help_text
        self._lock = threading.Lock()
        self._children: Dict[LabelItems, "_Metric"] = {}

    def labels(self, **labels: str):
        """The child metric for this label set (created on first use)."""
        key = _label_key(labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child()
                # Children carry the family name so per-write taps (the
                # flight recorder) can attribute deltas; exposition still
                # renders from the parent's name + label items.
                child.name = self.name
            return child

    def _make_child(self) -> "_Metric":
        raise NotImplementedError

    def _items(self) -> List[Tuple[LabelItems, "_Metric"]]:
        """(label items, leaf) pairs — the unlabeled self when no child
        was ever created, else every labeled child."""
        with self._lock:
            if self._children:
                return sorted(self._children.items())
        return [((), self)]


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str = "", help_text: str = "") -> None:
        super().__init__(name, help_text)
        self._value = 0.0

    def _make_child(self) -> "Counter":
        return Counter()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount
        # Outside the lock: the flight recorder is lock-free per thread
        # and must never widen a metric's critical section.
        if flightrec.get_recorder() is not None and self.name:
            flightrec.note("metric", self.name, {"delta": amount})

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name: str = "", help_text: str = "") -> None:
        super().__init__(name, help_text)
        self._value = 0.0

    def _make_child(self) -> "Gauge":
        return Gauge()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)
        if flightrec.get_recorder() is not None and self.name:
            flightrec.note("metric", self.name, {"value": float(value)})

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount
        if flightrec.get_recorder() is not None and self.name:
            flightrec.note("metric", self.name, {"delta": amount})

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram(_Metric):
    """Fixed-bucket latency histogram (cumulative Prometheus semantics)."""

    kind = "histogram"

    def __init__(
        self,
        name: str = "",
        help_text: str = "",
        buckets: Tuple[float, ...] = DEFAULT_LATENCY_BUCKETS,
    ) -> None:
        super().__init__(name, help_text)
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # +Inf last
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf

    def _make_child(self) -> "Histogram":
        return Histogram(buckets=self.buckets)

    def observe(self, value: float) -> None:
        import bisect

        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value

    @contextlib.contextmanager
    def time(self) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(time.perf_counter() - t0)

    def _state(
        self,
    ) -> Tuple[List[int], float, int, float, float]:
        with self._lock:
            return list(self._counts), self._sum, self._count, self._min, self._max

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile estimate (0 when empty)."""
        counts, _, total, mn, mx = self._state()
        if total == 0:
            return 0.0
        target = q * total
        cum = 0
        lo = 0.0
        for i, c in enumerate(counts):
            hi = (
                self.buckets[i]
                if i < len(self.buckets)
                else max(mx, lo)  # +Inf bucket: clamp to observed max
            )
            if cum + c >= target:
                if c == 0:
                    return hi
                frac = (target - cum) / c
                return lo + frac * (hi - lo)
            cum += c
            lo = hi
        return mx if mx > -math.inf else 0.0

    def summary(self) -> Dict[str, float]:
        counts, s, total, mn, mx = self._state()
        out = {
            "count": total,
            "sum": s,
            "mean": (s / total) if total else 0.0,
            "min": mn if total else 0.0,
            "max": mx if total else 0.0,
        }
        for q, label in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
            out[label] = self.quantile(q)
        return out


# -- collectors (module-global; see module docstring) ------------------------

_collectors: List[Callable[[], Iterator[Tuple[str, str, str, Dict[str, str], float]]]] = []
_collectors_lock = threading.Lock()


def register_collector(fn) -> None:
    """Register ``fn() -> iterable of (name, kind, help, labels, value)``
    evaluated at every exposition/snapshot of ANY registry."""
    with _collectors_lock:
        if fn not in _collectors:
            _collectors.append(fn)


def _collect() -> List[Tuple[str, str, str, Dict[str, str], float]]:
    with _collectors_lock:
        fns = list(_collectors)
    samples = []
    for fn in fns:
        try:
            samples.extend(fn())
        except Exception:  # pragma: no cover - a broken collector must
            continue  # never take down an exposition
    return samples


class MetricsRegistry:
    """Named metrics + the exposition/snapshot surfaces."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, name: str, factory, kind: str):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            elif m.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}"
                )
            return m

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._get_or_create(
            name, lambda: Counter(name, help_text), "counter"
        )

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._get_or_create(
            name, lambda: Gauge(name, help_text), "gauge"
        )

    def histogram(
        self,
        name: str,
        help_text: str = "",
        buckets: Tuple[float, ...] = DEFAULT_LATENCY_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(
            name, lambda: Histogram(name, help_text, buckets), "histogram"
        )

    def _metrics_list(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    # -- Prometheus text exposition -----------------------------------------

    def to_prometheus(self) -> str:
        lines: List[str] = []
        for m in self._metrics_list():
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for items, leaf in m._items():
                if isinstance(leaf, Histogram):
                    counts, s, total, _, _ = leaf._state()
                    cum = 0
                    for i, c in enumerate(counts):
                        cum += c
                        le = (
                            repr(leaf.buckets[i])
                            if i < len(leaf.buckets)
                            else "+Inf"
                        )
                        le_label = f'le="{le}"'
                        lines.append(
                            f"{m.name}_bucket"
                            f"{_format_labels(items, le_label)} {cum}"
                        )
                    lines.append(
                        f"{m.name}_sum{_format_labels(items)} {s}"
                    )
                    lines.append(
                        f"{m.name}_count{_format_labels(items)} {total}"
                    )
                else:
                    lines.append(
                        f"{m.name}{_format_labels(items)} {leaf.value}"
                    )
        for name, kind, help_text, labels, value in _collect():
            if help_text:
                lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {kind}")
            lines.append(f"{name}{_format_labels(_label_key(labels))} {value}")
        return "\n".join(lines) + "\n"

    # -- machine-readable snapshot ------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """{"counters": {...}, "gauges": {...}, "histograms": {...}} with
        label sets rendered as prometheus-style suffixes."""
        counters: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        histograms: Dict[str, Dict[str, float]] = {}
        for m in self._metrics_list():
            for items, leaf in m._items():
                key = m.name + _format_labels(items)
                if isinstance(leaf, Histogram):
                    histograms[key] = leaf.summary()
                elif isinstance(leaf, Gauge):
                    gauges[key] = leaf.value
                else:
                    counters[key] = leaf.value
        for name, kind, _help, labels, value in _collect():
            key = name + _format_labels(_label_key(labels))
            (gauges if kind == "gauge" else counters)[key] = value
        return {
            "counters": counters,
            "gauges": gauges,
            "histograms": histograms,
        }

    def write_jsonl(self, path: str) -> None:
        """Append one snapshot line (a JSONL metrics sink)."""
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        line = {"ts_unix": time.time(), **self.snapshot()}
        with open(path, "a") as f:
            f.write(json.dumps(line) + "\n")

    def write_prometheus(self, path: str) -> None:
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.to_prometheus())
        os.replace(tmp, path)


# -- ambient registry --------------------------------------------------------

_ambient: Optional[MetricsRegistry] = None


def get_registry() -> MetricsRegistry:
    """The ambient registry (created on first use)."""
    global _ambient
    if _ambient is None:
        _ambient = MetricsRegistry()
    return _ambient


def set_registry(registry: Optional[MetricsRegistry]) -> None:
    global _ambient
    _ambient = registry


# -- RPC instrumentation helpers ---------------------------------------------
#
# One histogram + two counters shared by every transport tier (HTTP,
# gRPC, local/fixture): per-request latency labeled by transport+method,
# a retry counter, and an error counter. Like ``span``/``instant``,
# these are no-ops unless a telemetry session activated collection —
# the telemetry-off contract is one boolean check per hook. With a
# session active the cost is one bisect + one lock per REQUEST (not per
# record), noise next to any actual I/O.


def _active() -> bool:
    from spark_examples_tpu_torch.obs.tracer import collection_active

    return collection_active()


def observe_rpc(
    transport: str,
    method: str,
    seconds: float,
    error: bool = False,
) -> None:
    if not _active():
        return
    reg = get_registry()
    reg.histogram(
        "genomics_rpc_latency_seconds",
        "Per-request latency of genomics source RPCs (shard streams "
        "timed to stream exhaustion)",
    ).labels(transport=transport, method=method).observe(seconds)
    if error:
        reg.counter(
            "genomics_rpc_errors_total",
            "RPCs that raised (served error status or transport failure)",
        ).labels(transport=transport, method=method).inc()


def count_retry(transport: str, method: str) -> None:
    if not _active():
        return
    get_registry().counter(
        "genomics_rpc_retries_total",
        "Transparent transport-level retries (reconnect-and-reissue)",
    ).labels(transport=transport, method=method).inc()


@contextlib.contextmanager
def rpc_timer(transport: str, method: str) -> Iterator[None]:
    """Time one RPC into the shared latency histogram; an exception is
    still timed (and counted as an error). ``GeneratorExit`` — a
    consumer legitimately abandoning a stream mid-way — is timed but not
    counted as an error. No-op (beyond one boolean check) when no
    telemetry session is active."""
    if not _active():
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    except GeneratorExit:
        observe_rpc(transport, method, time.perf_counter() - t0)
        raise
    except BaseException:
        observe_rpc(
            transport, method, time.perf_counter() - t0, error=True
        )
        raise
    observe_rpc(transport, method, time.perf_counter() - t0)
