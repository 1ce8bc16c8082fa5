"""Thread-safe span tracer emitting Chrome trace-event JSON.

The JAX package's ``obs/tracer.py`` on PyTorch. The trace format is the
Chrome/Catapult "trace event" JSON (the ``{"traceEvents": [...]}`` object
form), which Perfetto (ui.perfetto.dev), ``chrome://tracing`` and
TensorBoard load natively — the same container ``torch.profiler`` exports,
so one viewer shows host-side pipeline spans next to device timelines.

Event kinds used:

- ``ph="X"`` complete events — one per finished span, with ``ts``/``dur``
  in microseconds after the tracer's start, which the file gives as
  ``baseTimeNanoseconds`` (Unix-epoch nanoseconds), as ``torch.profiler``'s
  exported trace does: ``ts * 1000 + baseTimeNanoseconds`` is the same
  instant in either file of one run;
- ``ph="i"`` instant events — point-in-time marks (HTTP retries, breaker
  transitions, injected faults) so anomalies are visible ON the timeline;
- ``ph="C"`` counter samples;
- ``ph="M"`` metadata events — the process name.

Concurrency model: the finished-event list and the per-name second
accumulators are guarded by one lock taken only at span *exit*.

Profiler alignment: every ambient :func:`span` is also ONE
``torch.profiler.record_function`` range of the same name, whether or not a
telemetry session collects it, so a ``torch.profiler`` window over a run
splits each span's host and device time by name (``chip_smoke.py`` reads
the ingest and Gramian ranges that way). The tracer itself opens no range.
:func:`waited` puts each pull from an iterable in a span, so a thread's
wait at a hand-off between pipeline stages carries a name.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import threading
import time
from typing import Any, Dict, Iterable, Iterator, List, Optional, TypeVar

from torch.profiler import record_function

from spark_examples_tpu_torch.obs import flightrec

__all__ = [
    "SpanTracer",
    "collection_active",
    "counter",
    "current_trace_id",
    "get_tracer",
    "set_tracer",
    "span",
    "instant",
    "trace_context",
    "waited",
]

T = TypeVar("T")

# Hard cap on buffered events: a runaway per-record span can otherwise
# grow the trace without bound; past the cap events are counted, not
# stored, and the drop count lands in the trace as a final instant.
DEFAULT_MAX_EVENTS = 1_000_000


# -- job-scoped trace context ------------------------------------------------
#
# A context FIELD binds a trace id to the worker thread: every span and
# instant recorded inside carries ``args.trace_id``, so one job's timeline
# can be filtered out of the shared stream.

_trace_ctx = threading.local()


def current_trace_id() -> Optional[str]:
    """The trace id bound to THIS thread (None outside a job)."""
    tid = getattr(_trace_ctx, "trace_id", None)
    return tid if isinstance(tid, str) else None


@contextlib.contextmanager
def trace_context(trace_id: Optional[str]) -> Iterator[None]:
    """Bind ``trace_id`` to the calling thread for the body's duration.

    Nestable and restore-on-exit; ``None`` is a no-op binding so call
    sites need no conditional."""
    prev = getattr(_trace_ctx, "trace_id", None)
    _trace_ctx.trace_id = trace_id if trace_id is not None else prev
    try:
        yield
    finally:
        _trace_ctx.trace_id = prev


class SpanTracer:
    """Collects spans/instants; serializes to Chrome trace-event JSON."""

    def __init__(
        self,
        process_name: str = "spark_examples_tpu_torch",
        max_events: int = DEFAULT_MAX_EVENTS,
    ) -> None:
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._pid = os.getpid()
        # One wall-clock reading at the start; every event time is a
        # perf_counter offset from it.
        self._base_ns = time.time_ns()
        self._t0 = time.perf_counter()
        self._process_name = process_name
        self._max_events = max_events
        self._dropped = 0
        # Aggregates survive even when raw events overflow the cap, so
        # the manifest's stage table is exact for arbitrarily long runs.
        self._seconds: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}

    # -- time ---------------------------------------------------------------

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    # -- recording ----------------------------------------------------------

    def _append(self, event: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._events) >= self._max_events:
                self._dropped += 1
                return
            self._events.append(event)

    @contextlib.contextmanager
    def span(self, name: str, **args: Any) -> Iterator[None]:
        """Record one complete ("X") event around the body.

        Safe from any thread. ``args`` must be JSON-serializable (they
        land in the event's ``args``).
        """
        tid = threading.get_ident()
        trace_id = current_trace_id()
        t_start = self._now_us()
        try:
            yield
        finally:
            dur = self._now_us() - t_start
            event = {
                "name": name,
                "ph": "X",
                "ts": t_start,
                "dur": dur,
                "pid": self._pid,
                "tid": tid,
            }
            if trace_id is not None:
                args.setdefault("trace_id", trace_id)
            if args:
                event["args"] = args
            with self._lock:
                self._seconds[name] = (
                    self._seconds.get(name, 0.0) + dur / 1e6
                )
                self._counts[name] = self._counts.get(name, 0) + 1
                if len(self._events) < self._max_events:
                    self._events.append(event)
                else:
                    self._dropped += 1

    def instant(self, name: str, scope: str = "t", **args: Any) -> None:
        """Record a point-in-time ("i") event: stalls, retries, drops.

        ``scope``: "t" thread, "p" process, "g" global — how tall the
        mark renders in the viewer.
        """
        event = {
            "name": name,
            "ph": "i",
            "ts": self._now_us(),
            "pid": self._pid,
            "tid": threading.get_ident(),
            "s": scope,
        }
        trace_id = current_trace_id()
        if trace_id is not None:
            args.setdefault("trace_id", trace_id)
        if args:
            event["args"] = args
        self._append(event)

    def counter(self, name: str, **series: float) -> None:
        """Record a counter ("C") sample — renders as a stacked area."""
        self._append(
            {
                "name": name,
                "ph": "C",
                "ts": self._now_us(),
                "pid": self._pid,
                "tid": threading.get_ident(),
                "args": dict(series),
            }
        )

    # -- aggregates / output -------------------------------------------------

    def stage_seconds(self) -> Dict[str, float]:
        """Accumulated wall-clock per span name (manifest stage table)."""
        with self._lock:
            return dict(self._seconds)

    def stage_counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def events_for_trace(self, trace_id: str) -> List[Dict[str, Any]]:
        """Time-ordered (by start) events carrying ``args.trace_id ==
        trace_id`` — one job's span timeline pulled out of the shared
        stream."""
        with self._lock:
            events = [
                dict(ev)
                for ev in self._events
                if isinstance(ev.get("args"), dict)
                and ev["args"].get("trace_id") == trace_id
            ]
        events.sort(key=lambda ev: float(ev["ts"]))
        return events

    def to_chrome(self) -> Dict[str, Any]:
        """The Chrome trace-event JSON object (Perfetto-loadable)."""
        meta = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": self._pid,
                "tid": 0,
                "args": {"name": self._process_name},
            }
        ]
        with self._lock:
            events = list(self._events)
            dropped = self._dropped
        if dropped:
            events.append(
                {
                    "name": "tracer_events_dropped",
                    "ph": "i",
                    "ts": self._now_us(),
                    "pid": self._pid,
                    "tid": threading.get_ident(),
                    "s": "p",
                    "args": {"dropped": dropped},
                }
            )
        # Provenance for cross-process merging: which host/OS-pid made
        # this file. The port runs one process on one card, so its
        # process index is always 0.
        other: Dict[str, Any] = {
            "producer": self._process_name,
            "trace_epoch_unix": self._base_ns / 1e9,
            "host": socket.gethostname(),
            "pid": self._pid,
            "process_index": 0,
        }
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "baseTimeNanoseconds": self._base_ns,
            "otherData": other,
        }

    def write(self, path: str) -> None:
        """Write the trace JSON atomically (tmp + rename)."""
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_chrome(), f)
        os.replace(tmp, path)


# -- ambient tracer ----------------------------------------------------------
#
# Library code (ops, transports, resilience) records through the
# module-level helpers below, which collect nothing unless a telemetry
# session activated collection — the data plane pays one attribute read
# (and the span's profiler range) per call when telemetry is off.

_ambient: Optional[SpanTracer] = None
_active: bool = False


def get_tracer() -> SpanTracer:
    """The ambient tracer (created on first use)."""
    global _ambient
    if _ambient is None:
        _ambient = SpanTracer()
    return _ambient


def set_tracer(tracer: Optional[SpanTracer], active: bool = True) -> None:
    """Install (or clear, with ``None``) the ambient tracer.

    ``active`` gates the module-level ``span``/``instant`` helpers; a
    telemetry session sets it True on entry and False on exit.
    """
    global _ambient, _active
    _ambient = tracer
    _active = active and tracer is not None


def collection_active() -> bool:
    return _active


@contextlib.contextmanager
def span(name: str, **args: Any) -> Iterator[None]:
    """Ambient span: one profiler range of ``name`` always, and an event
    in the session tracer while collection is active.

    The flight recorder (when installed) sees the begin/end transitions
    whether or not a session is active — a last-seconds record even with
    full tracing off."""
    flightrec.note("span_begin", name, args or None)
    try:
        with record_function(name):
            if not _active:
                yield
            else:
                with get_tracer().span(name, **args):
                    yield
    finally:
        flightrec.note("span_end", name, None)


def instant(name: str, scope: str = "t", **args: Any) -> None:
    """Ambient instant event: no-op unless a session is active (the
    flight recorder, when installed, always sees it)."""
    flightrec.note("instant", name, args or None)
    if _active:
        get_tracer().instant(name, scope=scope, **args)


def counter(name: str, **series: float) -> None:
    """Ambient counter ("C") sample — a stacked-area track in the viewer
    (queue depth, in-flight jobs). No-op unless a session is active (the
    flight recorder, when installed, records the sample)."""
    flightrec.note("counter", name, series or None)
    if _active:
        get_tracer().counter(name, **series)


def waited(iterable: Iterable[T], name: str) -> Iterator[T]:
    """Yield the items of ``iterable``, each ``next()`` inside a
    :func:`span` of ``name``: the span is the calling thread's wait for the
    producer on the other side of a hand-off (a queue, a worker pool). It
    closes before the item is yielded, so the consumer's own work on the
    item is never counted as waiting; the pull that finds the end opens
    one too. Closing the generator closes ``iterable``'s."""
    it = iter(iterable)
    try:
        while True:
            with span(name):
                try:
                    item = next(it)
                except StopIteration:
                    return
            yield item
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()
