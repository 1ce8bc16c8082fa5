"""Unified telemetry: span tracing, metrics registry, run manifests.

The JAX package's ``obs`` package on PyTorch. Three pillars:

1. **Span tracer** (:mod:`.tracer`): thread-safe spans/instants emitted as
   Chrome trace-event JSON (Perfetto, TensorBoard), each span also one
   ``torch.profiler.record_function`` range so host-side spans line up
   with device traces on one timeline. ``utils.tracing.StageTimer`` records
   through it.
2. **Metrics registry** (:mod:`.metrics`): counters, gauges and latency
   histograms with a Prometheus text exposition and a JSONL sink. The
   ``IoStats`` parity accumulators surface here through a collector; the
   HTTP transport feeds ``genomics_rpc_latency_seconds``.
3. **Run manifest** (:mod:`.manifest`): one machine-readable JSON artifact
   per run — config, torch/CUDA devices, stage timings, counters,
   histogram summaries.

A crash flight recorder (:mod:`.flightrec`) keeps the last span, instant
and metric transitions per thread whether or not a session is active; the
analysis server installs it beside its job journal.

Ambient use: the CLI (``--trace-out/--metrics-out/--manifest-out``) opens a
:func:`telemetry_session`; library code records through the module-level
``span``/``instant``/``observe_rpc`` helpers, which collect nothing when no
session is active.
"""

from spark_examples_tpu_torch.obs import flightrec
from spark_examples_tpu_torch.obs.tracer import (
    SpanTracer,
    collection_active,
    counter,
    current_trace_id,
    get_tracer,
    instant,
    set_tracer,
    span,
    trace_context,
)
from spark_examples_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    count_retry,
    get_registry,
    observe_rpc,
    register_collector,
    rpc_timer,
    set_registry,
)
from spark_examples_tpu_torch.obs.manifest import (
    build_manifest,
    write_manifest,
)
from spark_examples_tpu_torch.obs.session import (
    TelemetrySession,
    flush_telemetry,
    telemetry_session,
)

__all__ = [
    "flightrec",
    "SpanTracer",
    "collection_active",
    "counter",
    "current_trace_id",
    "get_tracer",
    "set_tracer",
    "span",
    "instant",
    "trace_context",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "count_retry",
    "get_registry",
    "set_registry",
    "register_collector",
    "rpc_timer",
    "observe_rpc",
    "build_manifest",
    "write_manifest",
    "TelemetrySession",
    "telemetry_session",
    "flush_telemetry",
]
