"""Telemetry session: ties tracer + registry + manifest to one run.

The JAX package's ``obs/session.py`` on PyTorch (it has no XLA compile
records to switch). The CLI (``--trace-out/--metrics-out/--manifest-out``)
opens exactly one session per process run. Entering a session installs a
fresh ambient tracer and registry and ACTIVATES collection (the
module-level ``span``/``instant``/RPC helpers stop being no-ops); exiting
writes whichever artifacts were requested — on the failure path too, so a
crashed run still leaves its partial timeline behind.

:func:`flush_telemetry` writes the artifacts of the currently-active
session immediately, for fail-stop paths.
"""

from __future__ import annotations

import sys
import threading
from typing import Any, Dict, Optional

from spark_examples_tpu_torch.obs import metrics as _metrics
from spark_examples_tpu_torch.obs import tracer as _tracer
from spark_examples_tpu_torch.obs.manifest import (
    build_manifest,
    write_manifest,
)

__all__ = ["TelemetrySession", "telemetry_session", "flush_telemetry"]

_current: Optional["TelemetrySession"] = None
_current_lock = threading.Lock()


class TelemetrySession:
    """Context manager owning one run's telemetry surfaces."""

    def __init__(
        self,
        trace_out: Optional[str] = None,
        metrics_out: Optional[str] = None,
        manifest_out: Optional[str] = None,
        config: Optional[Dict[str, Any]] = None,
        command: str = "",
        extra: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.trace_out = trace_out
        self.metrics_out = metrics_out
        self.manifest_out = manifest_out
        self.config = dict(config or {})
        self.command = command
        self.extra: Dict[str, Any] = dict(extra or {})
        self.tracer = _tracer.SpanTracer()
        self.registry = _metrics.MetricsRegistry()
        self._root = None

    # -- lifecycle ----------------------------------------------------------

    def __enter__(self) -> "TelemetrySession":
        global _current
        _tracer.set_tracer(self.tracer, active=True)
        _metrics.set_registry(self.registry)
        with _current_lock:
            _current = self
        # The run-root span's lifetime IS the session's, so open/close
        # mirror __enter__/__exit__ instead of a `with` block.
        self._root = self.tracer.span("run", command=self.command)
        self._root.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        global _current
        if self._root is not None:
            self._root.__exit__(exc_type, exc, tb)
            self._root = None
        if exc_type is not None:
            self.tracer.instant(
                "run_failed", scope="g", error=repr(exc)
            )
            self.extra.setdefault("outcome", "error")
            self.extra.setdefault("error", repr(exc))
        else:
            self.extra.setdefault("outcome", "ok")
        try:
            self.flush()
        finally:
            with _current_lock:
                _current = None
            _tracer.set_tracer(None)
            _metrics.set_registry(None)
        return False

    # -- output -------------------------------------------------------------

    def flush(self) -> None:
        """Write every requested artifact now (idempotent)."""
        if self.trace_out:
            self.tracer.write(self.trace_out)
        if self.metrics_out:
            self.registry.write_prometheus(self.metrics_out)
            # The JSONL sink rides next to the exposition: same name,
            # .jsonl suffix, one snapshot line appended per flush.
            self.registry.write_jsonl(self.metrics_out + ".jsonl")
        if self.manifest_out:
            write_manifest(self.manifest_out, self.manifest())

    def manifest(self) -> Dict[str, Any]:
        return build_manifest(
            config=self.config,
            tracer=self.tracer,
            registry=self.registry,
            command=self.command,
            extra=self.extra,
        )


def telemetry_session(**kwargs: Any) -> TelemetrySession:
    """Sugar: ``with telemetry_session(trace_out=...) as s:``."""
    return TelemetrySession(**kwargs)


def flush_telemetry(reason: str = "") -> None:
    """Best-effort immediate flush of the active session (fail-stop
    paths: called before ``os._exit`` so the timeline survives)."""
    with _current_lock:
        session = _current
    if session is None:
        return
    try:
        if reason:
            session.tracer.instant("flush", scope="p", reason=reason)
        session.flush()
    except Exception:  # a dying process must not fail for want of a trace
        print("WARNING: telemetry flush failed", file=sys.stderr)
