"""Per-endpoint circuit breaker: shed load from a failing tier, probe back.

The JAX package's ``resilience/breaker.py``.

A retry policy alone makes a down endpoint WORSE: thousands of shard
requests each burning their full attempt budget against a dead server
turns one failure into a retry storm. The breaker is the collective
memory the per-call loops lack — after ``failure_threshold``
consecutive retryable failures against one endpoint it OPENS and every
call sheds instantly (:class:`CircuitOpenError`, an ``IOError`` so
existing transport-failure handling applies), until ``cooldown_s``
elapses and the breaker lets a bounded number of HALF-OPEN probes
through: one success closes the circuit, one failure re-opens it and
re-arms the cooldown.

Only *retryable* (infrastructural) failures feed the breaker — a served
404/401 is the endpoint answering, and must never blow the fuse for
requests that would succeed.

Every transition is emitted to the obs timeline
(``breaker_transition`` instants) and the metrics registry
(``resilience_breaker_transitions_total{endpoint,to}``), so a chaos run
or a production stall shows breaker behavior on the run's telemetry
artifacts.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict

__all__ = [
    "BreakerSet",
    "CircuitBreaker",
    "CircuitOpenError",
    "CLOSED",
    "OPEN",
    "HALF_OPEN",
]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# One source of truth for the breaker's shape — the config dataclass
# and CLI flags derive their defaults from here.
DEFAULT_FAILURE_THRESHOLD = 8
DEFAULT_COOLDOWN_S = 15.0


class CircuitOpenError(IOError):
    """Raised instead of attempting a call while the circuit is open."""

    def __init__(self, endpoint: str, retry_in: float):
        super().__init__(
            f"circuit open for {endpoint}; next probe in "
            f"{max(0.0, retry_in):.1f}s"
        )
        self.endpoint = endpoint
        self.retry_in = retry_in


def _record_probe(endpoint: str, outcome: str) -> None:
    """Half-open probe observability: without this, shed-vs-probe
    behavior is invisible on the timeline — an operator cannot tell "the
    breaker is probing its way back" from "the breaker is wedged open".
    Outcomes: ``admitted`` (a probe slot granted), ``success`` (the
    probe closed the circuit), ``failure`` (the probe re-opened it),
    ``released`` (slot returned with no verdict — an abandoned
    stream)."""
    from spark_examples_tpu_torch import obs
    from spark_examples_tpu_torch.obs.tracer import collection_active

    obs.instant(
        "breaker_probe", scope="p", endpoint=endpoint, outcome=outcome
    )
    if collection_active():
        obs.get_registry().counter(
            "breaker_probe_total",
            "Half-open circuit-breaker probe outcomes per endpoint",
        ).labels(endpoint=endpoint, outcome=outcome).inc()


def _record_transition(endpoint: str, from_state: str, to_state: str) -> None:
    from spark_examples_tpu_torch import obs
    from spark_examples_tpu_torch.obs.tracer import collection_active

    obs.instant(
        "breaker_transition",
        scope="p",
        endpoint=endpoint,
        **{"from": from_state, "to": to_state},
    )
    if collection_active():
        obs.get_registry().counter(
            "resilience_breaker_transitions_total",
            "Circuit-breaker state transitions per endpoint",
        ).labels(endpoint=endpoint, to=to_state).inc()


class CircuitBreaker:
    """One endpoint's closed/open/half-open state machine (thread-safe)."""

    def __init__(
        self,
        endpoint: str,
        failure_threshold: int = DEFAULT_FAILURE_THRESHOLD,
        cooldown_s: float = DEFAULT_COOLDOWN_S,
        half_open_probes: int = 1,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.endpoint = endpoint
        self.failure_threshold = max(1, failure_threshold)
        self.cooldown_s = cooldown_s
        self.half_open_probes = max(1, half_open_probes)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probes_in_flight = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _transition(self, to_state: str) -> None:
        # Called under self._lock.
        from_state = self._state
        self._state = to_state
        _record_transition(self.endpoint, from_state, to_state)

    def before_call(self) -> None:
        """Gate one call: pass in CLOSED, shed in OPEN (until the
        cooldown converts it to a HALF_OPEN probe window), admit a
        bounded number of probes in HALF_OPEN."""
        with self._lock:
            if self._state == OPEN:
                elapsed = self._clock() - self._opened_at
                if elapsed < self.cooldown_s:
                    raise CircuitOpenError(
                        self.endpoint, self.cooldown_s - elapsed
                    )
                self._transition(HALF_OPEN)
                self._probes_in_flight = 0
            if self._state == HALF_OPEN:
                if self._probes_in_flight >= self.half_open_probes:
                    raise CircuitOpenError(
                        self.endpoint,
                        self.cooldown_s - (self._clock() - self._opened_at),
                    )
                self._probes_in_flight += 1
                _record_probe(self.endpoint, "admitted")

    def record_success(self) -> None:
        """Record transport-level liveness: a returned result OR a
        served application error (the endpoint answered — the retry
        classifiers' non-retryable verdict). Closes a half-open probe."""
        with self._lock:
            if self._state == HALF_OPEN:
                _record_probe(self.endpoint, "success")
                self._transition(CLOSED)
                self._probes_in_flight = 0
            self._failures = 0

    def release_probe(self) -> None:
        """Give back a half-open probe slot with NO verdict — for calls
        that ended without evidence either way (a consumer abandoning a
        stream mid-probe). Without this release, an abandoned probe
        would wedge the breaker half-open forever."""
        with self._lock:
            if self._state == HALF_OPEN and self._probes_in_flight > 0:
                self._probes_in_flight -= 1
                _record_probe(self.endpoint, "released")

    def record_failure(self) -> None:
        """Count one RETRYABLE failure (the classifier's verdict — a
        served 404 must never reach here)."""
        with self._lock:
            if self._state == HALF_OPEN:
                # The probe failed: re-open and re-arm the cooldown.
                _record_probe(self.endpoint, "failure")
                self._transition(OPEN)
                self._opened_at = self._clock()
                self._probes_in_flight = 0
                return
            if self._state == CLOSED:
                self._failures += 1
                if self._failures >= self.failure_threshold:
                    self._transition(OPEN)
                    self._opened_at = self._clock()


class BreakerSet:
    """Lazy per-endpoint breakers sharing one config — a transport's set.

    Keys are endpoint names (the HTTP tier uses paths, the gRPC tier
    method names); each gets its own state machine so a broken
    ``/export-sidecar`` cannot shed ``/variants`` traffic.
    """

    def __init__(
        self,
        prefix: str = "",
        failure_threshold: int = DEFAULT_FAILURE_THRESHOLD,
        cooldown_s: float = DEFAULT_COOLDOWN_S,
        half_open_probes: int = 1,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.prefix = prefix
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self.half_open_probes = half_open_probes
        self._clock = clock
        self._lock = threading.Lock()
        self._breakers: Dict[str, CircuitBreaker] = {}

    def get(self, endpoint: str) -> CircuitBreaker:
        with self._lock:
            b = self._breakers.get(endpoint)
            if b is None:
                name = (
                    f"{self.prefix}{endpoint}" if self.prefix else endpoint
                )
                b = self._breakers[endpoint] = CircuitBreaker(
                    name,
                    failure_threshold=self.failure_threshold,
                    cooldown_s=self.cooldown_s,
                    half_open_probes=self.half_open_probes,
                    clock=self._clock,
                )
            return b

    def states(self) -> Dict[str, str]:
        with self._lock:
            return {k: b.state for k, b in self._breakers.items()}
