"""Unified resilience layer: retry policies, circuit breakers, faults.

The JAX package's ``resilience`` package. Three pillars, adopted by every
failure-bearing tier the port has (the HTTP and gRPC transports, the
oauth token exchange, the cohort mirror's file commits):

1. **Retry-policy engine** (:mod:`.policy`): declarative
   :class:`RetryPolicy` (jittered exponential backoff, attempt cap,
   wall-clock deadline budget, Retry-After honoring) run through ONE loop
   (:func:`call_with_retry`) with per-transport retryable-error
   classifiers.
2. **Circuit breaker** (:mod:`.breaker`): per-endpoint
   closed/open/half-open state machines that shed load from a failing
   tier and probe for recovery, fed only by *retryable* failures.
3. **Fault-injection plane** (:mod:`.faults`): deterministic, seedable
   :class:`FaultPlan` activated by the CLI's ``--fault-plan``, with
   injection points at the transport seams.

Retries, breaker transitions and injected faults all land on the obs
timeline and metrics registry.
"""

from spark_examples_tpu_torch.resilience.policy import (
    Budget,
    RETRYABLE_HTTP_STATUS,
    RETRYABLE_OAUTH_STATUS,
    RetryDecision,
    RetryPolicy,
    call_with_retry,
    classify_grpc,
    classify_http,
    classify_ingest,
    classify_oauth,
    parse_retry_after,
)
from spark_examples_tpu_torch.resilience.breaker import (
    BreakerSet,
    CircuitBreaker,
    CircuitOpenError,
)
from spark_examples_tpu_torch.resilience.faults import (
    FaultPlan,
    FaultRule,
    InjectedFault,
    active_plan,
    clear_plan,
    current_plan,
    inject,
    inject_write,
    install_plan,
    take,
    wrap_lines,
)

__all__ = [
    "Budget",
    "RETRYABLE_HTTP_STATUS",
    "RETRYABLE_OAUTH_STATUS",
    "RetryDecision",
    "RetryPolicy",
    "call_with_retry",
    "classify_grpc",
    "classify_http",
    "classify_ingest",
    "classify_oauth",
    "parse_retry_after",
    "BreakerSet",
    "CircuitBreaker",
    "CircuitOpenError",
    "FaultPlan",
    "FaultRule",
    "InjectedFault",
    "active_plan",
    "clear_plan",
    "current_plan",
    "inject",
    "inject_write",
    "install_plan",
    "take",
    "wrap_lines",
]
