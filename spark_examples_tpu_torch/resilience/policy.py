"""Declarative retry policies with per-transport error classification.

The JAX package's ``resilience/policy.py``. ONE engine every tier
shares:

- a :class:`RetryPolicy` value object — attempt cap, jittered
  exponential backoff, optional wall-clock ``deadline`` that attempts
  draw down (the per-shard budget), and Retry-After honoring;
- per-transport **classifiers** that decide whether a failure is worth
  retrying AT ALL (a served 404 is an answer; a connect reset is
  weather) and carry any server-directed delay out of the exception;
- :func:`call_with_retry`, the one loop. It emits every retry to the
  obs timeline/metrics and cooperates with the circuit breaker
  (:mod:`.breaker`) so a failing tier is probed, not hammered.

Classification is deliberately per-transport. The genomics HTTP service
maps *deterministic* source errors to 500 (a bad shard re-requested
forever stays bad), so only infrastructural statuses (429/502/503/504
and friends) retry there — while the oauth token endpoint's 5xx family
is transient by contract (RFC 6749 servers return denials as 4xx), so
5xx retries there. One engine, different tables.
"""

from __future__ import annotations

import math
import random
import time
from dataclasses import dataclass
from typing import Callable, Optional

__all__ = [
    "Budget",
    "RetryDecision",
    "RetryPolicy",
    "call_with_retry",
    "classify_grpc",
    "classify_http",
    "classify_ingest",
    "classify_oauth",
    "parse_retry_after",
    "RETRYABLE_HTTP_STATUS",
    "RETRYABLE_OAUTH_STATUS",
]

# Served statuses worth retrying against the genomics HTTP service.
# 500 is NOT here on purpose: the service maps any source-side
# exception to 500, including deterministic ones (tests pin that a
# fail-once fixture 500 surfaces to the caller), so a 500 is an answer.
RETRYABLE_HTTP_STATUS = frozenset({408, 425, 429, 502, 503, 504})

# The oauth token endpoint returns denials as 4xx JSON (RFC 6749 §5.2);
# its 5xx family is infrastructure and safe to retry (token exchange is
# idempotent), plus the throttling statuses.
RETRYABLE_OAUTH_STATUS = frozenset({408, 425, 429, 500, 502, 503, 504})


@dataclass(frozen=True)
class RetryDecision:
    """A classifier's verdict on one failure."""

    retryable: bool
    reason: str = ""
    # Server-directed delay (Retry-After) in seconds; overrides backoff
    # when the policy honors it.
    delay_hint: Optional[float] = None


@dataclass(frozen=True)
class RetryPolicy:
    """Declarative retry shape shared by every tier.

    ``max_attempts`` counts TOTAL tries (1 = no retry). ``deadline`` is
    a wall-clock budget in seconds for the whole operation — attempts
    and backoff sleeps draw it down; when it runs dry the last error
    surfaces even if attempts remain (the per-shard budget of the
    ingest tier). ``jitter`` randomizes each delay by ±fraction so a
    fleet of workers retrying the same dead endpoint decorrelates.
    """

    max_attempts: int = 4
    base_delay: float = 0.05
    max_delay: float = 5.0
    multiplier: float = 2.0
    jitter: float = 0.25
    deadline: Optional[float] = None
    honor_retry_after: bool = True

    def backoff_delay(
        self, failures: int, rng: Optional[random.Random] = None
    ) -> float:
        """Delay before the next attempt after ``failures`` failures."""
        d = min(
            self.base_delay * self.multiplier ** max(0, failures - 1),
            self.max_delay,
        )
        if self.jitter:
            r = rng.random() if rng is not None else random.random()
            d *= 1.0 + self.jitter * (2.0 * r - 1.0)
        return max(0.0, d)


class Budget:
    """Wall-clock budget an operation's attempts draw down.

    ``Budget(None)`` never exhausts. The deadline is armed at
    construction, so attempt execution time counts against it exactly
    like backoff sleeps do — a shard that spends its whole budget
    stalling gets no retries, by design.
    """

    def __init__(
        self,
        seconds: Optional[float],
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.seconds = seconds
        self._clock = clock
        self._deadline = None if seconds is None else clock() + seconds

    def remaining(self) -> float:
        if self._deadline is None:
            return math.inf
        return self._deadline - self._clock()

    def exhausted(self) -> bool:
        return self.remaining() <= 0.0


# -- per-transport classifiers ------------------------------------------------


def _served_http_code(exc: BaseException) -> Optional[int]:
    """HTTP status behind an IOError raised by the HTTP tier (None =
    transport-level failure, nothing was served)."""
    return getattr(getattr(exc, "__cause__", None), "code", None)


def classify_http(exc: BaseException) -> RetryDecision:
    """Genomics HTTP tier: transport trouble retries; served statuses
    retry only when infrastructural (RETRYABLE_HTTP_STATUS), carrying
    any Retry-After the server attached."""
    from spark_examples_tpu_torch.resilience.breaker import CircuitOpenError

    if isinstance(exc, CircuitOpenError):
        # The breaker already knows the tier is down; retrying through
        # it is the breaker's half-open probe's job, not this loop's.
        return RetryDecision(False, "circuit_open")
    code = _served_http_code(exc)
    if code is None:
        return RetryDecision(True, "transport")
    if code in RETRYABLE_HTTP_STATUS:
        return RetryDecision(
            True,
            f"http_{code}",
            delay_hint=getattr(exc.__cause__, "retry_after", None),
        )
    return RetryDecision(False, f"http_{code}")


# gRPC status names that indicate the tier (not the request) failed.
_RETRYABLE_GRPC = frozenset(
    {"UNAVAILABLE", "DEADLINE_EXCEEDED", "RESOURCE_EXHAUSTED", "ABORTED"}
)


def classify_grpc(exc: BaseException) -> RetryDecision:
    """gRPC tier: transient transport statuses retry; served
    application statuses (UNAUTHENTICATED, NOT_FOUND, INVALID_ARGUMENT,
    plain INTERNAL from a handler exception) do not. Works on a raw
    ``grpc.RpcError`` or an IOError wrapping one."""
    from spark_examples_tpu_torch.resilience.breaker import CircuitOpenError

    if isinstance(exc, CircuitOpenError):
        return RetryDecision(False, "circuit_open")
    err = exc
    code_fn = getattr(err, "code", None)
    if code_fn is None:
        err = getattr(exc, "__cause__", None)
        code_fn = getattr(err, "code", None)
    if code_fn is None:
        # Not a status-bearing failure (e.g. a local OSError): weather.
        return RetryDecision(True, "transport")
    try:
        name = code_fn().name
    except Exception:  # noqa: BLE001 — a broken stub must not crash
        return RetryDecision(True, "transport")
    if name in _RETRYABLE_GRPC:
        return RetryDecision(True, f"grpc_{name.lower()}")
    return RetryDecision(False, f"grpc_{name.lower()}")


def parse_retry_after(value: Optional[str]) -> Optional[float]:
    """Retry-After header → seconds (delta-seconds or HTTP-date)."""
    if not value:
        return None
    value = value.strip()
    try:
        return max(0.0, float(value))
    except ValueError:
        pass
    try:
        from email.utils import parsedate_to_datetime
        import datetime

        when = parsedate_to_datetime(value)
        now = datetime.datetime.now(datetime.timezone.utc)
        return max(0.0, (when - now).total_seconds())
    except (TypeError, ValueError):
        return None


def classify_oauth(exc: BaseException) -> RetryDecision:
    """OAuth token exchange: URLError/OSError and 5xx/429 retry (the
    exchange is idempotent); 4xx denials (invalid_grant & co, RFC 6749
    §5.2) surface immediately — a revoked token never un-revokes."""
    from urllib.error import HTTPError, URLError

    if isinstance(exc, HTTPError):
        if exc.code in RETRYABLE_OAUTH_STATUS:
            return RetryDecision(
                True,
                f"oauth_{exc.code}",
                delay_hint=parse_retry_after(
                    exc.headers.get("Retry-After") if exc.headers else None
                ),
            )
        return RetryDecision(False, f"oauth_{exc.code}")
    if isinstance(exc, (URLError, OSError)):
        return RetryDecision(True, "transport")
    return RetryDecision(False, "unclassified")


def classify_ingest(exc: BaseException) -> RetryDecision:
    """Shard ingest (the driver's per-shard layer): any IO-shaped
    failure retries — the manifest is deterministic and per-shard
    ingest idempotent, so re-execution is always sound. Wire corruption
    that survived framing surfaces as a JSON parse error, which is also
    transport weather at this layer. Everything else (a genuine data
    error) surfaces immediately."""
    import json

    if isinstance(exc, (OSError, json.JSONDecodeError)):
        return RetryDecision(True, "ingest_io")
    return RetryDecision(False, "ingest_fatal")


# -- the one loop -------------------------------------------------------------


def call_with_retry(
    fn: Callable[[], object],
    policy: RetryPolicy,
    classify: Callable[[BaseException], RetryDecision],
    *,
    transport: str = "",
    method: str = "",
    budget: Optional[Budget] = None,
    breaker=None,
    sleep: Callable[[float], None] = time.sleep,
    rng: Optional[random.Random] = None,
):
    """Run ``fn`` under ``policy``; the engine every tier adopts.

    On failure the exception is classified; retryable failures feed the
    ``breaker`` (non-retryable ones are the tier *answering* and leave
    it alone), then back off — honoring a server's Retry-After hint
    when the policy allows — until attempts or the budget run out, at
    which point the LAST failure surfaces unchanged (callers keep their
    exception-type contracts, e.g. IoStats counting at the final
    raise). Every retry lands on the obs timeline and the shared
    ``genomics_rpc_retries_total`` counter.
    """
    from spark_examples_tpu_torch import obs

    if budget is None:
        budget = Budget(policy.deadline)
    failures = 0
    while True:
        if breaker is not None:
            breaker.before_call()  # raises CircuitOpenError when open
        try:
            result = fn()
        except Exception as e:  # noqa: BLE001 — classifier decides
            decision = classify(e)
            if breaker is not None:
                if decision.retryable:
                    breaker.record_failure()
                else:
                    # A non-retryable failure means the endpoint
                    # ANSWERED (served 404/500, auth denial): transport
                    # is alive, which is the only thing the breaker
                    # measures — and a half-open probe that got an
                    # answer must close the circuit, not leak its slot.
                    breaker.record_success()
            failures += 1
            if (
                not decision.retryable
                or failures >= max(1, policy.max_attempts)
                or budget.exhausted()
            ):
                raise
            delay = (
                # Server-directed delay, capped by the policy's own
                # ceiling: an hour-long Retry-After must not park a
                # worker thread — past max_delay the budget/attempt
                # limits decide, not the server.
                min(decision.delay_hint, max(policy.max_delay, 0.0))
                if policy.honor_retry_after
                and decision.delay_hint is not None
                else policy.backoff_delay(failures, rng)
            )
            remaining = budget.remaining()
            if remaining != math.inf:
                if remaining <= 0.0:
                    raise
                delay = min(delay, remaining)
            obs.count_retry(transport, method)
            obs.instant(
                "retry_backoff",
                scope="p",
                transport=transport,
                method=method,
                attempt=failures,
                delay_s=round(delay, 4),
                reason=decision.reason,
            )
            if delay > 0:
                sleep(delay)
        else:
            if breaker is not None:
                breaker.record_success()
            return result
