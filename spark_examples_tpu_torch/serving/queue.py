"""Bounded priority admission queue with per-tenant quotas.

Load shedding is the first line of robustness for a multi-tenant
analysis server: a queue that grows without bound converts overload
into unbounded latency plus an eventual OOM, and a single greedy tenant
can starve everyone else. This queue is the explicit admission point —
``admit`` either accepts a job or raises a shed error carrying a
``retry_after`` hint DERIVED FROM the resilience layer's own backoff
engine (``RetryPolicy.backoff_delay`` over the consecutive-shed streak,
the GL005 rule applied to server-directed delays: backoff values come
from the policy engine, never ad-hoc constants), which the HTTP surface
ships as a ``429`` + ``Retry-After`` header — the exact signal the
client tier's ``classify_http`` already honors.

Fairness: ``tenant_quota`` bounds each tenant's jobs in flight
(queued + running); capacity bounds total queue depth. Ordering is
(priority desc, submission seq asc) — stable and deterministic, so a
journal replay re-queues survivors in exactly the order an
uninterrupted server would have run them.
"""

from __future__ import annotations

import heapq
import threading
from typing import Callable, Dict, List, Optional, Tuple

from spark_examples_tpu_torch.resilience.policy import RetryPolicy
from spark_examples_tpu_torch.utils.lockcheck import assert_lock_held

__all__ = [
    "AdmissionError",
    "AdmissionQueue",
    "JournalUnavailableError",
    "QueueFullError",
    "QuotaExceededError",
    "DEFAULT_QUEUE_DEPTH",
    "DEFAULT_TENANT_QUOTA",
]

DEFAULT_QUEUE_DEPTH = 64
DEFAULT_TENANT_QUOTA = 8

# The shed-hint shape: starts at 1 s, doubles with the consecutive-shed
# streak, caps at 30 s. jitter=0 — the hint must be deterministic for
# the chaos tests, and client-side jitter already decorrelates retries.
_SHED_POLICY = RetryPolicy(
    base_delay=1.0, max_delay=30.0, multiplier=2.0, jitter=0.0
)


class AdmissionError(RuntimeError):
    """A shed submission; ``retry_after`` is the server-directed delay
    (seconds) the HTTP surface ships as a Retry-After header."""

    reason = "shed"

    def __init__(self, message: str, retry_after: float) -> None:
        super().__init__(message)
        self.retry_after = retry_after


class QueueFullError(AdmissionError):
    reason = "queue_full"


class QuotaExceededError(AdmissionError):
    reason = "quota"


class JournalUnavailableError(AdmissionError):
    """The job journal cannot record a submission: the crash-safety
    contract (journaled before observable) forbids running it, so the
    submission sheds retryably instead — disk conditions clear."""

    reason = "journal"


def note_shed(reason: str) -> None:
    from spark_examples_tpu_torch import obs
    from spark_examples_tpu_torch.obs.tracer import collection_active

    obs.instant("job_shed", scope="p", reason=reason)
    if collection_active():
        obs.get_registry().counter(
            "serving_shed_total",
            "Analysis submissions shed at admission "
            "(reason: queue_full/quota/journal)",
        ).labels(reason=reason).inc()


class AdmissionQueue:
    """Thread-safe bounded priority queue (the job tier's admission)."""

    def __init__(
        self,
        capacity: int = DEFAULT_QUEUE_DEPTH,
        tenant_quota: int = DEFAULT_TENANT_QUOTA,
        shed_policy: RetryPolicy = _SHED_POLICY,
    ) -> None:
        self.capacity = max(1, capacity)
        self.tenant_quota = max(1, tenant_quota)
        self._policy = shed_policy
        self._cv = threading.Condition()
        self._heap: List[Tuple[int, int, object]] = []
        # Per-tenant jobs in flight: queued + running, released only at
        # a terminal state — a tenant cannot reclaim quota by merely
        # having its job dequeued.
        self._in_flight: Dict[str, int] = {}
        self._shed_streak = 0

    # -- observability --------------------------------------------------------

    def _note_depth_locked(self) -> None:
        assert_lock_held(self._cv, "AdmissionQueue._note_depth_locked")
        from spark_examples_tpu_torch import obs
        from spark_examples_tpu_torch.obs.tracer import collection_active

        if collection_active():
            depth = float(len(self._heap))
            obs.get_registry().gauge(
                "serving_queue_depth",
                "Jobs currently queued in the analysis admission queue",
            ).set(depth)
            # Also a trace counter track: depth-over-time next to the
            # job.run spans is how a shed burst reads on the timeline.
            obs.counter("serving_queue_depth", depth=depth)
            self._note_inflight_locked()

    def _note_inflight_locked(self) -> None:
        assert_lock_held(self._cv, "AdmissionQueue._note_inflight_locked")
        from spark_examples_tpu_torch import obs
        from spark_examples_tpu_torch.obs.tracer import collection_active

        if collection_active():
            inflight = float(sum(self._in_flight.values()))
            obs.get_registry().gauge(
                "serving_inflight_jobs",
                "Admitted analysis jobs not yet terminal "
                "(queued + running, all tenants)",
            ).set(inflight)

    # -- admission ------------------------------------------------------------

    def _retry_after_locked(self) -> float:
        assert_lock_held(self._cv, "AdmissionQueue._retry_after_locked")
        # The streak grows the hint: a client hammering a saturated
        # queue is told to back off exponentially, exactly as the retry
        # engine itself would pace attempts (RetryPolicy.backoff_delay).
        self._shed_streak += 1
        return self._policy.backoff_delay(self._shed_streak)

    def admit(
        self, job: object, tenant: str, priority: int, seq: int
    ) -> None:
        """Accept ``job`` or raise a shed error with a retry_after hint.

        Raises :class:`QueueFullError` at capacity and
        :class:`QuotaExceededError` when the tenant's in-flight count
        (queued + running) is at quota.
        """
        with self._cv:
            if len(self._heap) >= self.capacity:
                delay = self._retry_after_locked()
                note_shed("queue_full")
                raise QueueFullError(
                    f"analysis queue full ({self.capacity} queued); "
                    f"retry in {delay:.1f}s",
                    delay,
                )
            if self._in_flight.get(tenant, 0) >= self.tenant_quota:
                delay = self._retry_after_locked()
                note_shed("quota")
                raise QuotaExceededError(
                    f"tenant {tenant!r} is at its quota of "
                    f"{self.tenant_quota} in-flight job(s); "
                    f"retry in {delay:.1f}s",
                    delay,
                )
            self._shed_streak = 0
            self._push_locked(job, tenant, priority, seq)

    def readmit(
        self, job: object, tenant: str, priority: int, seq: int
    ) -> None:
        """Re-queue a journal-replayed job, bypassing the shed checks —
        the job was already admitted by the crashed server, and resume
        must never drop work that admission accepted."""
        with self._cv:
            self._push_locked(job, tenant, priority, seq)

    def _push_locked(
        self, job: object, tenant: str, priority: int, seq: int
    ) -> None:
        assert_lock_held(self._cv, "AdmissionQueue._push_locked")
        heapq.heappush(self._heap, (-priority, seq, job))
        self._in_flight[tenant] = self._in_flight.get(tenant, 0) + 1
        self._note_depth_locked()
        self._cv.notify()

    # -- consumption ----------------------------------------------------------

    def pop(self, timeout: Optional[float] = None) -> Optional[object]:
        """Next job by (priority desc, seq asc); None on timeout."""
        with self._cv:
            if not self._heap:
                self._cv.wait(timeout)
            if not self._heap:
                return None
            _, _, job = heapq.heappop(self._heap)
            self._note_depth_locked()
            return job

    def take_compatible(
        self, pred: Callable[[object], bool], limit: int
    ) -> List[object]:
        """Pop up to ``limit`` queued jobs satisfying ``pred`` — the
        gang-batching selector: a worker that just popped a lead job
        collects the compatible queued jobs (same resolved variant
        params, small enough cohorts) to run as ONE batched dispatch.
        Selection follows pop order (priority desc, seq asc), so a gang
        is exactly the prefix of jobs a serial worker would have run
        next. Tenant in-flight slots are NOT released — the jobs are
        still in flight, exactly as if a worker had popped each one.
        ``pred`` runs under the queue lock and must not block or
        acquire the tier lock (lock hierarchy: tier → queue).
        """
        with self._cv:
            if limit <= 0 or not self._heap:
                return []
            taken: List[object] = []
            kept: List[Tuple[int, int, object]] = []
            for entry in sorted(self._heap):
                if len(taken) < limit and pred(entry[2]):
                    taken.append(entry[2])
                else:
                    kept.append(entry)
            if taken:
                self._heap = kept
                heapq.heapify(self._heap)
                self._note_depth_locked()
            return taken

    def _release_tenant_locked(self, tenant: str) -> None:
        assert_lock_held(
            self._cv, "AdmissionQueue._release_tenant_locked"
        )
        n = self._in_flight.get(tenant, 0)
        if n <= 1:
            self._in_flight.pop(tenant, None)
        else:
            self._in_flight[tenant] = n - 1

    def discard(self, job: object, tenant: str) -> bool:
        """Remove a rolled-back admission: drop its heap entry (a
        phantom must not consume capacity or inflate the depth gauge)
        and return its tenant slot. False when a worker already popped
        it — the slot then returns through the normal terminal
        release."""
        with self._cv:
            kept = [e for e in self._heap if e[2] is not job]
            if len(kept) == len(self._heap):
                return False
            self._heap = kept
            heapq.heapify(self._heap)
            self._release_tenant_locked(tenant)
            self._note_depth_locked()
            return True

    def release(self, tenant: str) -> None:
        """Return one in-flight slot — called when a job reaches a
        terminal state (done/failed), never at dequeue."""
        with self._cv:
            self._release_tenant_locked(tenant)
            self._note_inflight_locked()

    def depth(self) -> int:
        with self._cv:
            return len(self._heap)

    def in_flight(self, tenant: str) -> int:
        with self._cv:
            return self._in_flight.get(tenant, 0)

    def in_flight_by_tenant(self) -> Dict[str, int]:
        """Snapshot of every tenant's in-flight count (``/statusz``)."""
        with self._cv:
            return dict(self._in_flight)
