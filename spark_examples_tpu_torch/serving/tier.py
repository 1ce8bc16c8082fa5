"""The analysis job tier: admission → journal → workers → results.

Ties the serving pieces into the object ``genomics/service.py`` fronts
with ``POST /analyze`` + ``GET /jobs/<id>``:

- **admission**: the per-endpoint :class:`CircuitBreaker` gates
  submissions first (job-execution failures with an IO shape feed it,
  so a dead upstream source trips the fuse and new submissions shed
  instantly with a Retry-After instead of queuing jobs that will die);
  then the bounded :class:`AdmissionQueue` applies capacity and
  per-tenant quotas (429 + Retry-After, derived from
  ``RetryPolicy.backoff_delay``);
- **single-flight dedup + result cache**: submissions are keyed by
  :func:`cohort_key`; an identical in-flight submission returns the
  SAME job (one execution, any number of waiters), and a finished key
  is served from the result cache without touching the queue at all;
- **crash-safe journal**: every state transition is appended to the
  :class:`JobJournal` before it is observable, so a ``kill -9`` at any
  point leaves a journal a restarted tier replays deterministically —
  done jobs stay queryable (and warm the cache), in-flight jobs
  re-queue in original order, and a re-run produces bit-identical
  coordinates (deterministic manifest + integer-exact accumulation,
  the same invariant the chaos harness pins for ingest);
- **resumable gramians**: with a journal directory, each single-dataset
  job also gets a per-job checkpoint dir, so a job killed mid-Gramian
  resumes from its last shard-group snapshot instead of from zero.

Since the replica round the tier also has a **replicated mode**: give
it a :class:`~spark_examples_tpu_torch.serving.replica.LeaseManager` over a
shared :class:`~spark_examples_tpu_torch.store.DurableStore` and the journal
moves to a per-replica directory on the store, every submission and
terminal transition is mirrored into a shared job index
(``jobs/<id>``, fenced puts), per-job Gramian checkpoints live on the
store so ANY replica can resume them, and expired peers' journals are
adopted (:meth:`AnalysisJobTier.adopt_expired_peers`): their in-flight
jobs re-queue here in original submission order. A replica that lost
its lease is a zombie — every journal/index/result write it attempts is
rejected loudly with ``FencedWriteError``, never torn-merged.

Fault seams (docs/RESILIENCE.md): ``serving.job.run`` (error/stall =
job execution failure/slow job), ``serving.job.kill`` (a simulated
process death between the journaled start and execution — the
deterministic stand-in for ``kill -9`` the chaos tests drive),
``serving.journal.append`` (torn/error journal writes), and the
``store.read``/``store.write``/``store.lease`` seams under the
replicated mode.
"""

from __future__ import annotations

import collections
import json
import os
import shutil
import sys
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from spark_examples_tpu_torch.serving.jobs import (
    JOB_DONE,
    JOB_FAILED,
    JOB_QUEUED,
    JOB_RUNNING,
    Job,
    JobJournal,
    JobSpec,
    cohort_key,
    job_config,
    resolve_spec,
)
from spark_examples_tpu_torch.serving.queue import (
    AdmissionQueue,
    DEFAULT_QUEUE_DEPTH,
    DEFAULT_TENANT_QUOTA,
)
from spark_examples_tpu_torch.serving.replica import (
    JOB_INDEX_PREFIX,
    LeaseManager,
)
from spark_examples_tpu_torch.store import FencedWriteError, Lease, StoreError
from spark_examples_tpu_torch.utils.lockcheck import assert_lock_held

__all__ = [
    "AnalysisJobTier",
    "SimulatedCrash",
    "DEFAULT_RESULT_CACHE",
    "DEFAULT_JOB_RETENTION",
    "GANG_MAX_JOBS",
]

DEFAULT_RESULT_CACHE = 256

# Most queued compatible jobs one gang coalesces (the lead + this-1
# members): bounds the batched stack's host/device footprint at
# GANG_MAX_JOBS × gang_max_samples × block_variants int8 bytes.
GANG_MAX_JOBS = 16

# Terminal (done/failed) jobs kept queryable in memory: beyond this the
# oldest are evicted (their results live on in the LRU cache / journal).
# Without a bound, weeks of steady traffic grow the job table — and its
# retained result rows — into exactly the overload-to-OOM conversion
# the admission queue exists to prevent.
DEFAULT_JOB_RETENTION = 1024


class SimulatedCrash(RuntimeError):
    """The ``serving.job.kill`` seam fired: this worker must die AS IF
    the process were killed — no failure event reaches the journal, no
    quota is released, the job stays 'running' in the abandoned tier."""


class _ResultCache:
    """Bounded LRU of cohort_key → (job_id, rows) (thread-safe)."""

    def __init__(self, capacity: int) -> None:
        self.capacity = max(1, capacity)
        self._lock = threading.Lock()
        self._items: "collections.OrderedDict[str, Tuple[str, list]]" = (
            collections.OrderedDict()
        )

    def get(self, key: str) -> Optional[Tuple[str, list]]:
        with self._lock:
            hit = self._items.get(key)
            if hit is not None:
                self._items.move_to_end(key)
            return hit

    def put(self, key: str, job_id: str, rows: list) -> None:
        with self._lock:
            self._items[key] = (job_id, rows)
            self._items.move_to_end(key)
            while len(self._items) > self.capacity:
                self._items.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


def _count_job(outcome: str) -> None:
    from spark_examples_tpu_torch import obs
    from spark_examples_tpu_torch.obs.tracer import collection_active

    if collection_active():
        obs.get_registry().counter(
            "serving_jobs_total",
            "Analysis job submissions by outcome "
            "(done/failed/cached/deduped)",
        ).labels(outcome=outcome).inc()


class AnalysisJobTier:
    """The object the HTTP surface fronts (one per server process)."""

    def __init__(
        self,
        engine: Any,
        base_config: Any,
        queue_depth: int = DEFAULT_QUEUE_DEPTH,
        tenant_quota: int = DEFAULT_TENANT_QUOTA,
        workers: int = 1,
        journal_dir: Optional[str] = None,
        cache_size: int = DEFAULT_RESULT_CACHE,
        breakers: Any = None,
        job_retention: int = DEFAULT_JOB_RETENTION,
        gang_max_samples: int = 0,
        replica: Optional[LeaseManager] = None,
    ) -> None:
        from spark_examples_tpu_torch.resilience import BreakerSet

        self._engine = engine
        # Gang batching: cohorts at or below this many samples coalesce
        # with compatible queued jobs into one batched dispatch
        # (0 = disabled — the historical one-job-per-dispatch tier).
        self._gang_max = max(0, gang_max_samples)
        self._base = base_config
        self._queue = AdmissionQueue(queue_depth, tenant_quota)
        self._cache = _ResultCache(cache_size)
        self._breaker = (breakers or BreakerSet("serving:")).get("analyze")
        self._lock = threading.RLock()
        self._jobs: Dict[str, Job] = {}
        self._by_key: Dict[str, str] = {}  # active cohort_key → job id
        self._retention = max(1, job_retention)
        self._seq = 0
        # Replicated mode: the journal moves to THIS replica's directory
        # on the shared store, so any replica can re-run its jobs after
        # adopting them. A replica plane that started degraded (store unreachable) falls back to
        # the local journal_dir: single-replica local mode, never a
        # crash.
        self._replica = replica
        self._store_root: Optional[str] = None
        self._peer_scan_monotonic = 0.0
        if replica is not None and not replica.degraded():
            root = getattr(replica.store, "root", None)
            if root is not None:
                self._store_root = str(root)
                journal_dir = os.path.join(
                    self._store_root, "replicas", replica.replica_id
                )
        self._journal = (
            JobJournal(journal_dir) if journal_dir else None
        )
        self._journal_dir = journal_dir
        self._stop = threading.Event()
        self._workers: List[threading.Thread] = []
        self._n_workers = max(0, workers)
        self._started_unix = time.time()
        if self._journal is not None:
            self._replay()

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "AnalysisJobTier":
        """Spawn the worker threads (``workers=0`` = none; callers then
        drive execution with :meth:`step` — the deterministic test
        mode)."""
        for i in range(self._n_workers):
            t = threading.Thread(
                target=self._worker_loop,
                name=f"analysis-worker-{i}",
                daemon=True,
            )
            t.start()
            self._workers.append(t)
        return self

    def close(self) -> None:
        self._stop.set()
        # Unblock workers parked in pop(): the queue wakes on notify,
        # and pop() uses a bounded wait, so the stop flag is observed.
        for t in self._workers:
            t.join(timeout=10.0)
        if self._journal is not None:
            self._journal.close()
        if self._replica is not None:
            self._replica.stop()

    # -- submission -----------------------------------------------------------

    def submit(self, spec: JobSpec) -> Tuple[Job, bool]:
        """Admit one submission → ``(job, created)``.

        ``created`` False = served without new work (result cache hit
        or single-flight dedup onto an in-flight identical job). Raises
        ``CircuitOpenError`` (breaker shedding) or an
        :class:`~spark_examples_tpu_torch.serving.queue.AdmissionError`
        (queue full / tenant quota) — the HTTP surface maps those to
        503/429 + Retry-After.
        """
        from spark_examples_tpu_torch import obs

        key = cohort_key(spec, self._base)
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None:
                job_id, rows = hit
                _count_job("cached")
                # A caller-scoped VIEW, never the original record: the
                # rows are shared across tenants by design, the
                # submitter's identity/spec are not — and mutating the
                # original's `cached` flag would corrupt its own
                # submitter's poll.
                return (
                    Job(
                        id=job_id, spec=spec, key=key, seq=-1,
                        state=JOB_DONE, cached=True, result=rows,
                    ),
                    False,
                )
            active_id = self._by_key.get(key)
            if active_id is not None:
                active = self._jobs[active_id]
                _count_job("deduped")
                return (
                    Job(
                        id=active.id, spec=spec, key=key,
                        seq=active.seq, state=active.state,
                        error=active.error, result=active.result,
                        trace_id=active.trace_id,
                    ),
                    False,
                )
            # Breaker admission: a half-open probe slot taken here is
            # settled by the job's eventual outcome (record_success /
            # record_failure in the worker), so probes measure real job
            # executions, not merely the act of queuing.
            self._breaker.before_call()  # raises CircuitOpenError
            self._seq += 1
            seq = self._seq
            # The trace id is MINTED at admission — not derived from
            # the spec or cohort key (those are shared across tenants
            # and resubmissions; the timeline is this submission's).
            job = Job(
                id=f"j-{key[:12]}-{seq}", spec=spec, key=key, seq=seq,
                trace_id=uuid.uuid4().hex[:16],
            )
            try:
                self._queue.admit(job, spec.tenant, spec.priority, seq)
            except Exception:
                # The shed verdict belongs to the queue, not the
                # endpoint: give back any half-open probe slot the
                # breaker just granted, with no verdict.
                self._breaker.release_probe()
                raise
            self._jobs[job.id] = job
            self._by_key[key] = job.id
        # Journal OUTSIDE the tier lock: the append is disk I/O, and
        # holding the lock across it would stall every /jobs poll on a
        # slow disk. The 202 still goes out only after the append
        # returns — the client-visible contract holds.
        if self._journal is not None:
            try:
                self._fence_check()
                self._journal.append(self._submit_event(job))
            except FencedWriteError:
                # A zombie must not accept work: un-admit and surface
                # the fencing rejection itself — never a retryable
                # shed, the client must fail over to a live replica.
                self._discard_admission(
                    job, key, error="fenced: replica lease lost"
                )
                raise
            except Exception as e:  # noqa: BLE001 — disk weather
                self._rollback_submit(job, key, e)  # raises
            self._index_put(job)
        obs.instant(
            "job_transition", scope="p", id=job.id, to=JOB_QUEUED
        )
        return job, True

    def _submit_event(self, job: Job) -> Dict[str, Any]:
        """The journaled submission record. The replica/fencing fields
        ride ONLY in replicated mode — a replica-less tier's records
        stay byte-identical to every earlier round's."""
        event: Dict[str, Any] = {
            "e": "submit",
            "id": job.id,
            "seq": job.seq,
            "key": job.key,
            "spec": job.spec.to_record(),
            "ts": job.submitted_unix,
            "trace": job.trace_id,
        }
        if self._replica is not None:
            event["replica"] = self._replica.replica_id
            event["fence"] = self._replica.token()
        return event

    def _fence_check(self) -> None:
        """Zombie fencing: raises ``FencedWriteError`` when this
        replica's lease was lost or taken over — its late writes must
        never merge into shared state. A replica-less tier is never
        fenced."""
        if self._replica is not None:
            self._replica.check_fence()

    def _index_put(self, job: Job) -> None:
        """Mirror one job into the shared store index (``jobs/<id>``),
        fenced on this replica's lease. Store weather degrades with a
        warning — peers recover the same facts from journal adoption —
        but a FENCING rejection is always loud."""
        replica = self._replica
        if replica is None or replica.degraded():
            return
        lease = replica.lease()
        if lease is None:
            return
        record = self.record_of(job)
        record["replica"] = replica.replica_id
        record["fence"] = lease.token
        try:
            replica.store.put_fenced(
                JOB_INDEX_PREFIX + job.id,
                json.dumps(record, sort_keys=True).encode("utf-8"),
                lease,
            )
        except StoreError as e:
            print(
                f"WARNING: shared job index write for {job.id} failed "
                f"({e}); peers will see it at journal adoption instead.",
                file=sys.stderr,
            )

    def _rollback_submit(self, job: Job, key: str, exc: Exception) -> None:
        """Crash-safety contract: a job the journal cannot record must
        not run (it would vanish from resume). Un-admit it — removing
        its heap entry so no phantom consumes capacity — and shed
        retryably; disk conditions clear. If a worker raced us and
        already took the job, let it finish (its result is correct and
        cached; its orphan journal events are skipped by replay)."""
        from spark_examples_tpu_torch.serving.queue import (
            JournalUnavailableError,
            note_shed,
        )

        self._discard_admission(job, key, error=f"journal write failed: {exc}")
        note_shed("journal")
        raise JournalUnavailableError(
            f"analysis journal unavailable ({exc}); "
            "submission not accepted",
            5.0,
        ) from exc

    def _discard_admission(
        self, job: Job, key: str, error: Optional[str] = None
    ) -> None:
        """Un-admit a job whose durable submit record never landed
        (journal failure or fencing rejection): remove it from the
        tables and the queue so no phantom consumes capacity."""
        with self._lock:
            self._jobs.pop(job.id, None)
            if self._by_key.get(key) == job.id:
                self._by_key.pop(key, None)
            if self._queue.discard(job, job.spec.tenant):
                if job.state == JOB_QUEUED:
                    job.error = error or "admission rolled back"
                    job.state = JOB_FAILED
                # Only an un-run job gives its half-open probe slot
                # back; if a worker already took it, that execution IS
                # the probe and settles the breaker itself — releasing
                # here too would admit a second concurrent probe past
                # the bound.
                self._breaker.release_probe()

    def job(self, job_id: str) -> Optional[Job]:
        with self._lock:
            return self._jobs.get(job_id)

    def jobs(self) -> List[Job]:
        with self._lock:
            return sorted(self._jobs.values(), key=lambda j: j.seq)

    # -- snapshot serialization ------------------------------------------------
    #
    # Job objects are MUTATED by workers under the tier lock; readers
    # that serialize them must hold the same lock or they can observe a
    # torn transition (state flipped, error/result not yet written).
    # The HTTP surface reads ONLY through these three methods — the
    # fix for exactly that race, pinned by a regression test.

    def record_of(self, job: Job, include_result: bool = True) -> Dict:
        """One job serialized atomically (for a Job already in hand —
        the 202 response to a fresh submission, which a worker may
        already be finishing)."""
        with self._lock:
            return job.to_record(include_result=include_result)

    def job_record(
        self, job_id: str, include_result: bool = True
    ) -> Optional[Dict]:
        """Lookup + serialization as one atomic step (GET /jobs/<id>)."""
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None:
                return None
            return job.to_record(include_result=include_result)

    def job_records(self, include_result: bool = False) -> List[Dict]:
        """Every known job serialized under one lock hold — the /jobs
        listing is a consistent snapshot, not a mid-transition blur."""
        with self._lock:
            return [
                j.to_record(include_result=include_result)
                for j in sorted(
                    self._jobs.values(), key=lambda j: j.seq
                )
            ]

    def queue_depth(self) -> int:
        return self._queue.depth()

    # -- introspection (the /statusz and /jobs?trace=1 sources) ---------------

    def status(self) -> Dict[str, Any]:
        """One introspection snapshot (``GET /statusz``): queue and
        tenant pressure, breaker state, job table shape, caches. Lock
        order is tier → queue, same as every worker path."""
        with self._lock:
            by_state: Dict[str, int] = {}
            kinds: Dict[str, int] = {}
            for j in self._jobs.values():
                by_state[j.state] = by_state.get(j.state, 0) + 1
                kinds[j.spec.kind] = kinds.get(j.spec.kind, 0) + 1
            doc: Dict[str, Any] = {
                "uptime_seconds": max(
                    0.0, time.time() - self._started_unix
                ),
                "jobs_by_state": by_state,
                "resident_job_kinds": kinds,
                "result_cache_entries": len(self._cache),
                "journal_dir": self._journal_dir,
                "workers": self._n_workers,
                "gang_max_samples": self._gang_max,
            }
        doc["queue_depth"] = self._queue.depth()
        doc["in_flight_by_tenant"] = self._queue.in_flight_by_tenant()
        doc["breakers"] = {"analyze": self._breaker.state}
        delta_stats = getattr(self._engine, "delta_stats", None)
        doc["delta_cache"] = delta_stats() if delta_stats else None
        # Outside the tier lock: LeaseManager.status() takes its own
        # lock and lists peer leases off the store — tier._lock must
        # never be held across store I/O.
        doc["replica"] = (
            self._replica.status() if self._replica is not None else None
        )
        return doc

    def replica_status(self) -> Optional[Dict[str, Any]]:
        """The replica plane's identity/lease/store snapshot (None for
        a replica-less tier) — the /statusz source. Lists peers off the
        store; use :meth:`replica_health` where boundedness matters."""
        if self._replica is None:
            return None
        return self._replica.status()

    def replica_health(self) -> Optional[Dict[str, Any]]:
        """Bounded replica bits for ``/healthz`` — in-memory lease
        state only, NO store I/O (the exit-77 discipline: a health
        probe must never hang on the very store whose weather it
        reports)."""
        if self._replica is None:
            return None
        return {
            "replica_id": self._replica.replica_id,
            "lease_state": self._replica.state(),
            "store_reachable": not self._replica.degraded(),
        }

    def peer_job_record(self, job_id: str) -> Optional[Dict]:
        """Look up a job unknown locally in the shared store index
        (cross-replica ``GET /jobs/<id>``). None = nowhere; raises
        :class:`StoreError` when the store is unreachable or this
        process is degraded — the HTTP surface maps that to 503 +
        Retry-After rather than lying with a 404."""
        replica = self._replica
        if replica is None or self._store_root is None:
            return None
        if replica.degraded():
            raise StoreError(
                "store degraded: cross-replica job lookup unavailable"
            )
        try:
            blob = replica.store.get(JOB_INDEX_PREFIX + job_id)
        except KeyError:
            return None
        try:
            record = json.loads(blob.decode("utf-8"))
        except ValueError:
            return None
        return record if isinstance(record, dict) else None

    def running_jobs(self) -> int:
        """Jobs currently in the RUNNING state (the /healthz busy-vs-
        wedged disambiguator)."""
        with self._lock:
            return sum(
                1
                for j in self._jobs.values()
                if j.state == JOB_RUNNING
            )

    def journal_writable(self) -> bool:
        """Bounded journal writability (``/healthz``). A journal-less
        tier is vacuously writable — there is nothing to wedge."""
        if self._journal is None:
            return True
        try:
            return self._journal.probe()
        except Exception:  # noqa: BLE001 — health checks never raise
            return False

    def device_available(self, timeout_s: float = 0.5) -> bool:
        """Bounded device-lock probe (``/healthz``): False when the
        engine's dispatch lock cannot be taken within ``timeout_s``.
        Pair with :meth:`running_jobs` to tell busy from wedged."""
        probe = getattr(self._engine, "device_lock_available", None)
        if probe is None:
            return True
        return bool(probe(timeout_s))

    def job_trace(self, job_id: str) -> Optional[List[Dict[str, Any]]]:
        """The job's span timeline (``GET /jobs/<id>?trace=1``): every
        event in the ambient tracer carrying its trace id. None =
        unknown job; [] = known but nothing recorded (yet, or no
        telemetry session active)."""
        from spark_examples_tpu_torch import obs

        with self._lock:
            job = self._jobs.get(job_id)
            trace_id = job.trace_id if job is not None else None
        if job is None:
            return None
        if trace_id is None:
            return []
        return obs.get_tracer().events_for_trace(trace_id)

    # -- execution ------------------------------------------------------------

    def step(self, timeout: float = 0.0) -> bool:
        """Run one queued job — or one coalesced GANG — on the caller's
        thread (the worker body, exposed for deterministic tests and
        ``workers=0`` tiers). Returns False when nothing runnable was
        queued."""
        self._maybe_adopt_peers()
        while True:
            job = self._queue.pop(timeout=timeout)
            if job is None:
                return False
            if job.state != JOB_QUEUED:
                continue  # a rolled-back admission's stale heap entry
            self._dispatch(job)
            return True

    def _dispatch(self, job: Job) -> None:
        """One popped lead job → solo execution or a coalesced gang."""
        gang = self._gang_for(job)
        if gang:
            self._execute_gang([job] + gang)
        else:
            self._execute(job)

    def _gang_for(self, lead: Job) -> List[Job]:
        """Compatible queued jobs to batch with ``lead`` (possibly
        empty): same Gramian base key (resolved variant params — one
        shared window stream), every cohort at most ``gang_max_samples``
        samples. A lead the delta index can answer runs solo — the
        rank-k touch-up beats riding a cold gang."""
        if self._gang_max <= 0 or lead.spec.kind != "pca":
            # Gangs stack Gramian cohorts on a batch axis; a pairhmm
            # lead (or member) has no Gramian to stack and runs solo.
            return []
        engine = self._engine
        if (
            getattr(engine, "run_gang", None) is None
            or getattr(engine, "mesh", None) is not None
        ):
            return []
        try:
            lead_conf = job_config(lead.spec, self._base)
            lead_key = engine.gang_key(lead_conf)
            # Resolved HERE, outside the queue lock: an index_for LRU
            # miss runs source I/O, and the predicate below runs under
            # AdmissionQueue._cv. Members share the lead's index —
            # equal base keys mean equal variantset tuples.
            lead_index = engine.index_for(
                tuple(lead_conf.variant_set_ids)
            )
            if getattr(lead_conf, "pca_mode", "auto") == "sketch":
                # Gangs stack N×N Gramian tiles on a batch axis; a
                # sketch job has no Gramian to stack (and its result
                # is engine-specific) — it runs solo through the
                # driver's own sketch routing.
                return []
            if engine.cohort_size(lead_conf, lead_index) > self._gang_max:
                return []
            if engine.delta_resolvable(lead_conf):
                return []
        except Exception:  # noqa: BLE001 — probe failure = no gang
            return []

        def compatible(other: Any) -> bool:
            if other.state != JOB_QUEUED or other.spec.kind != "pca":
                return False  # stale entry / non-Gramian job kind
            try:
                conf = job_config(other.spec, self._base)
                return (
                    getattr(conf, "pca_mode", "auto") != "sketch"
                    and engine.gang_key(conf) == lead_key
                    and engine.cohort_size(conf, lead_index)
                    <= self._gang_max
                )
            except Exception:  # noqa: BLE001 — bad spec: solo fails it
                return False

        return self._queue.take_compatible(
            compatible, GANG_MAX_JOBS - 1
        )

    def _note_gang(self, size: int) -> None:
        from spark_examples_tpu_torch import obs

        obs.get_registry().histogram(
            "serving_gang_size",
            "Jobs coalesced per gang-batched Gramian dispatch",
            buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0),
        ).observe(float(size))

    def _note_queue_age(self, job: Job) -> None:
        """Admission→start latency, per job kind — the queueing SLO
        series gang tuning and /statusz watch. Observed at the
        QUEUED→RUNNING transition; a replayed job's age spans the
        crash, which is exactly the latency its submitter saw."""
        from spark_examples_tpu_torch import obs

        obs.get_registry().histogram(
            "serving_queue_age_seconds",
            "Admission-to-start latency of analysis jobs by kind",
        ).labels(kind=job.spec.kind).observe(
            max(0.0, time.time() - job.submitted_unix)
        )

    def _execute_gang(self, jobs: List[Job]) -> None:
        """Run a coalesced gang: per-job journal transitions exactly as
        solo execution writes them (crash-safe replay semantics are
        UNCHANGED — a kill mid-gang re-queues every started member and
        re-execution is bit-identical whatever gang it lands in), one
        batched engine dispatch, per-job finishes."""
        from spark_examples_tpu_torch import obs
        from spark_examples_tpu_torch.resilience import faults

        live: List[Job] = []
        with self._lock:
            for job in jobs:
                if job.state != JOB_QUEUED:
                    continue
                job.state = JOB_RUNNING
                live.append(job)
        # Disk I/O outside the tier lock (submit() reasoning).
        for job in live:
            self._journal_append_safe({"e": "start", "id": job.id})
            self._note_queue_age(job)
            with obs.trace_context(job.trace_id):
                obs.instant(
                    "job_transition", scope="p", id=job.id,
                    to=JOB_RUNNING,
                )
        for job in live:
            try:
                faults.inject("serving.job.kill", key=job.id)
            except faults.InjectedFault as e:
                # As in _execute: journal left exactly as a SIGKILL
                # would leave it — every started member re-queues on
                # replay.
                raise SimulatedCrash(str(e)) from e
        runnable: List[Job] = []
        for job in live:
            try:
                faults.inject("serving.job.run", key=job.id)
            except Exception as e:  # noqa: BLE001 — member isolation
                self._finish(job, error=f"{type(e).__name__}: {e}")
                if isinstance(e, IOError):
                    self._breaker.record_failure()
                else:
                    self._breaker.record_success()
            else:
                runnable.append(job)
        if not runnable:
            return
        self._note_gang(len(runnable))
        try:
            # One batched dispatch can only carry one thread context:
            # the gang span binds the LEAD's trace id; members are
            # recoverable from the span's job-id list.
            with obs.trace_context(runnable[0].trace_id), obs.span(
                "job.gang",
                size=len(runnable),
                jobs=",".join(j.id for j in runnable),
            ):
                rows_by_job = self._engine.run_gang(
                    [
                        job_config(j.spec, self._base)
                        for j in runnable
                    ]
                )
        except Exception as e:  # noqa: BLE001 — gang isolation boundary
            for job in runnable:
                self._finish(job, error=f"{type(e).__name__}: {e}")
                if isinstance(e, IOError):
                    self._breaker.record_failure()
                else:
                    self._breaker.record_success()
        else:
            for job, rows in zip(runnable, rows_by_job):
                self._finish(job, rows=rows)
                self._breaker.record_success()

    def _worker_loop(self) -> None:
        while not self._stop.is_set():
            self._maybe_adopt_peers()
            job = self._queue.pop(timeout=0.25)
            if job is None:
                continue
            try:
                self._dispatch(job)
            except SimulatedCrash as e:
                print(
                    f"analysis worker crashed (simulated kill): {e}",
                    file=sys.stderr,
                )
                return  # the thread dies, as the process would
            except Exception as e:  # noqa: BLE001 — worker survival
                # _execute isolates job failures itself; anything that
                # still escapes (a tier-level bug) must not silently
                # kill the only worker and wedge every queued job.
                print(
                    f"WARNING: analysis worker error on {job.id}: "
                    f"{type(e).__name__}: {e}",
                    file=sys.stderr,
                )

    def _ckpt_dir(self, job: Job) -> Optional[str]:
        # Per-job Gramian snapshots make a killed job RESUME mid-ingest
        # instead of restarting; the checkpointed route is single-
        # variantset only, so multi-set jobs simply re-run (still
        # bit-identical — the manifest is deterministic).
        if job.spec.kind != "pca":
            # Read-scoring jobs have no Gramian to snapshot; replay
            # just re-runs them (per-pair results are deterministic).
            return None
        spec_vsids = job.spec.variant_set_ids or tuple(
            self._base.variant_set_ids
        )
        if self._journal_dir is None or len(spec_vsids) != 1:
            return None
        resolved = resolve_spec(job.spec, self._base)
        if resolved["samples"] or resolved["exclude_samples"]:
            # Sample-restricted cohorts don't compose with checkpointed
            # ingest (snapshot digests are full-frame); these jobs are
            # the small delta-tier queries — replay just re-runs them.
            return None
        # Replicated mode: checkpoints are SHARED (keyed by job id,
        # which adoption preserves), so a survivor resumes a dead
        # peer's Gramian from its last shard-group snapshot instead of
        # from zero.
        base = (
            self._store_root
            if self._store_root is not None
            else self._journal_dir
        )
        return os.path.join(base, "ckpt", job.id)

    def _journal_append_safe(self, event: Dict) -> None:
        """Append a TRANSITION event (start/done/fail), degrading loudly
        on failure instead of killing the worker: losing a transition
        only costs resume WORK, never correctness — replay re-queues
        the job and re-execution is bit-identical. (Submit events are
        different: those must land or the job is rolled back.)

        The fence check runs OUTSIDE the swallowing try on purpose: a
        ``FencedWriteError`` is a correctness verdict (this replica is
        a zombie whose lease a peer took over), never disk weather —
        degrading it to a warning would be exactly the torn merge
        fencing exists to prevent."""
        if self._journal is None:
            return
        self._fence_check()
        try:
            self._journal.append(event)
        except Exception as e:  # noqa: BLE001 — disk weather
            from spark_examples_tpu_torch import obs

            print(
                f"WARNING: journal append failed "
                f"({type(e).__name__}: {e}); job {event.get('id')} "
                "will re-run from its last durable event on resume.",
                file=sys.stderr,
            )
            obs.instant(
                "journal_append_failed",
                scope="p",
                id=str(event.get("id", "")),
                event=str(event.get("e", "")),
            )

    def _execute(self, job: Job) -> None:
        from spark_examples_tpu_torch import obs
        from spark_examples_tpu_torch.resilience import faults

        with self._lock:
            if job.state != JOB_QUEUED:
                # A rolled-back admission's stale heap entry (terminal
                # already): nothing to run.
                return
            job.state = JOB_RUNNING
        # Disk I/O outside the tier lock (submit() reasoning).
        self._journal_append_safe({"e": "start", "id": job.id})
        self._note_queue_age(job)
        ckpt: Optional[str] = None
        try:
            with obs.trace_context(job.trace_id):
                obs.instant(
                    "job_transition", scope="p", id=job.id,
                    to=JOB_RUNNING,
                )
                try:
                    faults.inject("serving.job.kill", key=job.id)
                except faults.InjectedFault as e:
                    # Leave the journal exactly as a SIGKILL here
                    # would: start recorded, no terminal event — and
                    # kill this worker.
                    raise SimulatedCrash(str(e)) from e
                ckpt = self._ckpt_dir(job)
                with obs.span(
                    "job.run",
                    job_id=job.id,
                    tenant=job.spec.tenant,
                    kind=job.spec.kind,
                ):
                    faults.inject("serving.job.run", key=job.id)
                    rows = self._engine.run(
                        job_config(
                            job.spec, self._base, checkpoint_dir=ckpt
                        ),
                        kind=job.spec.kind,
                    )
        except SimulatedCrash:
            raise
        except Exception as e:  # noqa: BLE001 — job isolation boundary
            self._finish(job, error=f"{type(e).__name__}: {e}")
            # IO-shaped failures (dead upstream source, injected
            # transport weather) feed the breaker; deterministic spec
            # errors are the tier ANSWERING and must not blow the fuse.
            if isinstance(e, IOError):
                self._breaker.record_failure()
            else:
                self._breaker.record_success()
        else:
            self._finish(job, rows=rows)
            self._breaker.record_success()
        # Snapshots belong to IN-FLIGHT work: any terminal outcome
        # reclaims the job's checkpoint dir (a failed id is never
        # reused — a resubmission gets a fresh seq and dir — so keeping
        # it would only leak disk). A crash skips this on purpose: the
        # re-queued same-id job resumes from these snapshots.
        if ckpt is not None:
            shutil.rmtree(ckpt, ignore_errors=True)

    def _finish(
        self,
        job: Job,
        rows: Optional[list] = None,
        error: Optional[str] = None,
    ) -> None:
        from spark_examples_tpu_torch import obs

        # Fence BEFORE any shared-visible mutation: a zombie's result
        # must never reach the cache, the job table, or the journal —
        # the adopting peer owns this job now and will produce the
        # (bit-identical) result itself.
        self._fence_check()
        with self._lock:
            if error is None:
                # Result BEFORE state: the HTTP surface serializes
                # under this lock (record_of/job_record/job_records),
                # but in-process callers holding a Job from job()/
                # jobs() may still read its fields lock-free, checking
                # state first — they must never observe a result-less
                # 'done'.
                job.result = rows
                job.state = JOB_DONE
                self._cache.put(job.key, job.id, rows)
                event = {
                    "e": "done",
                    "id": job.id,
                    "rows": [list(r) for r in rows],
                }
                _count_job("done")
            else:
                job.error = error
                job.state = JOB_FAILED
                event = {"e": "fail", "id": job.id, "error": error}
                _count_job("failed")
            if self._by_key.get(job.key) == job.id:
                self._by_key.pop(job.key, None)
            self._queue.release(job.spec.tenant)
            self._prune_terminal_locked()
        # Disk I/O outside the tier lock (submit() reasoning).
        self._journal_append_safe(event)
        self._index_put(job)
        obs.instant(
            "job_transition", scope="p", id=job.id, to=job.state
        )

    def _prune_terminal_locked(self) -> None:
        """Evict the oldest terminal jobs beyond the retention bound
        (active jobs are never evicted; recent results stay reachable
        through the LRU cache and the journal regardless)."""
        assert_lock_held(
            self._lock, "AnalysisJobTier._prune_terminal_locked"
        )
        terminal = [
            j
            for j in self._jobs.values()
            if j.state in (JOB_DONE, JOB_FAILED)
        ]
        excess = len(terminal) - self._retention
        if excess <= 0:
            return
        terminal.sort(key=lambda j: j.seq)
        for job in terminal[:excess]:
            self._jobs.pop(job.id, None)

    # -- crash recovery -------------------------------------------------------

    def _replay(self) -> None:
        """Rebuild state from the journal: done/failed jobs restore the
        queryable table (+ warm cache); queued/running jobs re-queue in
        original submission order — the deterministic resume a killed
        server owes its clients.

        Runs under the tier lock even though it is called from
        ``__init__`` before any worker exists: the lock-discipline the
        static gate proves (GL007/GL009) is uniform, not "except during
        construction" — and a future caller replaying into a LIVE tier
        would otherwise inherit a silent race instead of a queued one.
        """
        from spark_examples_tpu_torch import obs

        with self._lock, obs.span("job.replay", journal=self._journal.path):
            events = list(JobJournal.replay_events(self._journal_dir))
            for e in events:
                kind = e.get("e")
                if kind == "submit":
                    try:
                        spec = JobSpec.from_record(e["spec"])
                    except (KeyError, ValueError) as exc:
                        print(
                            f"WARNING: journaled spec for {e.get('id')} "
                            f"is unusable ({exc}); dropping it.",
                            file=sys.stderr,
                        )
                        continue
                    seq = int(e.get("seq", 0))
                    job = Job(
                        id=str(e["id"]),
                        spec=spec,
                        key=str(e.get("key") or cohort_key(spec, self._base)),
                        seq=seq,
                        submitted_unix=float(e.get("ts", 0.0)),
                        # Restore the admission-minted trace id so the
                        # replayed execution re-emits ITS timeline
                        # (same span names/order; durations differ).
                        trace_id=(
                            str(e["trace"]) if e.get("trace") else None
                        ),
                    )
                    self._jobs[job.id] = job
                    self._seq = max(self._seq, seq)
                elif kind in ("start", "done", "fail"):
                    job = self._jobs.get(str(e.get("id", "")))
                    if job is None:
                        continue
                    if kind == "start":
                        job.state = JOB_RUNNING
                    elif kind == "done":
                        job.state = JOB_DONE
                        job.result = [
                            tuple(r) for r in e.get("rows", [])
                        ]
                        self._cache.put(job.key, job.id, job.result)
                    else:
                        job.state = JOB_FAILED
                        job.error = str(e.get("error", ""))
            requeue = sorted(
                (
                    j
                    for j in self._jobs.values()
                    if j.state in (JOB_QUEUED, JOB_RUNNING)
                ),
                key=lambda j: j.seq,
            )
            for job in requeue:
                job.state = JOB_QUEUED
                self._by_key[job.key] = job.id
                # Bypass shed checks: the crashed server already
                # admitted these — resume must not drop admitted work.
                self._queue.readmit(
                    job, job.spec.tenant, job.spec.priority, job.seq
                )
                obs.instant(
                    "job_transition", scope="p", id=job.id, to=JOB_QUEUED
                )
            # The journal holds the server's whole history; the
            # in-memory table is bounded the same way it is live.
            self._prune_terminal_locked()
            if self._jobs:
                done = sum(
                    1 for j in self._jobs.values() if j.state == JOB_DONE
                )
                print(
                    f"Analysis journal replayed: {len(self._jobs)} "
                    f"job(s), {done} done (cache warm), "
                    f"{len(requeue)} re-queued."
                )

    # -- peer failover ----------------------------------------------------------

    def _maybe_adopt_peers(self) -> None:
        """Throttled peer-lease scan (at most one per lease TTL):
        workers call this on their dispatch path, so failover needs no
        extra thread. The tier lock guards ONLY the throttle timestamp;
        the scan itself does store I/O and must run unlocked. Never
        raises — failover trouble must not kill the worker that would
        perform the next failover."""
        replica = self._replica
        if replica is None or self._store_root is None:
            return
        now = time.monotonic()
        with self._lock:
            if now - self._peer_scan_monotonic < replica.ttl_s:
                return
            self._peer_scan_monotonic = now
        try:
            self.adopt_expired_peers()
        except Exception as e:  # noqa: BLE001 — failover must not wedge
            print(
                f"WARNING: peer adoption scan failed: "
                f"{type(e).__name__}: {e}",
                file=sys.stderr,
            )

    def adopt_expired_peers(self) -> int:
        """Scan for peers whose lease expired, take each over by CAS
        (the fencing-token bump that turns the dead peer into a fenced
        zombie if it was merely paused), and re-queue its in-flight
        jobs here in original submission order. Returns the number of
        peers adopted.

        At-least-once by construction: the ``adopted/<peer>`` marker is
        written LAST, so a survivor dying mid-adoption leaves the peer
        adoptable by the next scan — re-execution is bit-identical and
        the merge below dedups, so a double adoption is safe."""
        replica = self._replica
        if (
            replica is None
            or self._store_root is None
            or replica.degraded()
        ):
            return 0
        adopted = 0
        for peer in replica.expired_peers():
            taken = replica.takeover(peer)
            if taken is None:
                # Raced by another survivor (its CAS won), or store
                # weather — either way, not ours to adopt this round.
                continue
            self._adopt_peer(peer.name, taken)
            adopted += 1
        return adopted

    def _adopt_peer(self, peer_name: str, taken: Lease) -> None:
        from spark_examples_tpu_torch import obs

        assert self._replica is not None and self._store_root is not None
        peer_dir = os.path.join(
            self._store_root, "replicas", peer_name
        )
        with obs.span(
            "job.adopt", peer=peer_name, fence=taken.token
        ):
            requeued = self._replay_foreign(peer_dir, peer_name)
            # Marker BEFORE release: once the marker exists the peer is
            # never re-adopted; until it exists a crash here re-runs
            # the whole adoption. Fenced on OUR lease — a survivor that
            # itself went zombie mid-adoption is rejected loudly.
            self._replica.mark_adopted(
                peer_name,
                json.dumps(
                    {
                        "by": self._replica.replica_id,
                        "fence": taken.token,
                        "requeued": requeued,
                    },
                    sort_keys=True,
                ).encode("utf-8"),
            )
            # Release the taken-over lease doc: the name disappears
            # from scans, and the zombie stays fenced regardless (a
            # MISSING lease doc fails check_fence just as a stale
            # token does).
            self._replica.finish_takeover(taken)

    def _replay_foreign(self, directory: str, peer: str) -> int:
        """Replay a dead peer's journal into THIS tier: terminal jobs
        warm the result cache and job table, in-flight jobs re-queue in
        the peer's submission order (with fresh LOCAL seqs — relative
        order is preserved, and local admissions hold their own seqs).
        Returns the number of jobs re-queued.

        Disk discipline as everywhere in this tier: the peer journal is
        read BEFORE the tier lock, adopted submit events are journaled
        AFTER it."""
        from spark_examples_tpu_torch import obs

        try:
            events = list(JobJournal.replay_events(directory))
        except Exception as e:  # noqa: BLE001 — a torn peer journal
            print(
                f"WARNING: adopting {peer}: journal unreadable "
                f"({type(e).__name__}: {e}); its in-flight jobs are "
                "lost to this survivor (clients resubmit).",
                file=sys.stderr,
            )
            return 0
        foreign: Dict[str, Job] = {}
        order: List[str] = []
        for e in events:
            kind = e.get("e")
            if kind == "submit":
                try:
                    spec = JobSpec.from_record(e["spec"])
                except (KeyError, ValueError):
                    continue
                jid = str(e["id"])
                foreign[jid] = Job(
                    id=jid,
                    spec=spec,
                    key=str(
                        e.get("key") or cohort_key(spec, self._base)
                    ),
                    seq=int(e.get("seq", 0)),
                    submitted_unix=float(e.get("ts", 0.0)),
                    # The peer's admission-minted trace id survives
                    # adoption: the re-run emits onto the SAME timeline
                    # its submitter is polling.
                    trace_id=(
                        str(e["trace"]) if e.get("trace") else None
                    ),
                )
                order.append(jid)
            elif kind in ("start", "done", "fail"):
                job = foreign.get(str(e.get("id", "")))
                if job is None:
                    continue
                if kind == "start":
                    job.state = JOB_RUNNING
                elif kind == "done":
                    job.state = JOB_DONE
                    job.result = [tuple(r) for r in e.get("rows", [])]
                else:
                    job.state = JOB_FAILED
                    job.error = str(e.get("error", ""))
        requeue: List[Job] = []
        with self._lock:
            for jid in order:
                job = foreign[jid]
                if jid in self._jobs:
                    # Already known here — a prior partial adoption, or
                    # the peer adopted it from US earlier. Keep ours.
                    continue
                if job.state in (JOB_DONE, JOB_FAILED):
                    self._seq += 1
                    job.seq = self._seq
                    self._jobs[jid] = job
                    if job.state == JOB_DONE and job.result is not None:
                        self._cache.put(job.key, jid, job.result)
                    continue
                if self._by_key.get(job.key) is not None:
                    # An identical cohort is already active here; its
                    # result will serve the peer's submitter from the
                    # cache (same key → bit-identical rows).
                    continue
                self._seq += 1
                job.seq = self._seq
                job.state = JOB_QUEUED
                self._jobs[jid] = job
                self._by_key[job.key] = jid
                # Bypass shed checks: the dead peer already admitted
                # these — failover must not drop admitted work.
                self._queue.readmit(
                    job, job.spec.tenant, job.spec.priority, job.seq
                )
                requeue.append(job)
            self._prune_terminal_locked()
        # The adopted submissions enter THIS replica's journal so a
        # crash here resumes them yet again (transition-grade
        # durability: the shared journal on the dead peer still holds
        # them until its marker lands).
        for job in requeue:
            self._journal_append_safe(self._submit_event(job))
            obs.instant(
                "job_transition", scope="p", id=job.id, to=JOB_QUEUED
            )
        if requeue:
            print(
                f"Adopted {len(requeue)} in-flight job(s) from "
                f"expired replica {peer}."
            )
        return len(requeue)
