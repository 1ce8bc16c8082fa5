"""PCA-as-a-service: the multi-tenant analysis job tier.

The JAX package's ``serving`` package on PyTorch. ``genomics/service.py``
fronts it with ``POST /analyze`` + ``GET /jobs/<id>``: clients submit
cohort specs and the server schedules PCA runs against its resident
source. Admission control (circuit breaker + bounded priority queue +
per-tenant quotas + 429/Retry-After shedding), a crash-safe append-only
job journal with deterministic replay, a result cache with single-flight
dedup keyed on the cohort hash, the delta and gang Gramian tiers, and a
re-entrant execution engine over the batch driver. Journals, delta files
and store objects keep the JAX package's formats, so either package
replays what the other wrote.

Import note: this package imports no torch at import time (the engine
imports the driver lazily), so a ``serve-cohort`` without ``--analyze``
never pays the import.
"""

from spark_examples_tpu_torch.serving.deltas import (
    DeltaIndex,
    gramian_base_key,
)
from spark_examples_tpu_torch.serving.engine import AnalysisEngine
from spark_examples_tpu_torch.serving.jobs import (
    Job,
    JobJournal,
    JobSpec,
    cohort_key,
    job_config,
)
from spark_examples_tpu_torch.serving.queue import (
    AdmissionError,
    AdmissionQueue,
    JournalUnavailableError,
    QueueFullError,
    QuotaExceededError,
)
from spark_examples_tpu_torch.serving.replica import (
    DEFAULT_HEARTBEAT_S,
    DEFAULT_LEASE_TTL_S,
    LeaseManager,
    generate_replica_id,
)
from spark_examples_tpu_torch.serving.tier import (
    AnalysisJobTier,
    SimulatedCrash,
)

__all__ = [
    "AdmissionError",
    "AdmissionQueue",
    "AnalysisEngine",
    "AnalysisJobTier",
    "DEFAULT_HEARTBEAT_S",
    "DEFAULT_LEASE_TTL_S",
    "DeltaIndex",
    "Job",
    "JobJournal",
    "JobSpec",
    "JournalUnavailableError",
    "LeaseManager",
    "QueueFullError",
    "QuotaExceededError",
    "SimulatedCrash",
    "cohort_key",
    "generate_replica_id",
    "gramian_base_key",
    "job_config",
]
