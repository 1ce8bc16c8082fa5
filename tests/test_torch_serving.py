"""The port's analysis job tier (``spark_examples_tpu_torch/serving/``).

The cases of ``tests/test_serving.py`` run against the port on the CPU:
admission control (bounded priority queue, per-tenant quotas, breaker
shedding, 429 + Retry-After), the crash-safe job journal with
deterministic replay, the result cache with single-flight dedup, the
re-entrant engine (results bit-identical to the batch driver), the
/analyze + /jobs HTTP surface, the delta and gang tiers and the live
introspection plane, with the ``*_locked`` asserts on. ``/statusz``
carries no ``jit_retraces`` or ``compile_cache`` in the port.

``TestAgainstTheJaxTier`` then holds the port to the JAX package in one
process: job rows within 1e-4 of the JAX tier's on the same cohort and
specs, identical cohort keys, the sketch routing, the ``pairhmm`` kind,
and each package's tier replaying the journal and the ``deltas/``
directory the other wrote.
"""

import http.client
import json
import os
import socket
import time

import numpy as np
import pytest
import torch

from spark_examples_tpu_torch.genomics.fixtures import (
    DEFAULT_VARIANT_SET_ID,
    synthetic_cohort,
)
from spark_examples_tpu_torch.genomics.service import GenomicsServiceServer
from spark_examples_tpu_torch.obs.session import TelemetrySession
from spark_examples_tpu_torch.resilience import (
    BreakerSet,
    CircuitOpenError,
    FaultPlan,
    FaultRule,
    faults,
)
from spark_examples_tpu_torch.resilience.policy import RetryPolicy
from spark_examples_tpu_torch.serving import (
    AnalysisEngine as _PortEngine,
    AnalysisJobTier,
    JobJournal,
    JobSpec,
    QueueFullError,
    QuotaExceededError,
    cohort_key,
    job_config,
)
from spark_examples_tpu_torch.serving.queue import AdmissionQueue
from spark_examples_tpu_torch.utils.config import PcaConfig
from spark_examples_tpu_torch.utils.lockcheck import set_lock_check

def AnalysisEngine(source, **kw):
    """The port's engine on the CPU (its default device is the card)."""
    kw.setdefault("device", "cpu")
    return _PortEngine(source, **kw)


_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _lock_check_enabled():
    """The *_locked runtime backstop (docs/CONCURRENCY.md) is ON for
    this whole suite: every tier/queue operation the tests drive also
    asserts its lock preconditions dynamically."""
    prev = set_lock_check(True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    set_lock_check(prev)
    torch.set_num_threads(threads)


def _load_validator():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "validate_trace",
        os.path.join(_REPO_ROOT, "scripts", "validate_trace.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


validate = _load_validator()

REFS = "17:41196311:41277499"


def _base_conf(**kw):
    kw.setdefault("variant_set_ids", [DEFAULT_VARIANT_SET_ID])
    kw.setdefault("references", REFS)
    kw.setdefault("bases_per_partition", 20_000)
    kw.setdefault("block_variants", 16)
    kw.setdefault("ingest_workers", 2)
    kw.setdefault("device", "cpu")
    return PcaConfig(**kw)


@pytest.fixture(scope="module")
def served_source():
    """One cohort + base config + the batch-engine baseline rows every
    serving result must match bit-for-bit."""
    src = synthetic_cohort(8, 60, seed=9)
    base = _base_conf()
    rows = AnalysisEngine(src).run(base)
    return src, base, rows


class TestJobSpec:
    def test_unknown_field_is_a_loud_error(self):
        with pytest.raises(ValueError, match="unknown spec field"):
            JobSpec.from_record({"min_allele_freq": 0.1})

    def test_validation(self):
        with pytest.raises(ValueError, match="num_pc"):
            JobSpec.from_record({"num_pc": 0})
        with pytest.raises(ValueError, match="min_allele_frequency"):
            JobSpec.from_record({"min_allele_frequency": 1.5})
        with pytest.raises(ValueError, match="variant_set_ids"):
            JobSpec.from_record({"variant_set_ids": [42]})
        with pytest.raises(ValueError, match="priority"):
            # Unbounded priority would let one tenant park above
            # everyone else forever.
            JobSpec.from_record({"priority": 11})
        with pytest.raises(ValueError, match="JSON object"):
            JobSpec.from_record([1, 2])

    def test_roundtrip(self):
        spec = JobSpec.from_record(
            {
                "tenant": "t",
                "variant_set_id": "vs",
                "num_pc": 3,
                "priority": 5,
            }
        )
        assert JobSpec.from_record(spec.to_record()) == spec

    def test_cohort_key_ignores_tenant_and_priority(self):
        base = _base_conf()
        a = JobSpec(tenant="a", priority=1, num_pc=2)
        b = JobSpec(tenant="b", priority=9, num_pc=2)
        assert cohort_key(a, base) == cohort_key(b, base)

    def test_cohort_key_covers_analysis_parameters(self):
        base = _base_conf()
        keys = {
            cohort_key(JobSpec(num_pc=2), base),
            cohort_key(JobSpec(num_pc=3), base),
            cohort_key(JobSpec(min_allele_frequency=0.1), base),
            cohort_key(JobSpec(references="17:1:1000"), base),
            cohort_key(JobSpec(variant_set_ids=("other",)), base),
        }
        assert len(keys) == 5

    def test_spec_inherits_server_analysis_defaults(self):
        """An empty submission analyzes EXACTLY the cohort the server's
        own batch run would: all_references and the AF filter inherit
        the server config unless the client sets them."""
        from spark_examples_tpu_torch.serving.jobs import resolve_spec

        base = _base_conf(
            min_allele_frequency=0.05, all_references=True, num_pc=4
        )
        resolved = resolve_spec(JobSpec.from_record({}), base)
        assert resolved["min_allele_frequency"] == 0.05
        assert resolved["all_references"] is True
        assert resolved["num_pc"] == 4
        # An explicit client value wins over the server default.
        resolved = resolve_spec(
            JobSpec.from_record(
                {"min_allele_frequency": 0.2, "all_references": False}
            ),
            base,
        )
        assert resolved["min_allele_frequency"] == 0.2
        assert resolved["all_references"] is False

    def test_cohort_key_resolves_server_defaults(self):
        """An explicit spec equal to the defaults shares the default's
        key — the cache must unify them."""
        base = _base_conf()
        assert cohort_key(JobSpec(), base) == cohort_key(
            JobSpec(
                variant_set_ids=(DEFAULT_VARIANT_SET_ID,),
                references=REFS,
            ),
            base,
        )


class TestAdmissionQueue:
    def test_priority_then_submission_order(self):
        q = AdmissionQueue(capacity=10)
        q.admit("low", "t", 0, 1)
        q.admit("hi", "t", 5, 2)
        q.admit("mid", "t", 1, 3)
        assert [q.pop(0), q.pop(0), q.pop(0)] == ["hi", "mid", "low"]

    def test_capacity_sheds_with_growing_retry_after(self):
        q = AdmissionQueue(capacity=1, tenant_quota=10)
        q.admit("a", "t", 0, 1)
        hints = []
        for seq in (2, 3, 4):
            with pytest.raises(QueueFullError) as ei:
                q.admit("b", "t", 0, seq)
            hints.append(ei.value.retry_after)
        # The hint is RetryPolicy.backoff_delay over the shed streak:
        # deterministic (jitter=0) and growing.
        policy = RetryPolicy(
            base_delay=1.0, max_delay=30.0, multiplier=2.0, jitter=0.0
        )
        assert hints == [policy.backoff_delay(n) for n in (1, 2, 3)]
        assert hints[0] < hints[1] < hints[2]

    def test_tenant_quota_holds_and_releases_at_terminal(self):
        q = AdmissionQueue(capacity=10, tenant_quota=2)
        q.admit("a", "t1", 0, 1)
        q.admit("b", "t1", 0, 2)
        with pytest.raises(QuotaExceededError) as ei:
            q.admit("c", "t1", 0, 3)
        assert ei.value.retry_after > 0
        q.admit("d", "t2", 0, 4)  # another tenant is unaffected
        # Dequeue alone must NOT reclaim quota (the job is running)...
        assert q.pop(0) == "a"
        with pytest.raises(QuotaExceededError):
            q.admit("c", "t1", 0, 5)
        # ...terminal release does.
        q.release("t1")
        q.admit("c", "t1", 0, 6)

    def test_readmit_bypasses_shed_checks(self):
        q = AdmissionQueue(capacity=1, tenant_quota=1)
        q.admit("a", "t", 0, 1)
        q.readmit("b", "t", 0, 2)  # replayed work is never dropped
        assert q.depth() == 2


class TestJobJournal:
    def test_append_replay_roundtrip(self, tmp_path):
        d = str(tmp_path / "j")
        j = JobJournal(d)
        j.append({"e": "submit", "id": "x", "seq": 1})
        j.append({"e": "done", "id": "x", "rows": [["s", 0.5, -0.25, "d"]]})
        j.close()
        events = list(JobJournal.replay_events(d))
        assert [e["e"] for e in events] == ["submit", "done"]
        assert events[1]["rows"] == [["s", 0.5, -0.25, "d"]]

    def test_torn_tail_is_skipped_with_warning(self, tmp_path, capsys):
        d = str(tmp_path / "j")
        j = JobJournal(d)
        j.append({"e": "submit", "id": "x", "seq": 1})
        j.close()
        with open(os.path.join(d, "jobs.journal.jsonl"), "ab") as f:
            f.write(b'{"e": "start", "id"')  # SIGKILL mid-append
        events = list(JobJournal.replay_events(d))
        assert [e["e"] for e in events] == ["submit"]
        assert "torn/corrupt journal line" in capsys.readouterr().err

    def test_torn_write_fault_seam(self, tmp_path):
        d = str(tmp_path / "j")
        plan = FaultPlan(
            seed=1,
            rules=[
                FaultRule(
                    site="serving.journal.append", kind="torn", times=1
                )
            ],
        )
        j = JobJournal(d)
        j.append({"e": "submit", "id": "a", "seq": 1})
        with faults.active_plan(plan):
            j.append({"e": "start", "id": "a"})  # torn: half the bytes
        j.close()
        assert plan.fired_total == 1
        events = list(JobJournal.replay_events(d))
        assert [e["e"] for e in events] == ["submit"]

    def test_flush_never_blocks_on_a_wedged_writer(self, tmp_path):
        """The fail-stop path calls flush; a writer wedged inside an
        append (hung disk) holds the journal lock — flush must give up
        rather than convert exit-77 into a permanent hang."""
        import time as _time

        j = JobJournal(str(tmp_path / "j"))
        assert j._lock.acquire()  # the "wedged writer"
        try:
            t0 = _time.monotonic()
            j.flush()  # must return (bounded wait), not deadlock
            assert _time.monotonic() - t0 < 10.0
        finally:
            j._lock.release()
        j.close()

    def test_torn_tail_healed_on_reopen_before_appending(self, tmp_path):
        """A reopened journal must terminate a crash-torn tail before
        its first append — otherwise the next (acknowledged) event
        merges into the torn line and vanishes from every replay."""
        d = str(tmp_path / "j")
        j = JobJournal(d)
        j.append({"e": "submit", "id": "a", "seq": 1})
        j.close()
        with open(os.path.join(d, "jobs.journal.jsonl"), "ab") as f:
            f.write(b'{"e": "start", "id"')  # SIGKILL mid-append
        j2 = JobJournal(d)  # the restarted server's journal
        j2.append({"e": "submit", "id": "b", "seq": 2})
        j2.close()
        events = list(JobJournal.replay_events(d))
        # The torn line is skipped alone; the post-restart event
        # survives intact.
        assert [(e["e"], e["id"]) for e in events] == [
            ("submit", "a"),
            ("submit", "b"),
        ]

    def test_registers_watchdog_flush_hook(self, tmp_path):
        from spark_examples_tpu_torch.utils import watchdog

        d = str(tmp_path / "j")
        j = JobJournal(d)
        name = f"job-journal:{j.path}"
        assert name in watchdog._flush_hooks
        j.close()
        assert name not in watchdog._flush_hooks

    def test_mixed_version_journal_replays_byte_compatibly(
        self, tmp_path, served_source
    ):
        """One journal directory accumulated across server generations
        — pre-round-14 submits (no trace field), trace-carrying
        submits, and replicated-mode submits (replica identity +
        fencing token) — replays as ONE history: new fields survive
        verbatim, old records gain nothing, and the rebuilt tier state
        (terminal results, requeue order, restored trace ids) is what
        a single-version journal of the same events produces."""
        src, base, _ = served_source
        d = str(tmp_path / "j")
        j = JobJournal(d)
        # Generation 1: the original event shape — no trace field.
        j.append(
            {"e": "submit", "id": "old", "seq": 1, "key": "k-old",
             "spec": {"tenant": "t"}, "ts": 1.0}
        )
        j.append({"e": "start", "id": "old"})
        j.append(
            {"e": "done", "id": "old",
             "rows": [["s", 0.5, -0.25, "d"]]}
        )
        # Generation 2 (round 14+): the admission-minted trace id.
        j.append(
            {"e": "submit", "id": "traced", "seq": 2, "key": "k-tr",
             "spec": {"tenant": "t"}, "ts": 2.0, "trace": "t-abc"}
        )
        j.append({"e": "start", "id": "traced"})
        # Generation 3 (replicated serving): replica + fence ride the
        # submit; a non-replica reader must ignore them, not die.
        j.append(
            {"e": "submit", "id": "fenced", "seq": 3, "key": "k-fe",
             "spec": {"tenant": "t"}, "ts": 3.0, "trace": "t-def",
             "replica": "r-host-1-abc123", "fence": 7}
        )
        j.close()

        events = list(JobJournal.replay_events(d))
        assert [e["e"] for e in events] == [
            "submit", "start", "done", "submit", "start", "submit",
        ]
        # New fields replay verbatim; old records gained nothing.
        assert events[5]["replica"] == "r-host-1-abc123"
        assert events[5]["fence"] == 7
        assert "trace" not in events[0] and "replica" not in events[0]

        tier = AnalysisJobTier(
            AnalysisEngine(src), base, workers=0, journal_dir=d
        )
        try:
            by_id = {job.id: job for job in tier.jobs()}
            assert by_id["old"].state == "done"
            assert by_id["old"].result == [("s", 0.5, -0.25, "d")]
            assert by_id["old"].trace_id is None
            # In-flight jobs of every generation re-queue in original
            # submission order with their trace ids restored.
            assert by_id["traced"].state == "queued"
            assert by_id["traced"].trace_id == "t-abc"
            assert by_id["fenced"].state == "queued"
            assert by_id["fenced"].trace_id == "t-def"
            assert [job.id for job in tier.jobs()] == [
                "old", "traced", "fenced",
            ]
            assert tier.queue_depth() == 2
        finally:
            tier.close()

    def test_registry_generated_mixed_version_replay_pins_bytes(
        self, tmp_path, served_source
    ):
        """Round 19 gate: the mixed-version journal is GENERATED from
        the GL015 key registry (``journal_schema``) instead of
        hand-typed literals — if the registry and the reader drift,
        this test and the static rule fail together. Covers the
        round-6 shape, the round-17 replicated submit (replica +
        fence), and the round-18 sketch-mode submit, and pins replay
        byte-identity: replaying never rewrites the journal file, and
        every value folds back verbatim."""
        from spark_examples_tpu_torch.serving import journal_schema as js

        src, base, _ = served_source
        d = str(tmp_path / "j")
        events = [
            {"e": "submit", "id": "old", "seq": 1, "key": "k-old",
             "spec": {"tenant": "t"}, "ts": 1.0},
            {"e": "start", "id": "old"},
            {"e": "fail", "id": "old", "error": "worker lost"},
            # Round 17: replica identity + fencing token on the submit.
            {"e": "submit", "id": "replicated", "seq": 2, "key": "k-re",
             "spec": {"tenant": "t"}, "ts": 2.0, "trace": "t-re",
             "replica": "r-host-1", "fence": 3},
            # Round 18: million-sample cohorts submit sketch-mode PCA.
            {"e": "submit", "id": "sketchy", "seq": 3, "key": "k-sk",
             "spec": {"tenant": "t", "pca_mode": "sketch"}, "ts": 3.0,
             "trace": "t-sk"},
        ]
        for ev in events:
            assert ev["e"] in js.JOURNAL_EVENT_KINDS
            assert set(ev) <= js.JOURNAL_KEYS
            required = (
                js.JOURNAL_REQUIRED_KEYS
                if ev["e"] == "submit"
                else {"e", "id"}
            )
            assert required <= set(ev)
        j = JobJournal(d)
        for ev in events:
            j.append(ev)
        j.close()

        path = os.path.join(d, "jobs.journal.jsonl")
        with open(path, "rb") as f:
            raw_before = f.read()
        assert list(JobJournal.replay_events(d)) == events
        with open(path, "rb") as f:
            assert f.read() == raw_before, "replay must never rewrite"

        tier = AnalysisJobTier(
            AnalysisEngine(src), base, workers=0, journal_dir=d
        )
        try:
            by_id = {job.id: job for job in tier.jobs()}
            assert by_id["old"].state == "failed"
            assert by_id["old"].error == "worker lost"
            assert by_id["replicated"].state == "queued"
            assert by_id["replicated"].trace_id == "t-re"
            assert by_id["sketchy"].state == "queued"
            assert by_id["sketchy"].spec.pca_mode == "sketch"
        finally:
            tier.close()


class TestTierExecution:
    def test_job_matches_batch_driver_bit_identical(self, served_source):
        src, base, baseline = served_source
        tier = AnalysisJobTier(AnalysisEngine(src), base, workers=0)
        job, created = tier.submit(JobSpec(tenant="t1"))
        assert created and job.state == "queued"
        assert tier.step(timeout=1.0)
        assert job.state == "done"
        assert job.result == baseline  # exact float equality
        tier.close()

    def test_single_flight_dedup_and_result_cache(self, served_source):
        src, base, baseline = served_source
        tier = AnalysisJobTier(AnalysisEngine(src), base, workers=0)
        job, created = tier.submit(JobSpec(tenant="a"))
        dup, dup_created = tier.submit(JobSpec(tenant="b", priority=3))
        assert created and not dup_created
        assert dup.id == job.id  # one execution, any number of waiters
        # ...but the dedup response is a CALLER-SCOPED view: tenant b
        # sees its own identity, never tenant a's record.
        assert dup.spec.tenant == "b"
        assert job.spec.tenant == "a"
        tier.step(timeout=1.0)
        # A post-completion identical submission is a cache hit: no new
        # work, no queue traffic — and the original record is not
        # mutated for its own submitter.
        hit, hit_created = tier.submit(JobSpec(tenant="c"))
        assert not hit_created and hit.state == "done" and hit.cached
        assert hit.result == baseline
        assert hit.spec.tenant == "c"
        assert job.cached is False
        assert tier.queue_depth() == 0
        # A different analysis is NOT unified.
        other, other_created = tier.submit(JobSpec(tenant="a", num_pc=3))
        assert other_created and other.id != job.id
        tier.close()

    def test_failed_job_reports_and_does_not_poison_cache(
        self, served_source
    ):
        src, base, _ = served_source
        plan = FaultPlan(
            seed=2,
            rules=[
                FaultRule(site="serving.job.run", kind="error", times=1)
            ],
        )
        tier = AnalysisJobTier(AnalysisEngine(src), base, workers=0)
        with faults.active_plan(plan):
            job, _ = tier.submit(JobSpec(tenant="t"))
            tier.step(timeout=1.0)
        assert job.state == "failed"
        assert "injected" in job.error
        # The key is free again: resubmission runs fresh and succeeds.
        retry, created = tier.submit(JobSpec(tenant="t"))
        assert created and retry.id != job.id
        tier.step(timeout=1.0)
        assert retry.state == "done"
        tier.close()

    def test_breaker_opens_on_io_failing_jobs_and_sheds(
        self, served_source
    ):
        src, base, _ = served_source
        plan = FaultPlan(
            seed=3,
            rules=[
                FaultRule(site="serving.job.run", kind="error", times=2)
            ],
        )
        tier = AnalysisJobTier(
            AnalysisEngine(src),
            base,
            workers=0,
            breakers=BreakerSet(
                "serving:", failure_threshold=2, cooldown_s=60.0
            ),
        )
        with faults.active_plan(plan):
            for _ in range(2):
                job, _ = tier.submit(JobSpec(tenant="t"))
                tier.step(timeout=1.0)
                assert job.state == "failed"
        # Two IO-shaped job failures crossed the threshold: the analyze
        # endpoint now sheds submissions instantly.
        with pytest.raises(CircuitOpenError):
            tier.submit(JobSpec(tenant="t"))
        tier.close()

    def test_spec_error_fails_job_without_feeding_breaker(
        self, served_source
    ):
        src, base, _ = served_source
        tier = AnalysisJobTier(
            AnalysisEngine(src),
            base,
            workers=0,
            breakers=BreakerSet(
                "serving:", failure_threshold=1, cooldown_s=60.0
            ),
        )
        # A deterministic config error (bad references string) is the
        # tier ANSWERING, not transport weather: threshold 1 must not
        # trip.
        job, _ = tier.submit(JobSpec(tenant="t", references="nonsense"))
        tier.step(timeout=1.0)
        assert job.state == "failed"
        ok, created = tier.submit(JobSpec(tenant="t"))
        assert created  # no CircuitOpenError
        tier.close()

    def test_journal_unavailable_sheds_and_rolls_back(
        self, served_source, tmp_path
    ):
        """A submission the journal cannot record must not run (it
        would vanish from resume): the admission rolls back, the client
        sheds retryably (429 reason=journal over HTTP), and neither
        quota nor the dedup table leaks."""
        from spark_examples_tpu_torch.serving import JournalUnavailableError

        src, base, baseline = served_source
        plan = FaultPlan(
            seed=4,
            rules=[
                FaultRule(
                    site="serving.journal.append", kind="error", times=1
                )
            ],
        )
        tier = AnalysisJobTier(
            AnalysisEngine(src),
            base,
            workers=0,
            tenant_quota=1,
            journal_dir=str(tmp_path / "journal"),
        )
        with faults.active_plan(plan):
            with pytest.raises(JournalUnavailableError) as ei:
                tier.submit(JobSpec(tenant="t"))
        assert ei.value.retry_after > 0
        assert tier.jobs() == []  # rolled back, not half-admitted
        assert tier.queue_depth() == 0  # no phantom heap entry either
        # Quota slot returned: the SAME tenant resubmits successfully
        # (quota is 1 — a leak would shed here) and the job runs.
        job, created = tier.submit(JobSpec(tenant="t"))
        assert created
        assert tier.step(timeout=1.0)
        assert job.state == "done" and job.result == baseline
        # The journal carries only the second (recorded) submission.
        tier.close()
        events = list(JobJournal.replay_events(str(tmp_path / "journal")))
        assert [e["e"] for e in events] == ["submit", "start", "done"]

    def test_terminal_jobs_evicted_beyond_retention(self, served_source):
        """The in-memory job table is bounded: oldest terminal jobs
        evict past the retention limit (a week of traffic must not
        become the OOM the admission queue exists to prevent)."""
        src, base, _ = served_source
        tier = AnalysisJobTier(
            AnalysisEngine(src), base, workers=0, job_retention=2
        )
        jobs = []
        for i in range(4):
            job, _ = tier.submit(JobSpec(tenant="t", num_pc=2 + i))
            tier.step(timeout=1.0)
            jobs.append(job)
        assert all(j.state == "done" for j in jobs)
        kept = {j.id for j in tier.jobs()}
        assert kept == {jobs[2].id, jobs[3].id}  # newest two survive
        # An evicted analysis is still served by the result cache.
        hit, created = tier.submit(JobSpec(tenant="x", num_pc=2))
        assert not created and hit.cached
        tier.close()

    def test_failed_job_reclaims_its_checkpoint_dir(
        self, served_source, tmp_path
    ):
        src, base, _ = served_source
        plan = FaultPlan(
            seed=9,
            rules=[
                FaultRule(site="serving.job.run", kind="error", times=1)
            ],
        )
        journal = str(tmp_path / "journal")
        tier = AnalysisJobTier(
            AnalysisEngine(src), base, workers=0, journal_dir=journal
        )
        with faults.active_plan(plan):
            job, _ = tier.submit(JobSpec(tenant="t"))
            tier.step(timeout=1.0)
        assert job.state == "failed"
        assert not os.path.exists(
            os.path.join(journal, "ckpt", job.id)
        )
        tier.close()

    def test_worker_threads_drain_the_queue(self, served_source):
        src, base, baseline = served_source
        tier = AnalysisJobTier(
            AnalysisEngine(src), base, workers=2
        ).start()
        jobs = [
            tier.submit(JobSpec(tenant=f"t{i}", num_pc=2 + i))[0]
            for i in range(3)
        ]
        deadline = time.time() + 120
        while time.time() < deadline and any(
            j.state not in ("done", "failed") for j in jobs
        ):
            time.sleep(0.05)
        assert [j.state for j in jobs] == ["done"] * 3
        # num_pc=2 job matches the baseline exactly even when executed
        # concurrently with others — the engine shares nothing mutable.
        assert jobs[0].result == baseline
        tier.close()

    def test_telemetry_artifacts_carry_the_job_story(
        self, served_source, tmp_path
    ):
        src, base, _ = served_source
        trace = str(tmp_path / "serv.trace.json")
        metrics = str(tmp_path / "serv.prom")
        with TelemetrySession(trace_out=trace, metrics_out=metrics):
            tier = AnalysisJobTier(
                AnalysisEngine(src),
                base,
                workers=0,
                queue_depth=2,
                tenant_quota=1,
                journal_dir=str(tmp_path / "journal"),
            )
            tier.submit(JobSpec(tenant="a"))
            with pytest.raises(QuotaExceededError):
                tier.submit(JobSpec(tenant="a", num_pc=3))
            tier.submit(JobSpec(tenant="b", num_pc=3))  # queue now full
            with pytest.raises(QueueFullError):
                tier.submit(JobSpec(tenant="c", num_pc=4))
            tier.step(timeout=1.0)
            tier.step(timeout=1.0)
            tier.submit(JobSpec(tenant="c"))  # cache hit
            tier.close()
            # Restart replays the journal under the same session: the
            # job.replay span lands on the same timeline.
            tier2 = AnalysisJobTier(
                AnalysisEngine(src),
                base,
                workers=0,
                journal_dir=str(tmp_path / "journal"),
            )
            tier2.close()
        assert validate.validate_trace(trace) == []
        assert validate.validate_metrics(metrics) == []
        events = json.loads(open(trace).read())["traceEvents"]
        names = {e["name"] for e in events}
        assert {"job.run", "job.replay", "job_transition", "job_shed"} <= names
        # Queue depth rides the timeline as a counter track too.
        assert any(
            e["ph"] == "C" and e["name"] == "serving_queue_depth"
            for e in events
        )
        prom = open(metrics).read()
        assert 'serving_jobs_total{outcome="done"}' in prom
        assert 'serving_jobs_total{outcome="cached"}' in prom
        assert 'serving_shed_total{reason="queue_full"}' in prom
        assert 'serving_shed_total{reason="quota"}' in prom
        assert "serving_queue_depth" in prom


def _post(conn, path, doc):
    conn.request(
        "POST",
        path,
        body=json.dumps(doc),
        headers={"Content-Type": "application/json"},
    )
    resp = conn.getresponse()
    return resp.status, dict(resp.getheaders()), json.loads(resp.read())


def _get(conn, path):
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read()
    return resp.status, (json.loads(body) if body.startswith(b"{") else None)


class TestLockDiscipline:
    """PR-7 regression pins: the *_locked runtime backstop and the
    locked HTTP snapshot serialization (the unlocked job-state read
    race GL009's audit surfaced)."""

    def test_lock_check_asserts_unguarded_locked_call(self):
        q = AdmissionQueue(4, 2)
        with pytest.raises(AssertionError, match="_locked convention"):
            q._push_locked(object(), "t", 0, 1)
        assert q.depth() == 0  # the assert fired before any mutation
        with q._cv:
            q._push_locked(object(), "t", 0, 2)
        assert q.depth() == 1 and q.in_flight("t") == 1

    def test_lock_check_off_is_a_no_op(self):
        prev = set_lock_check(False)
        try:
            q = AdmissionQueue(4, 2)
            with q._cv:
                q._push_locked(object(), "t", 0, 1)
            # Unguarded *_locked call tolerated when the check is off
            # (production default: zero overhead, GL007 still gates
            # statically). _release_tenant_locked has no native guard
            # of its own, unlike _push_locked's cv.notify().
            q._release_tenant_locked("t")
            assert q.in_flight("t") == 0
        finally:
            set_lock_check(prev)

    def test_record_methods_serialize_under_the_tier_lock(
        self, served_source, monkeypatch
    ):
        """Job objects are mutated by workers under the tier lock;
        every HTTP-facing serialization path must hold it. Asserted at
        the exact read: to_record runs with tier._lock owned."""
        from spark_examples_tpu_torch.serving.jobs import Job

        src, base, _ = served_source
        tier = AnalysisJobTier(AnalysisEngine(src), base, workers=0)
        job, created = tier.submit(JobSpec(tenant="lab"))
        assert created
        owned = []
        orig = Job.to_record

        def spying(self, include_result=True):
            owned.append(tier._lock._is_owned())
            return orig(self, include_result=include_result)

        monkeypatch.setattr(Job, "to_record", spying)
        assert tier.record_of(job)["state"] == "queued"
        assert tier.job_record(job.id)["id"] == job.id
        assert tier.job_record("nope") is None
        assert [r["id"] for r in tier.job_records()] == [job.id]
        assert owned and all(owned), (
            "a to_record ran without the tier lock held"
        )

    def test_replay_holds_the_tier_lock(
        self, served_source, tmp_path, monkeypatch
    ):
        """The GL007 finding this PR fixed: _replay mutates the job
        table and calls _prune_terminal_locked — under the tier lock,
        uniformly, even from __init__."""
        src, base, _ = served_source
        tier = AnalysisJobTier(
            AnalysisEngine(src),
            base,
            workers=0,
            journal_dir=str(tmp_path),
        )
        tier.submit(JobSpec(tenant="lab"))
        tier.close()

        seen = []
        orig = AnalysisJobTier._prune_terminal_locked

        def spying(self):
            seen.append(self._lock._is_owned())
            return orig(self)

        monkeypatch.setattr(
            AnalysisJobTier, "_prune_terminal_locked", spying
        )
        resumed = AnalysisJobTier(
            AnalysisEngine(src),
            base,
            workers=0,
            journal_dir=str(tmp_path),
        )
        assert len(resumed.jobs()) == 1  # the replayed submission
        assert seen and all(seen), (
            "_replay ran _prune_terminal_locked without the tier lock"
        )
        resumed.close()


class TestAnalyzeHttp:
    def test_submit_poll_result_parity(self, served_source):
        src, base, baseline = served_source
        tier = AnalysisJobTier(AnalysisEngine(src), base, workers=1).start()
        server = GenomicsServiceServer(src, job_tier=tier).start()
        try:
            conn = http.client.HTTPConnection(
                "127.0.0.1", server.port, timeout=60
            )
            st, _, doc = _post(conn, "/analyze", {"tenant": "lab"})
            assert st == 202 and doc["state"] == "queued"
            deadline = time.time() + 120
            while time.time() < deadline:
                st, jd = _get(conn, f"/jobs/{doc['id']}")
                if jd["state"] in ("done", "failed"):
                    break
                time.sleep(0.05)
            assert jd["state"] == "done"
            # JSON float round-trip is exact (repr): the HTTP result is
            # bit-identical to the batch driver's rows.
            got = [tuple(r) for r in jd["result"]]
            np.testing.assert_array_equal(
                np.array([[r[1], r[2]] for r in got]),
                np.array([[r[1], r[2]] for r in baseline]),
            )
            assert [r[0] for r in got] == [r[0] for r in baseline]
            # Identical resubmission: served without new work (200).
            st, _, doc2 = _post(conn, "/analyze", {"tenant": "other"})
            assert st == 200 and doc2["state"] == "done"
            st, lst = _get(conn, "/jobs")
            assert len(lst["jobs"]) == 1
        finally:
            server.stop()
            tier.close()

    def test_queue_full_and_quota_shed_429_retry_after(
        self, served_source
    ):
        src, base, _ = served_source
        tier = AnalysisJobTier(
            AnalysisEngine(src),
            base,
            workers=0,  # nothing drains: shedding is deterministic
            queue_depth=2,
            tenant_quota=1,
        )
        server = GenomicsServiceServer(src, job_tier=tier).start()
        try:
            conn = http.client.HTTPConnection(
                "127.0.0.1", server.port, timeout=30
            )
            st, _, _ = _post(conn, "/analyze", {"tenant": "t1"})
            assert st == 202
            # Tenant quota (the queue still has room for other tenants).
            st, hdr, doc = _post(
                conn, "/analyze", {"tenant": "t1", "num_pc": 3}
            )
            assert st == 429 and doc["reason"] == "quota"
            assert int(hdr["Retry-After"]) >= 1
            st, _, _ = _post(conn, "/analyze", {"tenant": "t2", "num_pc": 4})
            assert st == 202
            # Queue capacity: full now, sheds regardless of tenant.
            st, hdr, doc = _post(
                conn, "/analyze", {"tenant": "t3", "num_pc": 5}
            )
            assert st == 429 and doc["reason"] == "queue_full"
            assert int(hdr["Retry-After"]) >= 1
        finally:
            server.stop()
            tier.close()

    def test_oversized_body_is_refused_before_buffering(
        self, served_source
    ):
        """An unauthenticated client must not be able to buy server
        memory with a huge Content-Length: the cap refuses with 413
        before any body bytes are buffered."""
        import socket

        src, base, _ = served_source
        tier = AnalysisJobTier(AnalysisEngine(src), base, workers=0)
        server = GenomicsServiceServer(
            src, token="sekrit", job_tier=tier
        ).start()
        try:
            s = socket.create_connection(
                ("127.0.0.1", server.port), timeout=10
            )
            s.sendall(
                b"POST /analyze HTTP/1.1\r\nHost: x\r\n"
                b"Content-Length: 8000000000\r\n\r\n"
            )
            status = s.recv(4096).decode().splitlines()[0]
            assert " 413 " in status
            s.close()
            # A body of UNKNOWN length is refused too: chunked framing
            # read as "no body" would silently run the default analysis
            # instead of the client's spec.
            s = socket.create_connection(
                ("127.0.0.1", server.port), timeout=10
            )
            s.sendall(
                b"POST /analyze HTTP/1.1\r\nHost: x\r\n"
                b"Transfer-Encoding: chunked\r\n\r\n"
                b"2\r\n{}\r\n0\r\n\r\n"
            )
            status = s.recv(4096).decode().splitlines()[0]
            assert " 501 " in status
            s.close()
            s = socket.create_connection(
                ("127.0.0.1", server.port), timeout=10
            )
            s.sendall(b"POST /analyze HTTP/1.1\r\nHost: x\r\n\r\n")
            status = s.recv(4096).decode().splitlines()[0]
            assert " 411 " in status
            s.close()
        finally:
            server.stop()
            tier.close()

    def test_bad_spec_400_unknown_job_404_no_tier_404(self, served_source):
        src, base, _ = served_source
        tier = AnalysisJobTier(AnalysisEngine(src), base, workers=0)
        server = GenomicsServiceServer(src, job_tier=tier).start()
        bare = GenomicsServiceServer(src).start()  # no tier
        try:
            conn = http.client.HTTPConnection(
                "127.0.0.1", server.port, timeout=30
            )
            st, _, doc = _post(conn, "/analyze", {"bogus": True})
            assert st == 400 and "unknown spec field" in doc["error"]
            st, _ = _get(conn, "/jobs/never-submitted")
            assert st == 404
            conn2 = http.client.HTTPConnection(
                "127.0.0.1", bare.port, timeout=30
            )
            conn2.request("POST", "/analyze", body=b"{}")
            assert conn2.getresponse().status == 404
        finally:
            bare.stop()
            server.stop()
            tier.close()

    def test_token_auth_guards_the_job_surface(self, served_source):
        src, base, _ = served_source
        tier = AnalysisJobTier(AnalysisEngine(src), base, workers=0)
        server = GenomicsServiceServer(
            src, token="sekrit", job_tier=tier
        ).start()
        try:
            conn = http.client.HTTPConnection(
                "127.0.0.1", server.port, timeout=30
            )
            conn.request("POST", "/analyze", body=b"{}")
            resp = conn.getresponse()
            resp.read()  # drain: the keep-alive socket stays reusable
            assert resp.status == 401
            conn.request(
                "POST",
                "/analyze",
                body=b"{}",
                headers={"Authorization": "Bearer sekrit"},
            )
            resp = conn.getresponse()
            resp.read()
            assert resp.status == 202
        finally:
            server.stop()
            tier.close()


def _sample_ids(n):
    return [f"{DEFAULT_VARIANT_SET_ID}-{i}" for i in range(n)]


class TestDeltaServing:
    """The incremental tier end to end: nearest-ancestor resolution,
    bit-identity vs cold, outcome accounting, fallback guard."""

    def _tiers(self, src, base, tmp_path, **kw):
        return AnalysisJobTier(
            AnalysisEngine(src, delta_max_samples=16),
            base,
            workers=0,
            journal_dir=str(tmp_path / "j"),
            **kw,
        )

    def test_delta_rows_bit_identical_to_cold(
        self, served_source, tmp_path
    ):
        src, base, _ = served_source
        ids = _sample_ids(8)
        tier = self._tiers(src, base, tmp_path)
        tier.submit(JobSpec())  # warms the delta cache (miss → cold)
        assert tier.step(timeout=1.0)
        job = tier.submit(JobSpec(exclude_samples=(ids[1], ids[5])))[0]
        assert tier.step(timeout=1.0)
        assert job.state == "done", job.error
        cold = AnalysisEngine(src).run(
            job_config(
                JobSpec(exclude_samples=(ids[1], ids[5])), base
            )
        )
        assert job.result == cold
        tier.close()

    def test_num_pc_tweak_is_a_zero_delta_hit(
        self, served_source, tmp_path
    ):
        src, base, _ = served_source
        tier = self._tiers(src, base, tmp_path)
        engine = tier._engine
        tier.submit(JobSpec(num_pc=2))
        assert tier.step(timeout=1.0)
        # Same frame, different finish: the gramian must come straight
        # from the cache (zero-sample delta), and the rows must match
        # a cold engine exactly.
        job = tier.submit(JobSpec(num_pc=3))[0]
        assert engine.delta_resolvable(
            job_config(JobSpec(num_pc=3), base)
        )
        assert tier.step(timeout=1.0)
        assert job.state == "done", job.error
        assert job.result == AnalysisEngine(src).run(
            job_config(JobSpec(num_pc=3), base)
        )
        tier.close()

    def test_af_tweak_misses_the_delta_index(
        self, served_source, tmp_path
    ):
        src, base, _ = served_source
        tier = self._tiers(src, base, tmp_path)
        tier.submit(JobSpec())
        assert tier.step(timeout=1.0)
        # A filter tweak changes the base key — no ancestor, cold run,
        # still correct.
        spec = JobSpec(min_allele_frequency=0.3)
        assert not tier._engine.delta_resolvable(
            job_config(spec, base)
        )
        job = tier.submit(spec)[0]
        assert tier.step(timeout=1.0)
        assert job.state == "done", job.error
        assert job.result == AnalysisEngine(src).run(
            job_config(spec, base)
        )
        tier.close()

    def test_delta_telemetry_and_outcome_counters(
        self, served_source, tmp_path
    ):
        src, base, _ = served_source
        ids = _sample_ids(8)
        trace = str(tmp_path / "delta.trace.json")
        metrics = str(tmp_path / "delta.prom")
        with TelemetrySession(trace_out=trace, metrics_out=metrics):
            tier = self._tiers(src, base, tmp_path)
            tier.submit(JobSpec())  # miss
            tier.step(timeout=1.0)
            tier.submit(JobSpec(exclude_samples=(ids[3],)))  # hit
            tier.step(timeout=1.0)
            # Corrupt the cached entries: guard → fallback.
            from spark_examples_tpu_torch.serving import gramian_base_key

            key = gramian_base_key(job_config(JobSpec(), base))
            for frame in (tuple(ids), tuple(
                i for i in ids if i != ids[3]
            )):
                entry = tier._engine._deltas.resolve(key, frame)
                if entry is not None:
                    entry.g[0, 0] += 1.0
            tier.submit(JobSpec(exclude_samples=(ids[2],)))  # fallback
            tier.step(timeout=1.0)
            tier.close()
        assert validate.validate_trace(trace) == []
        assert validate.validate_metrics(metrics) == []
        events = json.loads(open(trace).read())["traceEvents"]
        deltas = [e for e in events if e.get("name") == "job.delta"]
        assert deltas and deltas[0]["args"]["removed"] == 1
        prom = open(metrics).read()
        assert 'serving_delta_jobs_total{outcome="miss"} 1' in prom
        assert 'serving_delta_jobs_total{outcome="hit"} 1' in prom
        assert 'serving_delta_jobs_total{outcome="fallback"} 1' in prom


class TestGangServing:
    """Gang batching end to end: coalescing policy, bit-identity vs
    serial, journal/crash semantics, telemetry."""

    def _tier(self, src, base, tmp_path, name, **kw):
        kw.setdefault("gang_max_samples", 64)
        kw.setdefault("workers", 0)
        return AnalysisJobTier(
            AnalysisEngine(src),
            base,
            journal_dir=str(tmp_path / name),
            **kw,
        )

    def _specs(self):
        ids = _sample_ids(8)
        return [
            JobSpec(samples=tuple(ids[:5])),
            JobSpec(samples=tuple(ids[2:8])),
            JobSpec(exclude_samples=(ids[0],)),
            JobSpec(min_allele_frequency=0.2),  # different base key
        ]

    def test_gang_results_bit_identical_to_serial(
        self, served_source, tmp_path
    ):
        src, base, _ = served_source
        specs = self._specs()
        gang_tier = self._tier(src, base, tmp_path, "gang")
        gang_jobs = [gang_tier.submit(s)[0] for s in specs]
        steps = 0
        while gang_tier.step(timeout=0.2):
            steps += 1
        # One gang (the three same-base-key cohorts) + one solo.
        assert steps == 2
        serial_tier = self._tier(
            src, base, tmp_path, "serial", gang_max_samples=0
        )
        serial_jobs = [serial_tier.submit(s)[0] for s in specs]
        while serial_tier.step(timeout=0.2):
            pass
        for g, s in zip(gang_jobs, serial_jobs):
            assert g.state == "done", g.error
            assert g.result == s.result
        gang_tier.close()
        serial_tier.close()

    def test_gang_cap_splits_oversized_cohorts_out(
        self, served_source, tmp_path
    ):
        src, base, _ = served_source
        ids = _sample_ids(8)
        tier = self._tier(
            src, base, tmp_path, "cap", gang_max_samples=4
        )
        jobs = [
            tier.submit(JobSpec(samples=tuple(ids[:3])))[0],
            tier.submit(JobSpec(samples=tuple(ids[3:6])))[0],
            tier.submit(JobSpec())[0],  # N=8 > cap: solo
        ]
        steps = 0
        while tier.step(timeout=0.2):
            steps += 1
        assert steps == 2
        assert all(j.state == "done" for j in jobs)
        tier.close()

    def test_gang_telemetry(self, served_source, tmp_path):
        src, base, _ = served_source
        trace = str(tmp_path / "gang.trace.json")
        metrics = str(tmp_path / "gang.prom")
        with TelemetrySession(trace_out=trace, metrics_out=metrics):
            tier = self._tier(src, base, tmp_path, "tele")
            for s in self._specs()[:3]:
                tier.submit(s)
            while tier.step(timeout=0.2):
                pass
            tier.close()
        assert validate.validate_trace(trace) == []
        assert validate.validate_metrics(metrics) == []
        events = json.loads(open(trace).read())["traceEvents"]
        gangs = [e for e in events if e.get("name") == "job.gang"]
        assert gangs and gangs[0]["args"]["size"] == 3
        prom = open(metrics).read()
        assert "serving_gang_size_bucket" in prom
        assert "serving_gang_size_count 1" in prom

    def test_kill_mid_gang_restart_replays_bit_identical(
        self, served_source, tmp_path
    ):
        """The chaos contract: a simulated process death between the
        gang members' journaled starts and execution re-queues every
        member on restart, and re-execution (whatever gang shape it
        lands in) is bit-identical to an uninterrupted serial run."""
        from spark_examples_tpu_torch.serving import SimulatedCrash

        src, base, _ = served_source
        specs = self._specs()[:3]
        baseline_tier = self._tier(src, base, tmp_path, "base")
        baselines = [baseline_tier.submit(s)[0] for s in specs]
        while baseline_tier.step(timeout=0.2):
            pass
        baseline_tier.close()

        journal = str(tmp_path / "crashj")
        tier = AnalysisJobTier(
            AnalysisEngine(src),
            base,
            workers=0,
            gang_max_samples=64,
            journal_dir=journal,
        )
        jobs = [tier.submit(s)[0] for s in specs]
        plan = FaultPlan(
            seed=1,
            rules=[
                FaultRule(
                    site="serving.job.kill",
                    kind="error",
                    match=jobs[1].id,
                )
            ],
        )
        with faults.active_plan(plan):
            with pytest.raises(SimulatedCrash):
                tier.step(timeout=0.2)
        # The "dead" tier: every member journaled a start, none a
        # terminal event; all three are abandoned mid-gang.
        assert all(j.state == "running" for j in jobs)
        tier._journal.close()
        resumed = AnalysisJobTier(
            AnalysisEngine(src),
            base,
            workers=0,
            gang_max_samples=64,
            journal_dir=journal,
        )
        while resumed.step(timeout=0.2):
            pass
        by_key = {j.key: j for j in resumed.jobs()}
        for spec, want in zip(specs, baselines):
            got = by_key.get(cohort_key(spec, base))
            assert got is not None and got.state == "done", got
            assert got.result == want.result
        resumed.close()


class TestDeltaGangSchemaDrift:
    """Both rejection directions for the delta/gang obs surface: the
    new spans are schema-known, an unknown job.* span still fails the
    trace gate, a ``serving_delta_jobs_total`` sample without its
    outcome label fails the metrics gate, and a ``serving_gang_size``
    histogram missing its triplet fails too (GL003 cross-checks the
    same sets statically, both directions)."""

    @staticmethod
    def _trace_with(tmp_path, name):
        trace = tmp_path / "t.json"
        trace.write_text(
            json.dumps(
                {
                    "traceEvents": [
                        {
                            "ph": "X",
                            "name": name,
                            "pid": 1,
                            "ts": 0,
                            "dur": 1,
                        }
                    ]
                }
            )
        )
        return str(trace)

    def test_delta_and_gang_spans_are_schema_known(self, tmp_path):
        for name in ("job.delta", "job.gang"):
            assert (
                validate.validate_trace(self._trace_with(tmp_path, name))
                == []
            )

    def test_unknown_job_span_rejected(self, tmp_path):
        errs = validate.validate_trace(
            self._trace_with(tmp_path, "job.batch")
        )
        assert errs and "job.batch" in errs[0]

    def test_delta_counter_requires_outcome_label(self, tmp_path):
        good = tmp_path / "good.prom"
        good.write_text('serving_delta_jobs_total{outcome="hit"} 2\n')
        assert validate.validate_metrics(str(good)) == []
        bad = tmp_path / "bad.prom"
        bad.write_text("serving_delta_jobs_total 2\n")
        errs = validate.validate_metrics(str(bad))
        assert errs and "outcome" in errs[0]

    def test_gang_histogram_requires_the_triplet(self, tmp_path):
        good = tmp_path / "good.prom"
        good.write_text(
            'serving_gang_size_bucket{le="4"} 1\n'
            'serving_gang_size_bucket{le="+Inf"} 1\n'
            "serving_gang_size_sum 3\n"
            "serving_gang_size_count 1\n"
        )
        assert validate.validate_metrics(str(good)) == []
        bad = tmp_path / "bad.prom"
        bad.write_text('serving_gang_size_bucket{le="+Inf"} 1\n')
        errs = validate.validate_metrics(str(bad))
        assert errs and any("_sum" in e for e in errs)


def _load_promtext():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "validate_promtext",
        os.path.join(_REPO_ROOT, "scripts", "validate_promtext.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _get_raw(conn, path, headers=None):
    conn.request("GET", path, headers=headers or {})
    resp = conn.getresponse()
    return resp.status, dict(resp.getheaders()), resp.read()


class TestIntrospectionPlane:
    """PR 16: the live introspection endpoints — /metrics (Prometheus
    text off the ambient registry), /healthz (bounded liveness probes,
    served pre-auth), /statusz (one JSON operational snapshot), and
    /jobs/<id>?trace=1 (the job-scoped span timeline)."""

    @pytest.fixture()
    def live(self, served_source):
        src, base, _ = served_source
        with TelemetrySession():
            tier = AnalysisJobTier(
                AnalysisEngine(src), base, workers=1
            ).start()
            server = GenomicsServiceServer(src, job_tier=tier).start()
            conn = http.client.HTTPConnection(
                "127.0.0.1", server.port, timeout=30
            )
            try:
                yield src, base, tier, server, conn
            finally:
                conn.close()
                server.stop()
                tier.close()

    def _run_job(self, conn, spec=None):
        st, _, doc = _post(conn, "/analyze", spec or {"num_pc": 2})
        assert st in (200, 202), doc
        jid = doc["id"]
        deadline = time.time() + 120
        while time.time() < deadline:
            st, jd = _get(conn, f"/jobs/{jid}")
            if jd["state"] in ("done", "failed"):
                assert jd["state"] == "done", jd
                return jid
            time.sleep(0.05)
        raise TimeoutError(f"job {jid} never finished")

    def test_healthz_is_served_before_auth(self, served_source):
        """Liveness probes come from load balancers holding no tokens:
        /healthz answers unauthenticated on a token-configured server,
        while /metrics and /statusz stay behind the bearer check."""
        src, base, _ = served_source
        tier = AnalysisJobTier(AnalysisEngine(src), base, workers=0)
        server = GenomicsServiceServer(
            src, token="sekrit", job_tier=tier
        ).start()
        conn = http.client.HTTPConnection(
            "127.0.0.1", server.port, timeout=30
        )
        try:
            st, _, body = _get_raw(conn, "/healthz")
            assert st == 200
            doc = json.loads(body)
            assert doc["status"] == "ok" and doc["checks"]["live"]
            for path in ("/metrics", "/statusz"):
                st, _, _b = _get_raw(conn, path)
                assert st == 401, f"{path} served without a token"
            st, _, _b = _get_raw(
                conn,
                "/statusz",
                headers={"Authorization": "Bearer sekrit"},
            )
            assert st == 200
        finally:
            conn.close()
            server.stop()
            tier.close()

    def test_healthz_disambiguates_busy_from_wedged(self, served_source):
        """Device lock held with NO running job = wedged (503); held
        WITH one = busy doing the work it queued for (200). The probe
        itself is bounded — it answers while the lock stays held."""
        src, base, _ = served_source
        tier = AnalysisJobTier(AnalysisEngine(src), base, workers=0)
        server = GenomicsServiceServer(src, job_tier=tier).start()
        conn = http.client.HTTPConnection(
            "127.0.0.1", server.port, timeout=30
        )
        try:
            st, _, body = _get_raw(conn, "/healthz")
            assert st == 200
            assert json.loads(body)["checks"]["device_lock"] == "ok"
            assert tier._engine._device_lock.acquire(timeout=5)
            try:
                st, _, body = _get_raw(conn, "/healthz")
                doc = json.loads(body)
                assert st == 503 and doc["status"] == "unhealthy"
                assert doc["checks"]["device_lock"] == "wedged"
                job, _ = tier.submit(JobSpec(tenant="probe"))
                with tier._lock:
                    job.state = "running"
                st, _, body = _get_raw(conn, "/healthz")
                doc = json.loads(body)
                assert st == 200
                assert doc["checks"]["device_lock"] == "busy"
                with tier._lock:
                    job.state = "failed"
                    job.error = "test teardown"
            finally:
                tier._engine._device_lock.release()
            st, _, _body = _get_raw(conn, "/healthz")
            assert st == 200
        finally:
            conn.close()
            server.stop()
            tier.close()

    def test_metrics_scrape_is_schema_valid(self, live):
        """One real job, then a scrape: Prometheus content type, the
        shared exposition schema (validate_promtext ↔ validate_trace
        name-sets), and the PR-16 queue series present."""
        _src, _base, _tier, _server, conn = live
        self._run_job(conn)
        st, headers, body = _get_raw(conn, "/metrics")
        assert st == 200
        assert headers["Content-Type"].startswith(
            "text/plain; version=0.0.4"
        )
        text = body.decode()
        promtext = _load_promtext()
        assert promtext.validate_prom_text(text, "scrape") == []
        names = {
            ln.split("{")[0].split(" ")[0]
            for ln in text.splitlines()
            if ln and not ln.startswith("#")
        }
        assert "serving_inflight_jobs" in names
        assert "serving_queue_depth" in names
        assert "serving_queue_age_seconds_count" in names
        assert 'kind="pca"' in text  # queue-age series carry the kind

    def test_statusz_snapshot_shape(self, live):
        _src, _base, tier, _server, conn = live
        self._run_job(conn)
        st, _, body = _get_raw(conn, "/statusz")
        assert st == 200
        doc = json.loads(body)
        server_block = doc["server"]
        assert server_block["uptime_seconds"] >= 0
        assert server_block["pid"] == os.getpid()
        assert "git" in doc["build"] and "version" in doc["build"]
        t = doc["tier"]
        assert t["jobs_by_state"].get("done", 0) >= 1
        assert t["resident_job_kinds"].get("pca", 0) >= 1
        assert t["queue_depth"] == 0
        assert t["in_flight_by_tenant"] == {}
        assert t["breakers"] == {"analyze": "closed"}
        assert t["workers"] == 1
        # XLA's records have no counterpart in the port.
        assert "jit_retraces" not in doc and "compile_cache" not in doc
        # Engine was armed without a delta tier in this fixture.
        assert t["delta_cache"] is None

    def test_statusz_reports_delta_cache_occupancy(
        self, served_source, tmp_path
    ):
        src, base, _ = served_source
        tier = AnalysisJobTier(
            AnalysisEngine(src, delta_max_samples=4),
            base,
            workers=0,
        )
        doc = tier.status()
        assert doc["delta_cache"] is not None
        assert doc["delta_cache"]["entries"] == 0
        assert doc["delta_cache"]["max_bytes"] > 0
        tier.close()

    def test_job_trace_endpoint_returns_span_timeline(self, live):
        _src, _base, tier, _server, conn = live
        jid = self._run_job(conn)
        st, jd = _get(conn, f"/jobs/{jid}")
        assert st == 200 and "trace" not in jd  # opt-in only
        st, jd = _get(conn, f"/jobs/{jid}?trace=1")
        assert st == 200
        trace = jd["trace"]
        assert trace, "trace=1 returned an empty timeline"
        tids = {ev["args"]["trace_id"] for ev in trace}
        assert len(tids) == 1  # one job, one trace id
        names = [ev["name"] for ev in trace]
        assert "job.run" in names
        # job_transition (admission instant) precedes the run span.
        assert names.index("job_transition") < names.index("job.run")
        tss = [float(ev["ts"]) for ev in trace]
        assert tss == sorted(tss)
        st, jd = _get(conn, "/jobs/nope?trace=1")
        assert st == 404

    def test_trace_ids_minted_per_job_and_shared_on_dedup(
        self, served_source
    ):
        """Distinct submissions get distinct admission-minted ids; a
        single-flight dedup view shares the active job's id (it IS that
        execution); the id never perturbs the cohort key."""
        src, base, _ = served_source
        with TelemetrySession():
            tier = AnalysisJobTier(
                AnalysisEngine(src), base, workers=0
            )
            a, created_a = tier.submit(JobSpec(tenant="t", num_pc=2))
            b, created_b = tier.submit(JobSpec(tenant="t", num_pc=3))
            assert created_a and created_b
            assert a.trace_id and b.trace_id
            assert a.trace_id != b.trace_id
            dup, created_dup = tier.submit(
                JobSpec(tenant="t", num_pc=2)
            )
            assert not created_dup
            assert dup.trace_id == a.trace_id
            spec_x = JobSpec(tenant="t", num_pc=2)
            assert cohort_key(spec_x, base) == a.key
            assert "trace_id" not in spec_x.to_record()
            tier.close()


class TestTraceReplayChaosPin:
    """PR 16 extension of the kill -9 chaos contract: the journal
    carries the admission-minted trace id, so a replayed job re-emits
    ITS span timeline — same span names, same order (durations and
    compile-cache artifacts may differ; ``xla_compile:*`` spans are
    cache-state, not job semantics, and are excluded)."""

    @staticmethod
    def _span_sequence(events):
        return [
            ev["name"]
            for ev in events
            if not ev["name"].startswith("xla_compile:")
        ]

    def test_replayed_job_reemits_same_span_sequence(
        self, served_source, tmp_path
    ):
        from spark_examples_tpu_torch.serving import SimulatedCrash

        src, base, _ = served_source
        spec = JobSpec(tenant="chaos", num_pc=3)
        # Baseline: uninterrupted execution, its trace captured. A
        # prior warm-up run (different cohort key) pre-compiles the
        # kernels so the baseline itself is compile-cache-warm.
        with TelemetrySession():
            warm = AnalysisJobTier(
                AnalysisEngine(src), base, workers=0
            )
            warm.submit(JobSpec(tenant="chaos", num_pc=2))
            while warm.step(timeout=0.2):
                pass
            warm.close()
        with TelemetrySession():
            baseline_tier = AnalysisJobTier(
                AnalysisEngine(src), base, workers=0
            )
            bjob, _ = baseline_tier.submit(spec)
            while baseline_tier.step(timeout=0.2):
                pass
            assert bjob.state == "done"
            baseline_seq = self._span_sequence(
                baseline_tier.job_trace(bjob.id)
            )
            baseline_tier.close()
        assert "job.run" in baseline_seq

        # Crash phase: start journaled, kill between the journaled
        # start and execution (the SIGKILL seam).
        journal = str(tmp_path / "tracej")
        with TelemetrySession():
            tier = AnalysisJobTier(
                AnalysisEngine(src),
                base,
                workers=0,
                journal_dir=journal,
            )
            job, _ = tier.submit(spec)
            minted = job.trace_id
            assert minted
            plan = FaultPlan(
                seed=1,
                rules=[
                    FaultRule(
                        site="serving.job.kill",
                        kind="error",
                        match=job.id,
                    )
                ],
            )
            with faults.active_plan(plan):
                with pytest.raises(SimulatedCrash):
                    tier.step(timeout=0.2)
            tier._journal.close()

        # Restart: fresh tracer (the real process died), replay
        # restores the SAME trace id from the journal, and the resumed
        # execution re-emits the baseline's span sequence under it.
        with TelemetrySession():
            resumed = AnalysisJobTier(
                AnalysisEngine(src),
                base,
                workers=0,
                journal_dir=journal,
            )
            replayed = {j.key: j for j in resumed.jobs()}[
                cohort_key(spec, base)
            ]
            assert replayed.trace_id == minted
            while resumed.step(timeout=0.2):
                pass
            assert replayed.state == "done"
            replay_seq = self._span_sequence(
                resumed.job_trace(replayed.id)
            )
            resumed.close()
        assert replay_seq == baseline_seq


# -- the port against the JAX package -----------------------------------------


COORD_TOL = 1e-4


def _rows_close(got, want, tol=COORD_TOL):
    """Rows name for name, coordinates within ``tol``."""
    assert [r[0] for r in got] == [r[0] for r in want]
    assert [r[3] for r in got] == [r[3] for r in want]
    a = np.array([[r[1], r[2]] for r in got])
    b = np.array([[r[1], r[2]] for r in want])
    assert np.abs(a - b).max() <= tol, np.abs(a - b).max()


def _drain(tier):
    while tier.step(timeout=0.0):
        pass


class TestAgainstTheJaxTier:
    @pytest.fixture(scope="class")
    def both(self):
        from spark_examples_tpu.genomics.fixtures import (
            synthetic_cohort as jax_synthetic_cohort,
        )
        from spark_examples_tpu.utils.config import PcaConfig as JaxConfig

        kw = dict(
            variant_set_ids=[DEFAULT_VARIANT_SET_ID],
            references=REFS,
            bases_per_partition=20_000,
            block_variants=16,
            ingest_workers=2,
        )
        n, v = 24, 200
        src = synthetic_cohort(n, v, seed=5, population_structure=3)
        jsrc = jax_synthetic_cohort(n, v, seed=5, population_structure=3)
        return src, PcaConfig(device="cpu", **kw), jsrc, JaxConfig(**kw)

    def _specs(self):
        ids = _sample_ids(24)
        return [
            JobSpec(),
            JobSpec(exclude_samples=tuple(ids[:3])),
            JobSpec(samples=tuple(ids[2:20])),
            JobSpec(num_pc=3, exclude_samples=(ids[7],)),
            JobSpec(min_allele_frequency=0.2),
        ]

    def _jax_tier(self, jsrc, jbase, **kw):
        from spark_examples_tpu.serving import (
            AnalysisEngine as JaxEngine,
            AnalysisJobTier as JaxTier,
        )

        delta = kw.pop("delta_max_samples", 16)
        persist = kw.pop("delta_persist_dir", None)
        return JaxTier(
            JaxEngine(
                jsrc, delta_max_samples=delta, delta_persist_dir=persist
            ),
            jbase,
            workers=0,
            **kw,
        )

    def _port_tier(self, src, base, **kw):
        delta = kw.pop("delta_max_samples", 16)
        persist = kw.pop("delta_persist_dir", None)
        return AnalysisJobTier(
            AnalysisEngine(
                src, delta_max_samples=delta, delta_persist_dir=persist
            ),
            base,
            workers=0,
            **kw,
        )

    def test_cohort_keys_equal_the_jax_keys(self, both):
        from spark_examples_tpu.serving import cohort_key as jax_key
        from spark_examples_tpu.serving import gramian_base_key as jax_base

        from spark_examples_tpu_torch.serving import gramian_base_key

        src, base, jsrc, jbase = both
        for spec in self._specs():
            assert cohort_key(spec, base) == jax_key(spec, jbase)
            assert gramian_base_key(job_config(spec, base)) == jax_base(
                job_config(spec, jbase)
            )

    @pytest.mark.parametrize("gang", [0, 64], ids=["solo", "gang"])
    def test_rows_match_the_jax_tier(self, both, gang):
        src, base, jsrc, jbase = both
        port = self._port_tier(src, base, gang_max_samples=gang)
        ref = self._jax_tier(jsrc, jbase, gang_max_samples=gang)
        specs = self._specs()
        got = [port.submit(s)[0] for s in specs]
        want = [ref.submit(s)[0] for s in specs]
        _drain(port)
        _drain(ref)
        for g, w in zip(got, want):
            assert g.state == "done" and w.state == "done", (g.error, w.error)
            assert g.key == w.key
            _rows_close(g.result, w.result)
        # The port's delta and cold rows agree with a cold port engine
        # bit for bit.
        for spec, g in zip(specs, got):
            assert g.result == AnalysisEngine(src).run(job_config(spec, base))
        port.close()
        ref.close()

    def test_sketch_jobs_route_around_the_delta_index(self, both):
        src, base, _, _ = both
        tier = self._port_tier(src, base, gang_max_samples=64)
        engine = tier._engine
        warm = tier.submit(JobSpec())[0]
        _drain(tier)
        assert warm.state == "done"
        before = engine.delta_stats()
        ids = _sample_ids(24)
        sketch = [
            tier.submit(JobSpec(pca_mode="sketch"))[0],
            tier.submit(
                JobSpec(pca_mode="sketch", exclude_samples=(ids[0],))
            )[0],
        ]
        _drain(tier)
        assert all(j.state == "done" for j in sketch), [
            j.error for j in sketch
        ]
        assert engine.delta_stats() == before
        assert sketch[0].key != warm.key
        tier.close()

    def test_each_package_replays_the_others_journal(self, both, tmp_path):
        src, base, jsrc, jbase = both
        ids = _sample_ids(24)
        for writer, reader in (("jax", "port"), ("port", "jax")):
            journal = str(tmp_path / f"{writer}-journal")
            make = {
                "jax": lambda **kw: self._jax_tier(jsrc, jbase, **kw),
                "port": lambda **kw: self._port_tier(src, base, **kw),
            }
            first = make[writer](journal_dir=journal)
            done = first.submit(JobSpec())[0]
            _drain(first)
            assert done.state == "done"
            queued = first.submit(JobSpec(exclude_samples=(ids[4],)))[0]
            first.close()  # "killed" with one job still queued
            second = make[reader](journal_dir=journal)
            replayed = second.job(done.id)
            assert replayed is not None and replayed.state == "done"
            # Finished rows come back from the journal as written.
            assert [tuple(r) for r in replayed.result] == [
                tuple(r) for r in done.result
            ]
            again, created = second.submit(JobSpec(tenant="other"))
            assert not created and again.cached
            pending = second.job(queued.id)
            assert pending is not None and pending.state == "queued"
            _drain(second)
            assert pending.state == "done", pending.error
            cold = AnalysisEngine(src).run(
                job_config(JobSpec(exclude_samples=(ids[4],)), base)
            )
            _rows_close(pending.result, cold)
            second.close()

    def test_each_package_loads_the_others_delta_directory(
        self, both, tmp_path
    ):
        src, base, jsrc, jbase = both
        ids = _sample_ids(24)
        tweak = job_config(JobSpec(exclude_samples=(ids[5],)), base)
        for writer in ("jax", "port"):
            persist = str(tmp_path / f"{writer}-deltas")
            if writer == "jax":
                tier = self._jax_tier(
                    jsrc, jbase, delta_persist_dir=persist
                )
            else:
                tier = self._port_tier(src, base, delta_persist_dir=persist)
            tier.submit(JobSpec())
            _drain(tier)
            tier.close()
            names = sorted(os.listdir(persist))
            assert names and all(n.endswith(".npz") for n in names)
            if writer == "jax":
                reader = AnalysisEngine(
                    src, delta_max_samples=16, delta_persist_dir=persist
                )
                assert reader.delta_stats()["entries"] == len(names)
                assert reader.delta_resolvable(tweak)
                assert reader.run(tweak) == AnalysisEngine(src).run(tweak)
            else:
                from spark_examples_tpu.serving import (
                    AnalysisEngine as JaxEngine,
                )

                jreader = JaxEngine(
                    jsrc, delta_max_samples=16, delta_persist_dir=persist
                )
                jtweak = job_config(
                    JobSpec(exclude_samples=(ids[5],)), jbase
                )
                assert jreader.delta_stats()["entries"] == len(names)
                assert jreader.delta_resolvable(jtweak)
                _rows_close(
                    jreader.run(jtweak), AnalysisEngine(src).run(tweak)
                )

    def test_delta_g_is_bit_identical_to_the_jax_delta(self, both):
        """The engine's delta Gramians, read back from each package's
        delta index, are the same bytes (and equal from-scratch)."""
        from spark_examples_tpu.serving import (
            AnalysisEngine as JaxEngine,
            gramian_base_key as jax_base,
        )

        from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
        from spark_examples_tpu_torch.serving import gramian_base_key

        src, base, jsrc, jbase = both
        ids = _sample_ids(24)
        port = AnalysisEngine(src, delta_max_samples=16)
        ref = JaxEngine(jsrc, delta_max_samples=16)
        specs = [
            JobSpec(),
            JobSpec(exclude_samples=tuple(ids[:8])),
            JobSpec(exclude_samples=tuple(ids[8:16])),
        ]
        for spec in specs:
            port.run(job_config(spec, base))
            ref.run(job_config(spec, jbase))
        key = gramian_base_key(job_config(specs[0], base))
        jkey = jax_base(job_config(specs[0], jbase))
        for spec in specs:
            conf = job_config(spec, base)
            frame = tuple(
                VariantsPcaDriver(conf, src).cohort.callset_of_index()
            )
            got = port._deltas.resolve(key, frame)
            want = ref._deltas.resolve(jkey, frame)
            assert got.samples == want.samples == frame
            assert got.checksum == want.checksum
            assert np.array_equal(got.g, want.g)
            scratch = VariantsPcaDriver(conf, src).ingest_gramian().numpy()
            assert np.array_equal(got.g, scratch)


class TestPairhmmKind:
    READS_REFS = "11:6888648:6890648"

    def _fixture(self):
        from spark_examples_tpu_torch.genomics.fixtures import (
            synthetic_reads,
        )

        src = synthetic_cohort(12, 120, references=self.READS_REFS, seed=2)
        src.add_reads(
            synthetic_reads(
                50, references=self.READS_REFS, seed=6
            ).reads_records()
        )
        base = PcaConfig(
            variant_set_ids=[DEFAULT_VARIANT_SET_ID],
            references=self.READS_REFS,
            bases_per_partition=1000,
            device="cpu",
        )
        return src, base

    def test_pairhmm_rows_equal_the_driver_and_the_jax_job(self):
        from spark_examples_tpu.genomics.fixtures import (
            FIXTURE_READSET_ID,
            synthetic_cohort as jax_synthetic_cohort,
            synthetic_reads as jax_synthetic_reads,
        )
        from spark_examples_tpu.ops.pairhmm import (
            PAIRHMM_FORWARD_ATOL,
            PAIRHMM_FORWARD_RTOL,
        )
        from spark_examples_tpu.serving import (
            AnalysisEngine as JaxEngine,
            AnalysisJobTier as JaxTier,
        )
        from spark_examples_tpu.utils.config import PcaConfig as JaxConfig

        from spark_examples_tpu_torch.models.pairhmm import PairHmmDriver

        src, base = self._fixture()
        tier = AnalysisJobTier(
            AnalysisEngine(src), base, workers=0, gang_max_samples=64
        )
        spec = JobSpec.from_record(
            {"kind": "pairhmm", "read_group_set_id": FIXTURE_READSET_ID}
        )
        job, created = tier.submit(spec)
        pca_job, _ = tier.submit(JobSpec())
        assert created
        _drain(tier)
        assert job.state == "done", job.error
        assert pca_job.state == "done", pca_job.error
        assert pca_job.key != job.key
        want = PairHmmDriver(job_config(spec, base), src).run_rows()
        assert job.result == [tuple(r) for r in want]
        again, created2 = tier.submit(spec)
        assert not created2 and again.cached and again.result == job.result
        tier.close()

        jsrc = jax_synthetic_cohort(
            12, 120, references=self.READS_REFS, seed=2
        )
        jsrc.add_reads(
            jax_synthetic_reads(
                50, references=self.READS_REFS, seed=6
            ).reads_records()
        )
        jbase = JaxConfig(
            variant_set_ids=[DEFAULT_VARIANT_SET_ID],
            references=self.READS_REFS,
            bases_per_partition=1000,
        )
        jtier = JaxTier(JaxEngine(jsrc), jbase, workers=0)
        jjob, _ = jtier.submit(spec)
        _drain(jtier)
        assert jjob.state == "done", jjob.error
        assert jjob.key == job.key
        assert [(r[0], r[2]) for r in jjob.result] == [
            (r[0], r[2]) for r in job.result
        ]
        np.testing.assert_allclose(
            [r[1] for r in job.result],
            [r[1] for r in jjob.result],
            rtol=PAIRHMM_FORWARD_RTOL,
            atol=PAIRHMM_FORWARD_ATOL,
        )
        jtier.close()


class TestPortEngine:
    @pytest.mark.skipif(
        torch.cuda.is_available(), reason="this host has a CUDA card"
    )
    def test_the_default_device_raises_without_a_card(self, served_source):
        src, _, _ = served_source
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _PortEngine(src)

    def test_gang_dispatch_counts_and_rows(self, served_source, tmp_path):
        src, base, _ = served_source
        ids = _sample_ids(8)
        metrics = str(tmp_path / "gang.prom")
        specs = [
            JobSpec(samples=tuple(ids[:4])),
            JobSpec(samples=tuple(ids[2:7])),
            JobSpec(samples=tuple(ids[3:])),
            JobSpec(exclude_samples=(ids[1],)),
        ]
        with TelemetrySession(metrics_out=metrics):
            tier = AnalysisJobTier(
                AnalysisEngine(src), base, workers=0, gang_max_samples=64
            )
            jobs = [tier.submit(s)[0] for s in specs]
            assert tier.step(timeout=0.0)  # one dispatch for all four
            assert not tier.step(timeout=0.0)
            tier.close()
        prom = open(metrics).read()
        assert "serving_gang_size_count 1" in prom
        assert "serving_gang_size_sum 4" in prom
        for spec, job in zip(specs, jobs):
            assert job.state == "done", job.error
            assert job.result == AnalysisEngine(src).run(
                job_config(spec, base)
            )


class TestServeCohortCli:
    def test_analyze_flags_keep_the_jax_names_and_defaults(self):
        import argparse

        from spark_examples_tpu.utils.config import (
            add_analyze_flags as jax_flags,
        )

        from spark_examples_tpu_torch.utils.config import add_analyze_flags

        port, ref = argparse.ArgumentParser(), argparse.ArgumentParser()
        add_analyze_flags(port)
        jax_flags(ref)
        assert vars(port.parse_args([])) == vars(ref.parse_args([]))
        assert vars(port.parse_args([])) == {
            "analyze": False,
            "analyze_workers": 1,
            "analyze_queue_depth": 64,
            "analyze_tenant_quota": 8,
            "analyze_journal_dir": None,
            "analyze_cache_size": 256,
            "delta_max_samples": 16,
            "store_dir": None,
            "replica_id": None,
            "replica_lease_ttl": 5.0,
            "replica_heartbeat": 1.0,
            "gang_max_samples": 256,
        }

    def _args(self, *extra):
        from spark_examples_tpu_torch.cli.main import build_parser

        return build_parser().parse_args(
            ["serve-cohort", "--analyze", "--device", "cpu",
             "--references", REFS, "--bases-per-partition", "20000",
             "--block-variants", "16", *extra]
        )

    def test_tier_setup_runs_jobs_and_replays(self, served_source, tmp_path):
        from spark_examples_tpu_torch.cli.main import _analysis_tier

        src, base, baseline = served_source
        journal = str(tmp_path / "j")
        tier = _analysis_tier(
            self._args("--analyze-journal-dir", journal), src
        )
        try:
            job = tier.submit(JobSpec())[0]
            deadline = time.time() + 120
            while job.state not in ("done", "failed"):
                assert time.time() < deadline
                time.sleep(0.02)
            assert job.state == "done", job.error
            assert job.result == baseline
        finally:
            tier.close()
        assert os.listdir(os.path.join(journal, "deltas"))
        tier = _analysis_tier(
            self._args("--analyze-journal-dir", journal), src
        )
        try:
            assert tier.job(job.id).result == job.result
        finally:
            tier.close()

    @pytest.mark.parametrize(
        "extra, message",
        [
            (("--analyze-workers", "0"), "--analyze-workers must be >= 1"),
            (("--delta-max-samples", "-1"), "--delta-max-samples must be"),
            (("--replica-id", "r1"), "--replica-id requires --store-dir"),
        ],
    )
    def test_bad_flags_are_refused(self, served_source, extra, message):
        from spark_examples_tpu_torch.cli.main import _analysis_tier

        src, _, _ = served_source
        with pytest.raises(SystemExit, match=message):
            _analysis_tier(self._args(*extra), src)

    def test_mesh_shape_still_raises(self, served_source):
        """``--mesh-shape`` is served: the tier's engine runs each job on
        the mesh (rows within 1e-4 of the meshless baseline, no delta
        tier). What still raises is the sketch under a mesh (item 7's pod
        slice): such a job fails naming it."""
        from spark_examples_tpu_torch.cli.main import _analysis_tier

        src, _, baseline = served_source
        tier = _analysis_tier(
            self._args("--mesh-shape", "data:2,model:2"), src
        )
        try:
            assert tier._engine.mesh.shape == {"data": 2, "model": 2}
            assert tier._engine.delta_stats() is None
            jobs = [tier.submit(JobSpec())[0],
                    tier.submit(JobSpec(pca_mode="sketch"))[0]]
            deadline = time.time() + 120
            while any(j.state not in ("done", "failed") for j in jobs):
                assert time.time() < deadline
                time.sleep(0.02)
        finally:
            tier.close()
        meshed, sketch = jobs
        assert meshed.state == "done", meshed.error
        assert [r[0] for r in meshed.result] == [r[0] for r in baseline]
        np.testing.assert_allclose(
            np.array([r[1:3] for r in meshed.result]),
            np.array([r[1:3] for r in baseline]),
            atol=1e-4,
        )
        assert sketch.state == "failed"
        assert "item 7" in sketch.error


class TestJobCheckpoints:
    """The job tier's mid-ingest resume (the JAX tier's ``_ckpt_dir``):
    with a journal, a full-cohort single-set pca job ingests through the
    checkpointed route into ``<journal>/ckpt/<id>``, reclaimed on any
    terminal outcome and kept across a crash, so a killed job resumes from
    its last shard group."""

    def test_job_config_hands_the_checkpoint_dir_as_the_jax_one(self):
        from spark_examples_tpu.serving import job_config as jax_job_config
        from spark_examples_tpu.utils.config import PcaConfig as JaxConfig

        base = _base_conf(trace_dir="t")
        jbase = JaxConfig(
            variant_set_ids=[DEFAULT_VARIANT_SET_ID], references=REFS,
            bases_per_partition=20_000, block_variants=16, trace_dir="t",
        )
        for spec, want in (
            (JobSpec(), "ck"),
            (JobSpec(pca_mode="sketch"), None),
            (JobSpec(kind="pairhmm"), None),
        ):
            conf = job_config(spec, base, checkpoint_dir="ck")
            ref = jax_job_config(spec, jbase, checkpoint_dir="ck")
            for name in ("checkpoint_dir", "trace_dir",
                         "elastic_checkpoint", "output_path"):
                assert getattr(conf, name) == getattr(ref, name), name
            assert conf.checkpoint_dir == want
            assert conf.trace_dir is None
        assert job_config(JobSpec(), base).checkpoint_dir is None

    def test_ckpt_dir_rules_are_the_jax_tiers(self, served_source, tmp_path):
        from spark_examples_tpu.serving import (
            AnalysisEngine as JaxEngine,
            AnalysisJobTier as JaxTier,
        )
        from spark_examples_tpu.utils.config import PcaConfig as JaxConfig

        src, base, _ = served_source
        jbase = JaxConfig(
            variant_set_ids=[DEFAULT_VARIANT_SET_ID], references=REFS,
            bases_per_partition=20_000, block_variants=16,
        )
        ids = _sample_ids(8)
        specs = [
            JobSpec(),
            JobSpec(exclude_samples=(ids[0],)),
            JobSpec(samples=tuple(ids[:4])),
            JobSpec(variant_set_ids=("a", "b")),
            JobSpec(kind="pairhmm"),
            JobSpec(pca_mode="sketch"),
        ]
        for journal in (None, "j"):
            kw = {} if journal is None else {
                "journal_dir": str(tmp_path / f"{journal}-port")}
            port = AnalysisJobTier(AnalysisEngine(src), base, workers=0,
                                   **kw)
            jkw = {} if journal is None else {
                "journal_dir": str(tmp_path / f"{journal}-jax")}
            ref = JaxTier(JaxEngine(src), jbase, workers=0, **jkw)
            try:
                for spec in specs:
                    job = _queued_job(spec)
                    got, want = port._ckpt_dir(job), ref._ckpt_dir(job)
                    assert (got is None) == (want is None), spec
                    if got is not None:
                        assert got == os.path.join(
                            kw["journal_dir"], "ckpt", job.id)
            finally:
                port.close()
                ref.close()

    def test_done_job_took_the_checkpointed_route_and_reclaimed_it(
            self, served_source, tmp_path, monkeypatch):
        from spark_examples_tpu_torch.serving import gramian_base_key
        from spark_examples_tpu_torch.utils import checkpoint

        src, base, baseline = served_source
        saved = []
        real = checkpoint.save_snapshot

        def recording(directory, g, shards_done, digest):
            saved.append((directory, shards_done))
            real(directory, g, shards_done, digest)

        monkeypatch.setattr(checkpoint, "save_snapshot", recording)
        journal = str(tmp_path / "journal")
        tier = AnalysisJobTier(
            AnalysisEngine(src, delta_max_samples=16), base, workers=0,
            journal_dir=journal,
        )
        try:
            job, _ = tier.submit(JobSpec(tenant="t"))
            tier.step(timeout=1.0)
            assert job.state == "done", job.error
            assert job.result == baseline
            ckpt = os.path.join(journal, "ckpt", job.id)
            assert saved and {d for d, _ in saved} == {ckpt}
            assert saved[-1][1] == 5  # every shard of the manifest
            assert not os.path.exists(ckpt)
            # A checkpointed cold run captures no windows: the first
            # delta re-streams once.
            deltas = tier._engine._deltas
            key = gramian_base_key(job_config(JobSpec(), base))
            assert deltas.windows(key) is None
        finally:
            tier.close()

    def test_sparse_base_under_a_journal_fails_as_the_jax_tier(
            self, served_source, tmp_path):
        """A fact of the reference: the JAX tier hands every full-cohort
        pca job a checkpoint directory, and its driver refuses ``sparse``
        with one — so a ``--pca-mode sparse`` base under a journal fails
        its full-cohort jobs. The port does the same."""
        from spark_examples_tpu.serving import (
            AnalysisEngine as JaxEngine,
            AnalysisJobTier as JaxTier,
        )
        from spark_examples_tpu.utils.config import PcaConfig as JaxConfig

        src, _, _ = served_source
        base = _base_conf(pca_mode="sparse")
        jbase = JaxConfig(
            variant_set_ids=[DEFAULT_VARIANT_SET_ID], references=REFS,
            bases_per_partition=20_000, block_variants=16,
            pca_mode="sparse",
        )
        port = AnalysisJobTier(AnalysisEngine(src), base, workers=0,
                               journal_dir=str(tmp_path / "p"))
        ref = JaxTier(JaxEngine(src), jbase, workers=0,
                      journal_dir=str(tmp_path / "j"))
        try:
            jobs = []
            for tier in (port, ref):
                job, _ = tier.submit(JobSpec())
                tier.step(timeout=1.0)
                restricted, _ = tier.submit(
                    JobSpec(exclude_samples=(_sample_ids(8)[0],)))
                tier.step(timeout=1.0)
                jobs.append((job, restricted))
            (pjob, prest), (jjob, jrest) = jobs
            assert pjob.state == jjob.state == "failed"
            assert pjob.error == jjob.error
            assert "--pca-mode sparse does not compose" in pjob.error
            # A restricted job gets no checkpoint and runs.
            assert prest.state == jrest.state == "done"
        finally:
            port.close()
            ref.close()

    def test_killed_job_resumes_from_its_last_group(self, tmp_path):
        """``serve-cohort --analyze --analyze-journal-dir`` in a
        subprocess, its ingest stalled after the first group's snapshot;
        SIGKILL once ``ckpt/<id>/gramian_snapshot.npz`` appears, restart
        on the journal (no stall): the job resumes from 2/5 shards and its
        rows equal the driver's."""
        import signal
        import subprocess
        import sys

        from spark_examples_tpu_torch.genomics.sources import JsonlSource
        from spark_examples_tpu_torch.models.pca import VariantsPcaDriver

        root = str(tmp_path / "cohort")
        synthetic_cohort(12, 200, seed=7).dump(root)
        journal = str(tmp_path / "journal")
        plan = {"rules": [{"site": "ingest.shard", "kind": "stall",
                           "stall_s": 60, "after": 2, "times": 1}]}

        def serve(*extra):
            proc = subprocess.Popen(
                [sys.executable, "-m", "spark_examples_tpu_torch.cli.main",
                 "serve-cohort", "--input-path", root, "--references",
                 REFS, "--bases-per-partition", "20000",
                 "--block-variants", "16", "--port", "0", "--analyze",
                 "--analyze-journal-dir", journal, "--device", "cpu",
                 "--ingest-workers", "1", "--checkpoint-every", "2",
                 *extra],
                cwd=_REPO_ROOT, stdout=subprocess.PIPE,
                stderr=stderr, text=True,
            )
            seen = []
            deadline = time.time() + 120
            while time.time() < deadline:
                line = proc.stdout.readline()
                assert line, f"server exited: {seen}"
                seen.append(line)
                if "listening on http://" in line:
                    port = int(line.rsplit(":", 1)[1].split()[0])
                    return proc, port, seen
            proc.kill()
            raise TimeoutError(seen)

        stderr = open(tmp_path / "server.err", "w")
        proc, port, _ = serve("--fault-plan", json.dumps(plan))
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            status, _, rec = _post(conn, "/analyze", {"tenant": "t"})
            assert status == 202
            snap = os.path.join(journal, "ckpt", rec["id"],
                                "gramian_snapshot.npz")
            deadline = time.time() + 120
            while not os.path.exists(snap):
                assert time.time() < deadline, "no snapshot appeared"
                time.sleep(0.02)
        finally:
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=30)
            proc.stdout.close()
        proc, port, seen = serve()
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            deadline = time.time() + 120
            while True:
                try:
                    status, job = _get(conn, f"/jobs/{rec['id']}")
                except OSError as e:
                    stderr.flush()
                    raise AssertionError(
                        f"the restarted server is gone ({e}; exit "
                        f"{proc.poll()}): {seen} "
                        f"{(tmp_path / 'server.err').read_text()[-3000:]}"
                    ) from e
                assert status == 200 and job["state"] != "failed", job
                if job["state"] == "done":
                    break
                assert time.time() < deadline, job
                time.sleep(0.05)
            proc.send_signal(signal.SIGINT)
            out, _ = proc.communicate(timeout=30)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        stderr.close()
        assert "Resuming from snapshot: 2/5 shards done." in (
            "".join(seen) + out)
        assert not os.path.exists(os.path.dirname(snap))
        conf = job_config(JobSpec(tenant="t"), _base_conf(
            ingest_workers=1, checkpoint_every=2))
        driver = VariantsPcaDriver(conf, JsonlSource(root))
        want = driver.collect_result(
            driver.compute_pca(driver.ingest_gramian()))
        assert [tuple(r) for r in job["result"]] == want


def _queued_job(spec):
    """A queued job of ``spec`` (the tier's probes read only its spec and
    id)."""
    from spark_examples_tpu_torch.serving.jobs import Job

    return Job(id="job-0001", spec=spec, key="k", seq=1)
