"""The port's replicated /analyze serving over a shared durable store.

The cases of ``tests/test_replica.py`` run against the port on the CPU,
with the ``*_locked`` asserts on:

- ``LocalDirStore``: atomic checksummed blobs (a torn write can only
  ever exist under a ``*.tmp-*`` name), CAS leases whose fencing token
  is bumped by EVERY successful acquire — so the previous holder is a
  zombie the instant a takeover returns — and the ``store.read`` /
  ``store.write`` / ``store.lease`` fault seams.
- ``LeaseManager``: acquire → heartbeat-renew → released lifecycle,
  the degraded↔recovered weather transitions, duplicate-live-id
  rejection, and the pause→expire→takeover→zombie state machine.
- ``AnalysisJobTier`` failover: kill one replica mid-job, the survivor
  adopts its journal and re-executes to BIT-IDENTICAL coordinates; the
  woken zombie's writes are rejected loudly (never torn-merged).
- Cross-replica Gramian sharing: a peer's persisted delta entry is
  picked up by rescan-on-miss; a zombie's persist is fenced.
- The observability contract: ``job.adopt`` spans and the lease/
  degraded metric series are schema-known, live endpoints surface
  replica identity, and a zombie fails /healthz.

``TestAgainstTheJaxStore`` holds the port to the JAX package: either
package reads the blobs and leases the other wrote, and a zombie of one
package is fenced by a takeover from the other.
"""

import http.client
import json
import os
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
from spark_examples_tpu_torch.resilience import FaultPlan, FaultRule, faults
from spark_examples_tpu_torch.serving import (
    AnalysisEngine as _PortEngine,
    AnalysisJobTier,
    DeltaIndex,
    JobSpec,
    LeaseManager,
    SimulatedCrash,
)
from spark_examples_tpu_torch.serving.replica import (
    ADOPTED_PREFIX,
    JOB_INDEX_PREFIX,
)
from spark_examples_tpu_torch.store import (
    FencedWriteError,
    LocalDirStore,
    StoreCorruptError,
    StoreError,
)
from spark_examples_tpu_torch.utils.config import PcaConfig
from spark_examples_tpu_torch.utils.lockcheck import set_lock_check

def AnalysisEngine(source, **kw):
    """The port's engine on the CPU (its default device is the card)."""
    kw.setdefault("device", "cpu")
    return _PortEngine(source, **kw)


_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _lock_check_enabled():
    """The *_locked runtime backstop is ON for this whole suite (the
    replica plane adds LeaseManager._set_state_locked to the graph)."""
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

# Short enough that pause→expiry→takeover fits in a test, long enough
# that a loaded CI box renews comfortably (heartbeat = ttl/5).
TTL = 0.5
HB = 0.1


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
    replicated serving result must match bit-for-bit."""
    src = synthetic_cohort(8, 60, seed=9)
    base = _base_conf()
    rows = AnalysisEngine(src).run(base)
    return src, base, rows


def _wait_until(predicate, timeout_s=10.0, what="condition"):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if predicate():
            return
        time.sleep(0.02)
    raise TimeoutError(f"{what} not reached within {timeout_s}s")


# -- the durable store --------------------------------------------------------


class TestLocalDirStore:
    def test_put_get_roundtrip_listing_delete(self, tmp_path):
        store = LocalDirStore(str(tmp_path))
        store.put("jobs/a", b"alpha")
        store.put("jobs/b", b"\x00\xffbinary")
        store.put("other/c", b"gamma")
        assert store.get("jobs/a") == b"alpha"
        assert store.get("jobs/b") == b"\x00\xffbinary"
        assert store.list_keys("jobs/") == ["jobs/a", "jobs/b"]
        assert store.list_keys() == ["jobs/a", "jobs/b", "other/c"]
        store.delete("jobs/a")
        store.delete("jobs/a")  # delete of the absent is a no-op
        with pytest.raises(KeyError):
            store.get("jobs/a")
        assert store.list_keys("jobs/") == ["jobs/b"]
        ops = store.op_counts()
        assert ops["put"] == 3 and ops["get"] >= 3

    def test_checksum_guard_detects_flipped_byte(self, tmp_path):
        store = LocalDirStore(str(tmp_path))
        store.put("k", b"precious-bytes")
        # Flip one payload byte on disk, behind the store's back.
        (blob_path,) = [
            os.path.join(dp, f)
            for dp, _, fs in os.walk(str(tmp_path / "objects"))
            for f in fs
        ]
        raw = bytearray(open(blob_path, "rb").read())
        raw[-1] ^= 0x01
        with open(blob_path, "wb") as f:
            f.write(raw)
        with pytest.raises(StoreCorruptError, match="checksum"):
            store.get("k")

    def test_read_fault_seam_maps_to_store_error(self, tmp_path):
        store = LocalDirStore(str(tmp_path))
        store.put("k", b"v")
        plan = FaultPlan(
            seed=1,
            rules=[FaultRule(site="store.read", kind="error", times=1)],
        )
        with faults.active_plan(plan):
            with pytest.raises(StoreError):
                store.get("k")
            assert store.get("k") == b"v"  # rule exhausted, data intact
        assert plan.fired_total == 1

    def test_torn_write_leaves_partial_only_under_tmp_name(self, tmp_path):
        store = LocalDirStore(str(tmp_path))
        store.put("k", b"old-and-committed")
        plan = FaultPlan(
            seed=2,
            rules=[FaultRule(site="store.write", kind="torn", times=1)],
        )
        with faults.active_plan(plan):
            with pytest.raises(StoreError):
                store.put("k", b"new-but-torn")
        # The committed value survives; the partial never took the
        # final name (kill -9 mid-write fidelity: rename never ran).
        assert store.get("k") == b"old-and-committed"
        assert store.list_keys() == ["k"]
        leftovers = [
            f
            for dp, _, fs in os.walk(str(tmp_path / "objects"))
            for f in fs
            if ".tmp-" in f
        ]
        assert leftovers, "torn write should leave its *.tmp-* partial"

    def test_lease_cas_monotonic_fencing_token(self, tmp_path):
        now = {"t": 100.0}
        store = LocalDirStore(str(tmp_path), clock=lambda: now["t"])
        a = store.lease_acquire("replica-a", "replica-a", ttl_s=10.0)
        assert a is not None and a.token == 1
        # A live lease repels other owners...
        assert store.lease_acquire("replica-a", "intruder", 10.0) is None
        # ...while the holder itself re-acquires (token bumps — its own
        # older handle is fenced, the restart-with-same-id shape).
        again = store.lease_acquire("replica-a", "replica-a", 10.0)
        assert again is not None and again.token == 2
        with pytest.raises(FencedWriteError, match="stale"):
            store.lease_renew(a, 10.0)
        # Expiry opens the door; the token keeps climbing through the
        # takeover, never resets.
        now["t"] = 120.0
        taken = store.lease_acquire("replica-a", "survivor", 10.0)
        assert taken is not None and taken.token == 3
        assert store.lease_get("replica-a").owner == "survivor"
        with pytest.raises(FencedWriteError):
            store.check_fence(again)
        # A stale release is a silent no-op; the current one deletes.
        store.lease_release(again)
        assert store.lease_get("replica-a") is not None
        store.lease_release(taken)
        assert store.lease_get("replica-a") is None

    def test_check_fence_rejects_expired_and_gone(self, tmp_path):
        now = {"t": 0.0}
        store = LocalDirStore(str(tmp_path), clock=lambda: now["t"])
        lease = store.lease_acquire("r", "r", ttl_s=5.0)
        store.check_fence(lease)  # live: passes
        now["t"] = 6.0
        with pytest.raises(FencedWriteError, match="expired"):
            store.check_fence(lease)
        now["t"] = 0.0
        store.lease_release(lease)
        with pytest.raises(FencedWriteError, match="gone"):
            store.check_fence(lease)

    def test_put_fenced_zombie_write_never_lands(self, tmp_path):
        now = {"t": 0.0}
        store = LocalDirStore(str(tmp_path), clock=lambda: now["t"])
        old = store.lease_acquire("r", "r", ttl_s=5.0)
        now["t"] = 10.0
        new = store.lease_acquire("r", "survivor", ttl_s=5.0)
        with pytest.raises(FencedWriteError):
            store.put_fenced("jobs/z", b"zombie", old)
        with pytest.raises(KeyError):
            store.get("jobs/z")  # rejected loudly, nothing merged
        store.put_fenced("jobs/z", b"fresh", new)
        assert store.get("jobs/z") == b"fresh"

    def test_lease_fault_seam_corrupt_is_the_stale_token_shape(
        self, tmp_path
    ):
        store = LocalDirStore(str(tmp_path))
        lease = store.lease_acquire("r", "r", ttl_s=30.0)
        plan = FaultPlan(
            seed=3,
            rules=[
                FaultRule(
                    site="store.lease",
                    kind="corrupt",
                    match="renew:",
                    times=1,
                )
            ],
        )
        with faults.active_plan(plan):
            with pytest.raises(FencedWriteError, match="injected"):
                store.lease_renew(lease, 30.0)
            # Only the renew op was targeted; acquire-path CAS intact.
            assert store.lease_get("r").token == 1
        # Seam exhausted: the honest renew still works — the fault was
        # a verdict, not state damage.
        assert store.lease_renew(lease, 30.0).token == 1

    def test_lease_fault_seam_error_is_store_weather(self, tmp_path):
        store = LocalDirStore(str(tmp_path))
        plan = FaultPlan(
            seed=4,
            rules=[
                FaultRule(
                    site="store.lease",
                    kind="error",
                    match="acquire:",
                    times=1,
                )
            ],
        )
        with faults.active_plan(plan):
            with pytest.raises(StoreError):
                store.lease_acquire("r", "r", 30.0)
        assert store.lease_acquire("r", "r", 30.0).token == 1


# -- the lease manager -------------------------------------------------------


class TestLeaseManager:
    def test_acquire_heartbeat_release_lifecycle(self, tmp_path):
        store = LocalDirStore(str(tmp_path))
        mgr = LeaseManager(
            store, replica_id="r-1", ttl_s=TTL, heartbeat_s=HB
        )
        assert mgr.start() is True
        try:
            assert mgr.state() == "acquired" and not mgr.degraded()
            assert mgr.token() == 1
            first_expiry = store.lease_get("r-1").expires_unix
            _wait_until(
                lambda: store.lease_get("r-1").expires_unix > first_expiry,
                timeout_s=5.0,
                what="heartbeat renewal",
            )
            status = mgr.status()
            assert status["replica_id"] == "r-1"
            assert status["lease_state"] == "acquired"
            assert status["fencing_token"] == 1
            assert status["store_root"] == str(tmp_path)
        finally:
            mgr.stop()
        assert mgr.state() == "released"
        assert store.lease_get("r-1") is None  # lease released, not leaked

    def test_same_id_restart_fences_the_older_incarnation(self, tmp_path):
        """Two processes claiming one replica id: the NEWER start wins
        (the restart-with-same-id shape — the CAS bumps the token), and
        the older incarnation becomes a fenced zombie, never a silent
        co-writer."""
        store = LocalDirStore(str(tmp_path))
        mgr = LeaseManager(store, replica_id="r-dup", ttl_s=TTL, heartbeat_s=HB)
        assert mgr.start()
        twin = LeaseManager(
            LocalDirStore(str(tmp_path)),
            replica_id="r-dup",
            ttl_s=TTL,
            heartbeat_s=HB,
        )
        try:
            assert twin.start()
            assert twin.token() == 2
            _wait_until(
                lambda: mgr.state() == "lost",
                timeout_s=5.0,
                what="older incarnation fenced",
            )
            with pytest.raises(FencedWriteError, match="zombie"):
                mgr.check_fence()
        finally:
            mgr.stop()
            twin.stop()

    def test_start_rejected_while_a_live_takeover_holds_the_id(
        self, tmp_path
    ):
        """A replica restarting while a SURVIVOR still holds its
        taken-over lease must not start: the id belongs to the
        survivor until the adoption completes and releases it."""
        store = LocalDirStore(str(tmp_path))
        assert store.lease_acquire("r-dead", "r-survivor", ttl_s=30.0)
        reborn = LeaseManager(
            store, replica_id="r-dead", ttl_s=TTL, heartbeat_s=HB
        )
        with pytest.raises(FencedWriteError, match="live peer"):
            reborn.start()

    def test_degraded_start_then_degraded_renew_then_recovery(
        self, tmp_path
    ):
        # Unreachable at START: single-replica local mode, no lease.
        plan = FaultPlan(
            seed=5,
            rules=[
                FaultRule(site="store.lease", kind="error", match="acquire:")
            ],
        )
        store = LocalDirStore(str(tmp_path))
        mgr = LeaseManager(store, replica_id="r-x", ttl_s=TTL, heartbeat_s=HB)
        with faults.active_plan(plan):
            assert mgr.start() is False
        assert mgr.degraded() and mgr.lease() is None
        # Unreachable mid-flight: a leased replica weathers a renew
        # outage as degraded and RECOVERS when the store comes back.
        mgr2 = LeaseManager(
            LocalDirStore(str(tmp_path)),
            replica_id="r-y",
            ttl_s=TTL,
            heartbeat_s=HB,
        )
        assert mgr2.start()
        try:
            outage = FaultPlan(
                seed=6,
                rules=[
                    FaultRule(
                        site="store.lease",
                        kind="error",
                        match="renew:",
                        times=2,
                    )
                ],
            )
            with faults.active_plan(outage):
                _wait_until(mgr2.degraded, timeout_s=5.0, what="degraded")
                _wait_until(
                    lambda: not mgr2.degraded(),
                    timeout_s=5.0,
                    what="recovery",
                )
            assert mgr2.state() == "acquired"
            mgr2.check_fence()  # recovered replica writes again
        finally:
            mgr2.stop()

    def test_pause_expiry_takeover_makes_a_fenced_zombie(self, tmp_path):
        store = LocalDirStore(str(tmp_path))
        victim = LeaseManager(
            store, replica_id="r-victim", ttl_s=TTL, heartbeat_s=HB
        )
        survivor = LeaseManager(
            LocalDirStore(str(tmp_path)),
            replica_id="r-survivor",
            ttl_s=TTL,
            heartbeat_s=HB,
        )
        assert victim.start() and survivor.start()
        try:
            victim.pause()  # the SIGSTOP/GC-pause shape
            _wait_until(
                lambda: any(
                    p.name == "r-victim" for p in survivor.expired_peers()
                ),
                timeout_s=5.0,
                what="victim lease expiry",
            )
            (peer,) = [
                p for p in survivor.expired_peers() if p.name == "r-victim"
            ]
            taken = survivor.takeover(peer)
            assert taken is not None and taken.token == peer.token + 1
            # The woken zombie's next heartbeat discovers the loss...
            victim.resume()
            _wait_until(
                lambda: victim.state() == "lost",
                timeout_s=5.0,
                what="zombie detection",
            )
            # ...and every shared-state write gate rejects loudly.
            with pytest.raises(FencedWriteError, match="zombie"):
                victim.check_fence()
            # Marked-adopted peers drop out of the next scan.
            survivor.mark_adopted("r-victim", b"{}")
            assert all(
                p.name != "r-victim" for p in survivor.expired_peers()
            )
            survivor.finish_takeover(taken)
            assert store.lease_get("r-victim") is None
        finally:
            victim.stop()
            survivor.stop()


# -- tier failover: kill any replica, the survivor finishes the job ----------


class TestReplicatedFailover:
    def _replica_pair(self, tmp_path, src, base):
        store_root = str(tmp_path / "store")
        mgr_a = LeaseManager(
            LocalDirStore(store_root),
            replica_id="replica-a",
            ttl_s=TTL,
            heartbeat_s=HB,
        )
        mgr_b = LeaseManager(
            LocalDirStore(store_root),
            replica_id="replica-b",
            ttl_s=TTL,
            heartbeat_s=HB,
        )
        assert mgr_a.start() and mgr_b.start()
        tier_a = AnalysisJobTier(
            AnalysisEngine(src), base, workers=0, replica=mgr_a
        )
        tier_b = AnalysisJobTier(
            AnalysisEngine(src), base, workers=0, replica=mgr_b
        )
        return store_root, tier_a, tier_b

    def test_kill_mid_job_survivor_resumes_bit_identical(
        self, tmp_path, served_source
    ):
        src, base, baseline = served_source
        store_root, tier_a, tier_b = self._replica_pair(tmp_path, src, base)
        store = LocalDirStore(store_root)
        try:
            # Replica mode journals under the store, regardless of any
            # local journal preference — that is what makes the journal
            # adoptable.
            plan = FaultPlan(
                seed=17,
                rules=[
                    FaultRule(site="serving.job.kill", kind="error", times=1)
                ],
            )
            with faults.active_plan(plan):
                job, created = tier_a.submit(JobSpec(tenant="t1"))
                assert created
                with pytest.raises(SimulatedCrash):
                    tier_a.step(timeout=5.0)
            assert os.path.isdir(
                os.path.join(store_root, "replicas", "replica-a")
            )
            # ANY replica answers for the in-flight job via the shared
            # index — the load-balancer-behind-one-name contract.
            peer_rec = tier_b.peer_job_record(job.id)
            assert peer_rec is not None
            assert peer_rec["replica"] == "replica-a"
            assert store.get(JOB_INDEX_PREFIX + job.id)  # fenced write landed

            # Replica A dies mid-job (heartbeat stops; process state
            # survives so we can pin the zombie below).
            tier_a._replica.pause()
            _wait_until(
                lambda: any(
                    p.name == "replica-a"
                    for p in tier_b._replica.expired_peers()
                ),
                timeout_s=5.0,
                what="replica-a lease expiry",
            )
            assert tier_b.adopt_expired_peers() == 1
            adopted = tier_b.job(job.id)
            assert adopted is not None and adopted.state == "queued"
            assert adopted.trace_id == job.trace_id  # same timeline
            assert tier_b.step(timeout=30.0)
            assert adopted.state == "done"
            assert adopted.result == baseline  # exact float equality

            # Adoption bookkeeping: marker written (fenced on B's
            # lease), the dead lease doc released, nothing re-adoptable.
            marker = json.loads(
                store.get(ADOPTED_PREFIX + "replica-a").decode("utf-8")
            )
            assert marker["by"] == "replica-b" and marker["requeued"] == 1
            assert store.lease_get("replica-a") is None
            assert tier_b.adopt_expired_peers() == 0

            # The zombie wakes: its lease is gone, every write path is
            # rejected loudly — admission, journal, all of it.
            tier_a._replica.resume()
            _wait_until(
                lambda: tier_a._replica.state() == "lost",
                timeout_s=5.0,
                what="zombie detection on replica-a",
            )
            with pytest.raises(FencedWriteError, match="zombie"):
                tier_a.submit(JobSpec(tenant="zombie", num_pc=4))
            # The rejected admission was rolled back, not half-kept.
            assert all(j.spec.tenant != "zombie" for j in tier_a.jobs())
            assert tier_a.queue_depth() == 0
            with pytest.raises(FencedWriteError):
                tier_a._journal_append_safe({"e": "start", "id": "zzz"})
            health = tier_a.replica_health()
            assert health["lease_state"] == "lost"
            assert health["store_reachable"] is True
        finally:
            tier_a.close()
            tier_b.close()

    def test_adoption_preserves_submission_order(
        self, tmp_path, served_source
    ):
        src, base, _ = served_source
        _, tier_a, tier_b = self._replica_pair(tmp_path, src, base)
        try:
            ids = []
            for pc in (2, 3, 4):
                job, _ = tier_a.submit(JobSpec(tenant="t", num_pc=pc))
                ids.append(job.id)
            tier_a._replica.pause()
            _wait_until(
                lambda: any(
                    p.name == "replica-a"
                    for p in tier_b._replica.expired_peers()
                ),
                timeout_s=5.0,
                what="replica-a lease expiry",
            )
            assert tier_b.adopt_expired_peers() == 1
            assert [j.id for j in tier_b.jobs()] == ids
            assert tier_b.queue_depth() == 3
            # Execution order follows submission order — the fairness
            # the dead replica's clients were promised.
            assert tier_b.step(timeout=30.0)
            assert tier_b.job(ids[0]).state == "done"
            assert tier_b.job(ids[1]).state == "queued"
        finally:
            tier_a.close()
            tier_b.close()

    def test_degraded_store_serves_single_replica_local(
        self, tmp_path, served_source
    ):
        src, base, baseline = served_source
        plan = FaultPlan(
            seed=7,
            rules=[
                FaultRule(site="store.lease", kind="error", match="acquire:")
            ],
        )
        mgr = LeaseManager(
            LocalDirStore(str(tmp_path / "store")),
            replica_id="r-deg",
            ttl_s=TTL,
            heartbeat_s=HB,
        )
        with faults.active_plan(plan):
            assert mgr.start() is False
        journal_dir = str(tmp_path / "local-journal")
        tier = AnalysisJobTier(
            AnalysisEngine(src),
            base,
            workers=0,
            journal_dir=journal_dir,
            replica=mgr,
        )
        try:
            # Degraded from birth: the journal stays LOCAL (a journal
            # on an unreachable store would be an availability hole).
            health = tier.replica_health()
            assert health["store_reachable"] is False
            job, _ = tier.submit(JobSpec(tenant="t"))
            assert tier.step(timeout=5.0)
            assert job.state == "done" and job.result == baseline
            assert os.path.isdir(journal_dir)
            # No store root adopted → cross-replica lookup answers
            # "unknown here" rather than hanging on the dead store.
            assert tier.peer_job_record("nope") is None
        finally:
            tier.close()

    def test_store_degradation_maps_to_503_retry_after(
        self, tmp_path, served_source
    ):
        """A replica that LOSES the store mid-flight keeps serving its
        own jobs but answers cross-replica lookups with 503 +
        Retry-After (never a lying 404), and recovers when the weather
        clears."""
        src, base, _ = served_source
        mgr = LeaseManager(
            LocalDirStore(str(tmp_path / "store")),
            replica_id="r-503",
            ttl_s=TTL,
            heartbeat_s=HB,
        )
        assert mgr.start()
        tier = AnalysisJobTier(
            AnalysisEngine(src), base, workers=0, replica=mgr
        )
        server = GenomicsServiceServer(src, job_tier=tier).start()
        conn = http.client.HTTPConnection(
            "127.0.0.1", server.port, timeout=30
        )
        try:
            outage = FaultPlan(
                seed=8,
                rules=[
                    FaultRule(
                        site="store.lease",
                        kind="error",
                        match="renew:",
                        times=2,
                    )
                ],
            )
            with faults.active_plan(outage):
                _wait_until(mgr.degraded, timeout_s=5.0, what="degraded")
                conn.request("GET", "/jobs/absent-job-id")
                resp = conn.getresponse()
                body = json.loads(resp.read())
                assert resp.status == 503
                assert resp.getheader("Retry-After") is not None
                assert body["reason"] == "store_degraded"
                _wait_until(
                    lambda: not mgr.degraded(),
                    timeout_s=5.0,
                    what="recovery",
                )
            conn.request("GET", "/jobs/absent-job-id")
            resp = conn.getresponse()
            resp.read()
            assert resp.status == 404  # store back: an honest miss again
        finally:
            conn.close()
            server.stop()
            tier.close()


# -- cross-replica Gramian sharing -------------------------------------------


class TestCrossReplicaDeltaSharing:
    def test_peer_persisted_entry_found_by_rescan_on_miss(self, tmp_path):
        shared = str(tmp_path / "deltas")
        reader = DeltaIndex(max_delta_samples=4, persist_dir=shared)
        writer = DeltaIndex(max_delta_samples=4, persist_dir=shared)
        g = np.arange(16, dtype=np.float64).reshape(4, 4)
        writer.put("base-key", ("s1", "s2"), g)
        # The reader indexed an empty dir at startup; the miss triggers
        # a rescan that picks up what the peer persisted since.
        entry = reader.resolve("base-key", ("s1", "s2"))
        assert entry is not None
        np.testing.assert_array_equal(entry.g, g)

    def test_zombie_delta_persist_is_fenced_before_any_write(self, tmp_path):
        shared = str(tmp_path / "deltas")

        def fence():
            raise FencedWriteError("replica lost its lease (test)")

        zombie = DeltaIndex(
            max_delta_samples=4, persist_dir=shared, fence=fence
        )
        with pytest.raises(FencedWriteError):
            zombie.put("base-key", ("s1",), np.eye(2))
        # Loudly rejected AND nothing merged into the shared dir.
        assert [f for f in os.listdir(shared) if ".partial" not in f] == []


# -- observability: schema drift, live endpoints ------------------------------


class TestReplicaSchemaDrift:
    """Both rejection directions for the replica obs surface: the
    adoption span and lease/degraded series are schema-known, and a
    lease sample without its outcome label still fails the gate."""

    @staticmethod
    def _trace_with(tmp_path, name):
        trace = tmp_path / "t.json"
        trace.write_text(
            json.dumps(
                {
                    "traceEvents": [
                        {"ph": "X", "name": name, "pid": 1, "ts": 0, "dur": 1}
                    ]
                }
            )
        )
        return str(trace)

    def test_adopt_span_is_schema_known(self, tmp_path):
        assert validate.validate_trace(self._trace_with(tmp_path, "job.adopt")) == []

    def test_unknown_replica_span_rejected(self, tmp_path):
        errs = validate.validate_trace(
            self._trace_with(tmp_path, "job.usurp")
        )
        assert errs and "job.usurp" in errs[0]

    def test_lease_counter_requires_outcome_label(self, tmp_path):
        good = tmp_path / "good.prom"
        good.write_text(
            'serving_lease_total{outcome="acquired"} 1\n'
            'serving_lease_total{outcome="takeover"} 1\n'
            "serving_store_degraded 0\n"
        )
        assert validate.validate_metrics(str(good)) == []
        bad = tmp_path / "bad.prom"
        bad.write_text("serving_lease_total 2\n")
        errs = validate.validate_metrics(str(bad))
        assert errs and "outcome" in errs[0]

    def test_malformed_lease_sample_rejected(self, tmp_path):
        bad = tmp_path / "bad.prom"
        bad.write_text('serving_lease_total{outcome=acquired} oops\n')
        errs = validate.validate_metrics(str(bad))
        assert errs and "malformed" in errs[0]


def _get_raw(conn, path, headers=None):
    conn.request("GET", path, headers=headers or {})
    resp = conn.getresponse()
    return resp.status, dict(resp.getheaders()), resp.read()


class TestReplicaIntrospection:
    """The live endpoints grow the replica plane: /healthz carries
    lease state (a zombie FAILS liveness), /statusz carries the full
    replica snapshot, /metrics serves the lease series schema-valid."""

    @pytest.fixture()
    def live(self, tmp_path, served_source):
        src, base, _ = served_source
        with TelemetrySession():
            store_root = str(tmp_path / "store")
            mgr = LeaseManager(
                LocalDirStore(store_root),
                replica_id="r-live",
                ttl_s=TTL,
                heartbeat_s=HB,
            )
            assert mgr.start()
            tier = AnalysisJobTier(
                AnalysisEngine(src), base, workers=0, replica=mgr
            )
            server = GenomicsServiceServer(src, job_tier=tier).start()
            conn = http.client.HTTPConnection(
                "127.0.0.1", server.port, timeout=30
            )
            try:
                yield store_root, mgr, tier, conn
            finally:
                conn.close()
                server.stop()
                tier.close()

    def test_healthz_carries_replica_block(self, live):
        _, _, _, conn = live
        st, _, body = _get_raw(conn, "/healthz")
        assert st == 200
        doc = json.loads(body)
        replica = doc["checks"]["replica"]
        assert replica["replica_id"] == "r-live"
        assert replica["lease_state"] == "acquired"
        assert replica["store_reachable"] is True

    def test_zombie_fails_liveness(self, live):
        store_root, mgr, _, conn = live
        # A second handle usurps the expired lease — the honest path to
        # "lost", no state poking.
        mgr.pause()
        usurper = LocalDirStore(store_root)
        _wait_until(
            lambda: usurper.lease_get("r-live").expired(usurper.now()),
            timeout_s=5.0,
            what="lease expiry",
        )
        assert usurper.lease_acquire("r-live", "usurper", 30.0) is not None
        mgr.resume()
        _wait_until(
            lambda: mgr.state() == "lost", timeout_s=5.0, what="lost"
        )
        st, _, body = _get_raw(conn, "/healthz")
        doc = json.loads(body)
        assert st == 503 and doc["status"] == "unhealthy"
        assert doc["checks"]["replica"]["lease_state"] == "lost"

    def test_statusz_carries_replica_snapshot(self, live):
        store_root, _, _, conn = live
        st, _, body = _get_raw(conn, "/statusz")
        assert st == 200
        replica = json.loads(body)["tier"]["replica"]
        assert replica["replica_id"] == "r-live"
        assert replica["lease_state"] == "acquired"
        assert replica["fencing_token"] == 1
        assert replica["store_root"] == store_root
        assert replica["store_degraded"] is False
        assert "store_ops" in replica

    def test_metrics_serve_lease_series_schema_valid(self, live, tmp_path):
        _, _, _, conn = live
        # At least acquire + one renewal have been noted by now (the
        # fixture's heartbeat is 10x faster than this request).
        _wait_until(
            lambda: b"serving_lease_total" in _get_raw(conn, "/metrics")[2],
            timeout_s=5.0,
            what="lease series on /metrics",
        )
        st, headers, body = _get_raw(conn, "/metrics")
        assert st == 200
        assert b"serving_lease_total{" in body
        assert b"serving_store_degraded" in body
        scrape = tmp_path / "scrape.prom"
        scrape.write_bytes(body)
        assert validate.validate_metrics(str(scrape)) == []


# -- the black-box soak: two processes, kill -9 either one --------------------


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


# -- the port against the JAX package -----------------------------------------


class TestAgainstTheJaxStore:
    def test_blobs_written_by_either_package_read_in_the_other(
        self, tmp_path
    ):
        from spark_examples_tpu.store import LocalDirStore as JaxStore

        root = str(tmp_path / "store")
        port, ref = LocalDirStore(root), JaxStore(root)
        port.put("jobs/p", b"port \x00 bytes")
        ref.put("jobs/j", b"jax \xff bytes")
        assert ref.get("jobs/p") == b"port \x00 bytes"
        assert port.get("jobs/j") == b"jax \xff bytes"
        assert port.list_keys("jobs/") == ref.list_keys("jobs/")
        # The same payload frames to the same bytes on disk.
        port.put("same/p", b"payload")
        ref.put("same/j", b"payload")
        objects = os.path.join(root, "objects", "same")
        with open(os.path.join(objects, "p"), "rb") as f:
            framed_port = f.read()
        with open(os.path.join(objects, "j"), "rb") as f:
            assert f.read() == framed_port

    def test_leases_and_fencing_cross_packages(self, tmp_path):
        from spark_examples_tpu.store import (
            FencedWriteError as JaxFenced,
            LocalDirStore as JaxStore,
        )

        root = str(tmp_path / "store")
        port, ref = LocalDirStore(root), JaxStore(root)
        held = port.lease_acquire("replica-a", "holder-port", 0.2)
        seen = ref.lease_get("replica-a")
        assert seen is not None and seen.token == held.token
        assert seen.owner == "holder-port"
        time.sleep(0.3)
        taken = ref.lease_acquire("replica-a", "holder-jax", 5.0)
        assert taken.token > held.token
        # The port's expired holder is now a zombie: its fenced write is
        # refused, and nothing lands.
        with pytest.raises(FencedWriteError):
            port.put_fenced("jobs/z", b"late", held)
        with pytest.raises(KeyError):
            ref.get("jobs/z")
        ref.put_fenced("jobs/ok", b"owner", taken)
        assert port.get("jobs/ok") == b"owner"
        stale = port.lease_get("replica-a")
        with pytest.raises(JaxFenced):
            ref.check_fence(held)
        port.check_fence(stale)
