"""Replica identity + lease management for the replicated serving plane.

Each ``serve-cohort`` process gets a **replica identity** and a
:class:`LeaseManager` holding a lease on its own name in the shared
:class:`~spark_examples_tpu_torch.store.DurableStore`:

- the lease carries a **monotonic fencing token** (bumped on every
  acquisition — first grab, re-grab after expiry, takeover), renewed by
  a heartbeat daemon thread every ``heartbeat_s`` against a TTL of
  ``ttl_s``;
- a replica whose renewal is rejected (a peer took its lease over) is a
  **zombie**: its state drops to ``lost``, and every fenced write it
  attempts afterwards — journal appends, shared job-index puts, delta
  write-throughs — is rejected loudly with
  :class:`~spark_examples_tpu_torch.store.FencedWriteError`, never
  torn-merged into shared state;
- a peer whose lease **expired** (it stopped heartbeating: killed,
  wedged, partitioned) is adoptable: :meth:`LeaseManager.takeover`
  CAS-claims the dead peer's lease (bumping its token, which fences the
  peer should it wake), after which the serving tier replays the peer's
  journal and re-queues its in-flight jobs in submission order;
- a replica that cannot reach the store **degrades, never crashes**: it
  keeps serving in single-replica local mode, the
  ``serving_store_degraded`` gauge goes to 1, and replica-dependent
  HTTP paths answer 503 + Retry-After until the store returns.

The lease state machine (pinned in docs/RESILIENCE.md):

    init --start()--> acquired --renew ok--> acquired
    acquired --renew CAS-rejected--> lost         (terminal: zombie)
    acquired --store unreachable--> acquired+degraded
    acquired+degraded --renew ok--> acquired      (recovered)
    acquired --stop()--> released                 (terminal)

Every transition emits a ``lease_transition`` instant and counts
``serving_lease_total{outcome}``.
"""

from __future__ import annotations

import os
import socket
import threading
import uuid
from typing import Dict, List, Optional

from spark_examples_tpu_torch.store import (
    DurableStore,
    FencedWriteError,
    Lease,
    StoreError,
)
from spark_examples_tpu_torch.utils.lockcheck import assert_lock_held

__all__ = [
    "DEFAULT_HEARTBEAT_S",
    "DEFAULT_LEASE_TTL_S",
    "LeaseManager",
    "generate_replica_id",
]

DEFAULT_LEASE_TTL_S = 5.0
DEFAULT_HEARTBEAT_S = 1.0

# Store-key namespaces the replica plane writes under.
JOB_INDEX_PREFIX = "jobs/"
ADOPTED_PREFIX = "adopted/"


def generate_replica_id() -> str:
    """A replica id unique across processes and restarts — a restarted
    process is a NEW replica that adopts its predecessor's journal via
    the same expired-lease path as any other dead peer."""
    host = socket.gethostname().split(".")[0][:16] or "host"
    return f"r-{host}-{os.getpid()}-{uuid.uuid4().hex[:6]}"


def _note_lease(outcome: str, replica_id: str, token: int) -> None:
    from spark_examples_tpu_torch import obs
    from spark_examples_tpu_torch.obs.tracer import collection_active

    obs.instant(
        "lease_transition",
        scope="p",
        outcome=outcome,
        replica=replica_id,
        token=token,
    )
    if collection_active():
        obs.get_registry().counter(
            "serving_lease_total",
            "Replica lease transitions (outcome: acquired/renewed/lost/"
            "takeover/degraded/recovered/released/rejected_write)",
        ).labels(outcome=outcome).inc()


def _note_degraded(value: float) -> None:
    from spark_examples_tpu_torch import obs
    from spark_examples_tpu_torch.obs.tracer import collection_active

    if collection_active():
        obs.get_registry().gauge(
            "serving_store_degraded",
            "1 while the durable store is unreachable and this replica "
            "is serving in single-replica local mode",
        ).set(value)


class LeaseManager:
    """Owns one replica's lease lifecycle over a shared store."""

    def __init__(
        self,
        store: DurableStore,
        replica_id: Optional[str] = None,
        ttl_s: float = DEFAULT_LEASE_TTL_S,
        heartbeat_s: float = DEFAULT_HEARTBEAT_S,
    ) -> None:
        if ttl_s <= 0:
            raise ValueError(f"lease ttl must be > 0, got {ttl_s}")
        if not (0 < heartbeat_s < ttl_s):
            raise ValueError(
                f"heartbeat ({heartbeat_s}s) must be positive and "
                f"shorter than the lease ttl ({ttl_s}s) — a heartbeat "
                "that cannot outrun expiry makes every replica a zombie"
            )
        self.store = store
        self.replica_id = replica_id or generate_replica_id()
        self.ttl_s = float(ttl_s)
        self.heartbeat_s = float(heartbeat_s)
        self._lock = threading.Lock()
        self._lease: Optional[Lease] = None
        self._state = "init"
        self._degraded = False
        self._paused = False
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- guarded state ---------------------------------------------------------

    def _set_state_locked(
        self, state: Optional[str] = None, degraded: Optional[bool] = None
    ) -> None:
        assert_lock_held(self._lock, "LeaseManager._set_state_locked")
        if state is not None:
            self._state = state
        if degraded is not None:
            self._degraded = degraded

    def state(self) -> str:
        with self._lock:
            return self._state

    def degraded(self) -> bool:
        with self._lock:
            return self._degraded

    def token(self) -> int:
        with self._lock:
            return self._lease.token if self._lease is not None else 0

    def lease(self) -> Optional[Lease]:
        with self._lock:
            return self._lease

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> bool:
        """Acquire this replica's lease and start the heartbeat thread.

        Returns False — degraded single-replica local mode — when the
        store is unreachable; raises :class:`FencedWriteError` when a
        LIVE peer already holds this replica id (a configuration error
        that must not be survived silently)."""
        try:
            lease = self.store.lease_acquire(
                self.replica_id, self.replica_id, self.ttl_s
            )
        except StoreError as e:
            self._enter_degraded(f"lease acquire: {e}")
            return False
        if lease is None:
            raise FencedWriteError(
                f"replica id {self.replica_id!r} is held by a live peer "
                "— replica ids must be unique per process"
            )
        with self._lock:
            self._lease = lease
            self._set_state_locked(state="acquired", degraded=False)
        _note_lease("acquired", self.replica_id, lease.token)
        _note_degraded(0.0)
        self._thread = threading.Thread(
            target=self._heartbeat_loop,
            name=f"lease-heartbeat-{self.replica_id}",
            daemon=True,
        )
        self._thread.start()
        return True

    def stop(self) -> None:
        """Stop heartbeating and release the lease (CAS: a zombie's
        release is a no-op — the lease already moved on)."""
        self._stop_event.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=2 * self.heartbeat_s + 1.0)
        with self._lock:
            lease = self._lease
            state = self._state
            self._set_state_locked(state="released")
        if lease is not None and state == "acquired":
            try:
                self.store.lease_release(lease)
                _note_lease("released", self.replica_id, lease.token)
            except StoreError:
                pass

    def pause(self) -> None:
        """Chaos hook: stop renewing WITHOUT stopping the process — the
        SIGSTOP/GC-pause shape. The lease expires, a peer takes over,
        and this replica wakes up a zombie whose writes must be
        rejected (the zombie-fencing pin)."""
        with self._lock:
            self._paused = True

    def resume(self) -> None:
        with self._lock:
            self._paused = False

    def _heartbeat_loop(self) -> None:
        while not self._stop_event.wait(self.heartbeat_s):
            with self._lock:
                lease = self._lease
                paused = self._paused
                state = self._state
            if paused or lease is None or state not in ("acquired",):
                continue
            try:
                renewed = self.store.lease_renew(lease, self.ttl_s)
            except FencedWriteError as e:
                with self._lock:
                    self._set_state_locked(state="lost")
                _note_lease("lost", self.replica_id, lease.token)
                print(
                    f"[replica {self.replica_id}] lease LOST — this "
                    f"process is a zombie; shared-state writes will be "
                    f"rejected: {e}"
                )
                return
            except StoreError as e:
                self._enter_degraded(f"lease renew: {e}")
                continue
            recovered = False
            with self._lock:
                self._lease = renewed
                recovered = self._degraded
                self._set_state_locked(degraded=False)
            _note_lease(
                "recovered" if recovered else "renewed",
                self.replica_id,
                renewed.token,
            )
            if recovered:
                _note_degraded(0.0)
                print(
                    f"[replica {self.replica_id}] store reachable again "
                    "— leaving degraded single-replica mode"
                )

    def _enter_degraded(self, why: str) -> None:
        first = False
        with self._lock:
            first = not self._degraded
            self._set_state_locked(degraded=True)
        if first:
            _note_lease("degraded", self.replica_id, self.token())
            _note_degraded(1.0)
            print(
                f"[replica {self.replica_id}] store unreachable "
                f"({why}) — degrading to single-replica local mode"
            )

    # -- fencing ---------------------------------------------------------------

    def check_fence(self) -> None:
        """Gate for every shared-state write. Raises
        :class:`FencedWriteError` when this replica is a zombie (lease
        lost or taken over); silently allows writes while degraded —
        degraded mode writes no shared state, and the local journal is
        this process's own."""
        with self._lock:
            lease = self._lease
            state = self._state
            degraded = self._degraded
        if state == "lost":
            _note_lease("rejected_write", self.replica_id, self.token())
            raise FencedWriteError(
                f"replica {self.replica_id!r} lost its lease — write "
                "rejected (zombie fencing)"
            )
        if lease is None or degraded:
            return
        try:
            self.store.check_fence(lease)
        except FencedWriteError:
            with self._lock:
                self._set_state_locked(state="lost")
            _note_lease("rejected_write", self.replica_id, lease.token)
            raise
        except StoreError as e:
            # Unreachable store is IO weather, not a fencing verdict:
            # degrade and let the write itself surface any IO error.
            self._enter_degraded(f"fence check: {e}")

    # -- peers -----------------------------------------------------------------

    def peers(self) -> List[Lease]:
        return [
            lease
            for lease in self.store.lease_list()
            if lease.name != self.replica_id
        ]

    def expired_peers(self) -> List[Lease]:
        """Dead peers whose journals are adoptable: lease expired and
        no adoption marker yet. Store trouble answers [] — peer
        adoption is a replica-mode feature, degraded mode has none."""
        try:
            now = self.store.now()
            out: List[Lease] = []
            for lease in self.peers():
                if not lease.expired(now):
                    continue
                try:
                    self.store.get(ADOPTED_PREFIX + lease.name)
                    continue  # already adopted
                except KeyError:
                    pass
                out.append(lease)
            return out
        except (StoreError, OSError):
            return []

    def takeover(self, peer: Lease) -> Optional[Lease]:
        """CAS-claim a dead peer's lease. Success bumps the peer's
        fencing token — the peer, should it wake, is a zombie from this
        instant. None when another survivor won the race."""
        try:
            got = self.store.lease_acquire(
                peer.name, self.replica_id, self.ttl_s
            )
        except StoreError as e:
            self._enter_degraded(f"takeover: {e}")
            return None
        if got is not None:
            _note_lease("takeover", self.replica_id, got.token)
        return got

    def mark_adopted(self, peer_name: str, payload: bytes) -> None:
        """Persist the adoption marker (fenced on OUR lease) after the
        peer's jobs are re-queued — written last, so a survivor that
        dies mid-adoption leaves the peer adoptable by the next one
        (at-least-once, results bit-identical either way)."""
        lease = self.lease()
        if lease is None:
            return
        self.store.put_fenced(ADOPTED_PREFIX + peer_name, payload, lease)

    def finish_takeover(self, taken: Lease) -> None:
        """Release the adopted peer's lease once its journal is
        replayed. The doc disappears; the zombie's fence check still
        rejects (lease gone ⇒ stale by definition)."""
        try:
            self.store.lease_release(taken)
        except StoreError:
            pass

    # -- introspection ---------------------------------------------------------

    def status(self) -> Dict[str, object]:
        with self._lock:
            lease = self._lease
            doc: Dict[str, object] = {
                "replica_id": self.replica_id,
                "lease_state": self._state,
                "fencing_token": lease.token if lease is not None else 0,
                "store_degraded": self._degraded,
                "ttl_s": self.ttl_s,
                "heartbeat_s": self.heartbeat_s,
            }
        try:
            doc["peers"] = sorted(lease.name for lease in self.peers())
            doc["store_ops"] = getattr(self.store, "op_counts", dict)()
        except (StoreError, OSError):
            doc["peers"] = []
        root = getattr(self.store, "root", None)
        if root is not None:
            doc["store_root"] = root
        return doc
