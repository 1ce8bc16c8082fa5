"""Local-shared-directory backend for :class:`DurableStore`.

One directory (an NFS mount, a shared volume, a tmpdir under test) is
the whole store: blobs live under ``objects/``, lease documents under
``leases/``. Every mutation follows the repo's atomic-write idiom —
tmp→flush→fsync→rename — so a kill -9 at any instant leaves either the
old bytes or the new bytes, never a torn blob; every blob carries an
embedded blake2b digest so a reader can never consume silent
corruption (:class:`StoreCorruptError` is loud).

Compare-and-swap for leases is built on the only cross-process atomic
primitive a plain directory offers: ``os.mkdir`` of a per-lease mutex
directory. The mutex is held for microseconds (one read-modify-write of
a <1 KiB JSON doc); a holder that died mid-CAS is broken after
``_LEASE_MUTEX_STALE_S``. Fencing tokens are monotonic across ALL
acquisitions of a lease name — first grab, re-grab after expiry,
takeover — so a write fenced on an old token can always be rejected.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from spark_examples_tpu_torch.resilience import faults
from spark_examples_tpu_torch.utils.lockcheck import assert_lock_held

__all__ = [
    "DurableStore",
    "FencedWriteError",
    "Lease",
    "LocalDirStore",
    "StoreCorruptError",
    "StoreError",
]

_MAGIC = b"SESTORE1"
# A crashed CAS holder is broken after this long — the mutex protects a
# sub-millisecond read-modify-write, so seconds of silence means death.
_LEASE_MUTEX_STALE_S = 5.0
_LEASE_MUTEX_WAIT_S = 2.0


class StoreError(IOError):
    """The store is unreachable or an operation failed as IO weather —
    the degradable shape: callers drop to single-replica local mode."""


class StoreCorruptError(StoreError):
    """A blob's embedded checksum does not match its payload."""


class FencedWriteError(RuntimeError):
    """A lease-fenced operation was rejected: the caller's fencing
    token is stale (a peer took the lease over, or it expired and was
    re-acquired). Deliberately NOT an ``IOError`` — retry/degrade
    handlers for IO weather must never swallow a fencing rejection."""


@dataclass(frozen=True)
class Lease:
    """One lease observation: who holds ``name``, under which fencing
    ``token``, until ``expires_unix`` (per the store's clock)."""

    name: str
    owner: str
    token: int
    expires_unix: float

    def expired(self, now: float) -> bool:
        return now >= self.expires_unix


class DurableStore:
    """The durable-state contract the replica plane is written against.

    Blob half: ``put`` is atomic and checksummed, ``get`` verifies,
    ``list_keys`` enumerates by prefix. Lease half: ``lease_acquire`` /
    ``lease_renew`` / ``lease_release`` are compare-and-swap on a
    per-name lease document carrying a monotonic fencing token;
    ``check_fence`` / ``put_fenced`` reject stale-token writers loudly.
    """

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def list_keys(self, prefix: str = "") -> List[str]:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def lease_acquire(
        self, name: str, owner: str, ttl_s: float
    ) -> Optional[Lease]:
        raise NotImplementedError

    def lease_renew(self, lease: Lease, ttl_s: float) -> Lease:
        raise NotImplementedError

    def lease_release(self, lease: Lease) -> None:
        raise NotImplementedError

    def lease_get(self, name: str) -> Optional[Lease]:
        raise NotImplementedError

    def lease_list(self, prefix: str = "") -> List[Lease]:
        raise NotImplementedError

    def check_fence(self, lease: Lease) -> None:
        raise NotImplementedError

    def put_fenced(self, key: str, data: bytes, lease: Lease) -> None:
        raise NotImplementedError


def _digest(payload: bytes) -> str:
    return hashlib.blake2b(payload, digest_size=16).hexdigest()


class LocalDirStore(DurableStore):
    """:class:`DurableStore` over one shared directory."""

    def __init__(
        self,
        root: str,
        clock: Callable[[], float] = time.time,
    ) -> None:
        self.root = os.path.abspath(root)
        self._clock = clock
        self._lock = threading.Lock()
        # Op counters for /statusz introspection; guarded by _lock.
        self._op_counts: Dict[str, int] = {}
        try:
            os.makedirs(os.path.join(self.root, "objects"), exist_ok=True)
            os.makedirs(os.path.join(self.root, "leases"), exist_ok=True)
        except OSError as e:
            raise StoreError(f"store root {self.root!r} unusable: {e}") from e

    # -- introspection ---------------------------------------------------------

    def _count_locked(self, op: str) -> None:
        assert_lock_held(self._lock, "LocalDirStore._count_locked")
        self._op_counts[op] = self._op_counts.get(op, 0) + 1

    def _count(self, op: str) -> None:
        with self._lock:
            self._count_locked(op)

    def op_counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._op_counts)

    # -- paths -----------------------------------------------------------------

    def _object_path(self, key: str) -> str:
        if not key or key.startswith(("/", "\\")) or ".." in key.split("/"):
            raise ValueError(f"invalid store key {key!r}")
        return os.path.join(self.root, "objects", *key.split("/"))

    def _lease_path(self, name: str) -> str:
        if not name or "/" in name or name.startswith("."):
            raise ValueError(f"invalid lease name {name!r}")
        return os.path.join(self.root, "leases", name + ".json")

    # -- blobs -----------------------------------------------------------------

    def put(self, key: str, data: bytes) -> None:
        """Atomic checksummed write: tmp→flush→fsync→rename. The
        ``store.write`` seam fires between the tmp write and the
        rename — a ``torn`` fault truncates the tmp and raises, so a
        partial can only ever exist under a ``*.tmp-*`` name."""
        path = self._object_path(key)
        self._count("put")
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.tmp-{os.getpid()}"
            framed = (
                _MAGIC
                + b" "
                + _digest(data).encode("ascii")
                + b" "
                + str(len(data)).encode("ascii")
                + b"\n"
                + data
            )
            with open(tmp, "wb") as f:
                f.write(framed)
                f.flush()
                os.fsync(f.fileno())
            # Torn truncates the tmp and raises — the kill -9-mid-write
            # shape: the partial only ever exists under a *.tmp-* name
            # (ignored by get/list), the rename never runs.
            faults.inject_write("store.write", tmp)
            os.replace(tmp, path)
        except faults.InjectedFault as e:
            raise StoreError(f"store put {key!r} failed: {e}") from e
        except OSError as e:
            raise StoreError(f"store put {key!r} failed: {e}") from e

    def get(self, key: str) -> bytes:
        """Checksummed read; :class:`KeyError` when absent,
        :class:`StoreCorruptError` when the digest does not match."""
        path = self._object_path(key)
        self._count("get")
        try:
            faults.inject("store.read", key=key)
            with open(path, "rb") as f:
                blob = f.read()
        except FileNotFoundError:
            raise KeyError(key) from None
        except faults.InjectedFault as e:
            raise StoreError(f"store get {key!r} failed: {e}") from e
        except OSError as e:
            raise StoreError(f"store get {key!r} failed: {e}") from e
        header, sep, payload = blob.partition(b"\n")
        parts = header.split(b" ")
        if not sep or len(parts) != 3 or parts[0] != _MAGIC:
            raise StoreCorruptError(f"store blob {key!r}: unframed/torn")
        if (
            str(len(payload)).encode("ascii") != parts[2]
            or _digest(payload).encode("ascii") != parts[1]
        ):
            raise StoreCorruptError(
                f"store blob {key!r}: checksum mismatch "
                "(torn or corrupted write)"
            )
        return payload

    def list_keys(self, prefix: str = "") -> List[str]:
        base = os.path.join(self.root, "objects")
        self._count("list")
        out: List[str] = []
        try:
            for dirpath, _dirnames, filenames in os.walk(base):
                for fname in filenames:
                    if ".tmp-" in fname:
                        continue
                    rel = os.path.relpath(
                        os.path.join(dirpath, fname), base
                    ).replace(os.sep, "/")
                    if rel.startswith(prefix):
                        out.append(rel)
        except OSError as e:
            raise StoreError(f"store list {prefix!r} failed: {e}") from e
        return sorted(out)

    def delete(self, key: str) -> None:
        self._count("delete")
        try:
            os.unlink(self._object_path(key))
        except FileNotFoundError:
            pass
        except OSError as e:
            raise StoreError(f"store delete {key!r} failed: {e}") from e

    # -- lease CAS -------------------------------------------------------------

    def _lease_fault(self, op: str, name: str) -> None:
        """The ``store.lease`` seam. Kinds are interpreted at the CAS:
        ``error`` raises :class:`StoreError` (store unreachable),
        ``stall`` sleeps, and ``corrupt`` is the **stale-token** shape —
        the CAS behaves as though a peer bumped the fencing token, so
        the caller's lease is rejected as lost."""
        rule = faults.take("store.lease", key=f"{op}:{name}")
        if rule is None:
            return
        if rule.kind == "stall":
            time.sleep(rule.stall_s)
            return
        if rule.kind == "corrupt":
            raise FencedWriteError(
                f"lease {name!r} {op} rejected: stale fencing token "
                "(injected)"
            )
        raise StoreError(f"store lease {op} {name!r} failed: injected fault")

    def _mutex_acquire(self, name: str) -> str:
        lock_dir = self._lease_path(name) + ".lck"
        deadline = time.monotonic() + _LEASE_MUTEX_WAIT_S
        while True:
            try:
                os.mkdir(lock_dir)
                return lock_dir
            except FileExistsError:
                try:
                    age = time.time() - os.stat(lock_dir).st_mtime
                    if age > _LEASE_MUTEX_STALE_S:
                        # Crashed CAS holder: break the mutex loudly.
                        print(
                            f"[store] breaking stale lease mutex {lock_dir}"
                            f" (held {age:.1f}s)"
                        )
                        os.rmdir(lock_dir)
                        continue
                except OSError:
                    pass
                if time.monotonic() > deadline:
                    raise StoreError(
                        f"lease mutex {lock_dir} held too long"
                    ) from None
                time.sleep(0.005)
            except OSError as e:
                raise StoreError(f"lease mutex {lock_dir}: {e}") from e

    def _mutex_release(self, lock_dir: str) -> None:
        try:
            os.rmdir(lock_dir)
        except OSError:
            pass

    def _read_lease_doc(self, name: str) -> Optional[Dict[str, object]]:
        try:
            with open(self._lease_path(name), "rb") as f:
                doc = json.loads(f.read().decode("utf-8"))
            return doc if isinstance(doc, dict) else None
        except FileNotFoundError:
            return None
        except (OSError, ValueError):
            # A torn lease doc reads as "no lease": the next CAS
            # rewrites it atomically with the preserved token floor.
            return None

    def _write_lease_doc(self, name: str, doc: Dict[str, object]) -> None:
        path = self._lease_path(name)
        tmp = f"{path}.tmp-{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                f.write(json.dumps(doc, sort_keys=True).encode("utf-8"))
                f.flush()
                os.fsync(f.fileno())
                # Torn-write seam: a lease doc killed mid-write must
                # read back as "no lease" with the token floor intact.
                faults.inject_write("store.lease.write", tmp)
            os.replace(tmp, path)
        except OSError as e:
            raise StoreError(f"lease write {name!r} failed: {e}") from e

    def _lease_of(self, doc: Dict[str, object]) -> Lease:
        return Lease(
            name=str(doc["name"]),
            owner=str(doc["owner"]),
            token=int(doc["token"]),  # type: ignore[arg-type]
            expires_unix=float(doc["expires_unix"]),  # type: ignore[arg-type]
        )

    def lease_acquire(
        self, name: str, owner: str, ttl_s: float
    ) -> Optional[Lease]:
        """CAS acquire: succeeds when the lease is free, expired, or a
        takeover target — every success bumps the monotonic fencing
        token, so the previous holder's token is stale the instant this
        returns. ``None`` when a live peer holds it."""
        self._count("lease")
        self._lease_fault("acquire", name)
        mutex = self._mutex_acquire(name)
        try:
            now = self._clock()
            doc = self._read_lease_doc(name)
            token = 0
            if doc is not None:
                held = self._lease_of(doc)
                token = held.token
                if held.owner != owner and not held.expired(now):
                    return None
            new = Lease(
                name=name,
                owner=owner,
                token=token + 1,
                expires_unix=now + ttl_s,
            )
            self._write_lease_doc(
                name,
                {
                    "name": new.name,
                    "owner": new.owner,
                    "token": new.token,
                    "expires_unix": new.expires_unix,
                },
            )
            return new
        finally:
            self._mutex_release(mutex)

    def lease_renew(self, lease: Lease, ttl_s: float) -> Lease:
        """CAS renew: extends the TTL only while ``lease`` is still the
        current (owner, token); raises :class:`FencedWriteError` when
        the token moved on — the holder is a zombie."""
        self._count("lease")
        self._lease_fault("renew", lease.name)
        mutex = self._mutex_acquire(lease.name)
        try:
            doc = self._read_lease_doc(lease.name)
            if doc is None:
                raise FencedWriteError(
                    f"lease {lease.name!r} renew rejected: lease gone"
                )
            held = self._lease_of(doc)
            if held.owner != lease.owner or held.token != lease.token:
                raise FencedWriteError(
                    f"lease {lease.name!r} renew rejected: fencing token "
                    f"{lease.token} is stale (current: {held.token} held "
                    f"by {held.owner!r})"
                )
            new = Lease(
                name=lease.name,
                owner=lease.owner,
                token=lease.token,
                expires_unix=self._clock() + ttl_s,
            )
            self._write_lease_doc(
                lease.name,
                {
                    "name": new.name,
                    "owner": new.owner,
                    "token": new.token,
                    "expires_unix": new.expires_unix,
                },
            )
            return new
        finally:
            self._mutex_release(mutex)

    def lease_release(self, lease: Lease) -> None:
        """CAS release: deletes the doc only while still the current
        (owner, token); a stale releaser is a silent no-op — the lease
        already belongs to someone else."""
        self._count("lease")
        self._lease_fault("release", lease.name)
        mutex = self._mutex_acquire(lease.name)
        try:
            doc = self._read_lease_doc(lease.name)
            if doc is None:
                return
            held = self._lease_of(doc)
            if held.owner == lease.owner and held.token == lease.token:
                try:
                    os.unlink(self._lease_path(lease.name))
                except OSError:
                    pass
        finally:
            self._mutex_release(mutex)

    def lease_get(self, name: str) -> Optional[Lease]:
        self._count("lease")
        doc = self._read_lease_doc(name)
        return None if doc is None else self._lease_of(doc)

    def lease_list(self, prefix: str = "") -> List[Lease]:
        self._count("lease")
        base = os.path.join(self.root, "leases")
        out: List[Lease] = []
        try:
            names = sorted(os.listdir(base))
        except OSError as e:
            raise StoreError(f"lease list failed: {e}") from e
        for fname in names:
            if not fname.endswith(".json") or ".tmp-" in fname:
                continue
            name = fname[: -len(".json")]
            if not name.startswith(prefix):
                continue
            doc = self._read_lease_doc(name)
            if doc is not None:
                out.append(self._lease_of(doc))
        return out

    def now(self) -> float:
        """The store's clock — lease expiry is judged against THIS
        clock, so every replica on the shared directory agrees."""
        return self._clock()

    # -- fencing ---------------------------------------------------------------

    def check_fence(self, lease: Lease) -> None:
        """Reject a stale-token caller loudly. Raises
        :class:`FencedWriteError` when ``lease`` is no longer the
        current (owner, token) or has expired."""
        self._lease_fault("check", lease.name)
        doc = self._read_lease_doc(lease.name)
        if doc is None:
            raise FencedWriteError(
                f"fenced write rejected: lease {lease.name!r} is gone"
            )
        held = self._lease_of(doc)
        if held.owner != lease.owner or held.token != lease.token:
            raise FencedWriteError(
                f"fenced write rejected: token {lease.token} of "
                f"{lease.owner!r} is stale (lease {lease.name!r} now "
                f"token {held.token} held by {held.owner!r})"
            )
        if held.expired(self._clock()):
            raise FencedWriteError(
                f"fenced write rejected: lease {lease.name!r} of "
                f"{lease.owner!r} expired and was never renewed"
            )

    def put_fenced(self, key: str, data: bytes, lease: Lease) -> None:
        """Fence-checked atomic put: the check and the write happen
        under the lease's CAS mutex, so a takeover (which bumps the
        token under the same mutex) strictly orders against it — a
        zombie's write is either rejected here or completed before the
        takeover began, never interleaved."""
        mutex = self._mutex_acquire(lease.name)
        try:
            self.check_fence(lease)
            self.put(key, data)
        finally:
            self._mutex_release(mutex)
