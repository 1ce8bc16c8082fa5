"""Durable shared state for the replicated serving plane.

The serving tier's crash safety (PR 6) assumed ONE process owning one
journal directory. The replica plane needs the same durability
*shared*: N ``serve-cohort`` processes over one store, any of which can
die at any instant, with job ownership handed around by leases instead
of by being the only process alive. This package is that seam:

- :class:`DurableStore` — the abstract contract: atomic checksummed
  blobs (``put`` is tmp→fsync→rename, ``get`` verifies the embedded
  digest and raises :class:`StoreCorruptError` loudly on mismatch),
  prefix listing, and compare-and-swap **lease** operations carrying
  monotonic fencing tokens;
- :class:`LocalDirStore` — the local-shared-directory backend (an NFS
  mount, a shared volume, or a tmpdir in tests). ROADMAP item 4's
  GCS/S3 backend plugs into the same contract later;
- the fencing-token discipline: every successful lease acquisition
  (first grab, re-grab after expiry, takeover from a dead peer) bumps a
  token that only ever grows. A replica that lost its lease holds a
  stale token, and every fenced write (:meth:`DurableStore.check_fence`
  before journal/result/cache writes) is rejected with
  :class:`FencedWriteError` — loudly, never torn-merged.

Chaos seams (``store.read`` / ``store.write`` / ``store.lease``) ride
the resilience FaultPlan like every other durability surface; see
``resilience/faults.py`` for the site table.
"""

from spark_examples_tpu_torch.store.local import (
    Lease,
    DurableStore,
    FencedWriteError,
    LocalDirStore,
    StoreCorruptError,
    StoreError,
)

__all__ = [
    "DurableStore",
    "FencedWriteError",
    "Lease",
    "LocalDirStore",
    "StoreCorruptError",
    "StoreError",
]
