"""Checkpoint/resume: shard-group snapshots of the Gramian accumulator.

The reference's resume story is coarse: ``--input-path`` re-reads a saved
``objectFile`` snapshot of the whole ingest output
(``VariantsCommon.scala:52-55``) — all-or-nothing, at ingest granularity.
Here resume is *incremental*: the shard manifest is deterministic
(:func:`spark_examples_tpu_torch.genomics.shards.manifest_digest`), ingest
is idempotent per shard (STRICT boundaries), and the Gramian is an additive
accumulator — so a snapshot of ``(G, shards_done)`` keyed by the manifest
digest resumes the pipeline mid-ingest, skipping completed shards entirely.

Snapshots are a single ``.npz`` (G plus cursor plus digest in one file)
committed with tmp + rename: one atomic filesystem operation, so a crash
can never leave the cursor and the accumulator disagreeing. The file is
the JAX package's, key for key and dtype for dtype (``g`` float32,
``shards_done`` int64, ``run_digest`` bytes, ``gramian_snapshot.npz``), so
each package resumes the other's snapshot. It is written uncompressed
(``np.savez``) where the JAX package deflates (``np.savez_compressed``):
``np.load`` reads either, and a stored write keeps the host's deflate of
G off the ingest path.

The digest must cover everything that determines G's *content*, not just
the shard manifest: the caller passes a run digest combining the manifest
with the variantset id and filter config (see
``VariantsPcaDriver.get_similarity_matrix_checkpointed``) so a snapshot
from a different dataset or ``--min-allele-frequency`` is never resumed.

The sharded snapshot helpers (each process's tiles of a mesh-sharded G)
are here for the mesh layer's checkpointed routes; the meshless driver
uses :func:`save_snapshot` and :func:`load_snapshot` only.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from typing import Optional

import numpy as np

__all__ = [
    "GramianCheckpoint",
    "save_snapshot",
    "load_snapshot",
    "save_sharded_snapshot",
    "load_sharded_snapshot",
    "index_key",
]

_SNAP = "gramian_snapshot.npz"
_SHARDED_SNAP = "gramian_sharded_snapshot.npz"


def _warn_unreadable(path: str, exc: BaseException) -> None:
    import sys

    print(
        f"WARNING: unreadable Gramian snapshot {path} "
        f"({type(exc).__name__}: {exc}); discarding — ingest restarts "
        "from the last readable state.",
        file=sys.stderr,
    )
    from spark_examples_tpu_torch import obs

    obs.instant(
        "checkpoint_snapshot_unreadable", scope="p", path=path
    )


@dataclass(frozen=True)
class GramianCheckpoint:
    g: np.ndarray
    shards_done: int
    run_digest: str
    n_samples: int


def _apply_write_fault(site: str, path: str) -> None:
    """Honor a fault-plan rule at a checkpoint write seam.

    ``torn`` truncates the just-committed file to half its bytes —
    simulating a torn write on a filesystem without atomic rename
    (exactly what the tolerant loaders must survive); ``error``/
    ``stall`` act as everywhere else. No-op without an active plan.
    """
    from spark_examples_tpu_torch.resilience import faults

    rule = faults.take(site, key=path)
    if rule is None:
        return
    if rule.kind == "torn":
        try:
            size = os.path.getsize(path)
            with open(path, "r+b") as f:
                f.truncate(max(1, size // 2))
        except OSError:
            pass
        return
    if rule.kind == "stall":
        import time

        time.sleep(rule.stall_s)
        return
    raise faults.InjectedFault(site, rule.kind, path, rule.message)


def _host_array(g) -> np.ndarray:
    """A snapshot's G as a host array: a tensor is copied off its device
    first (the JAX package's ``np.asarray`` of a device array), a tile
    grid gathered."""
    import torch

    if hasattr(g, "tiles"):
        g = g.full()
    if isinstance(g, torch.Tensor):
        return g.detach().cpu().numpy()
    return np.asarray(g)


def save_snapshot(
    directory: str,
    g,
    shards_done: int,
    run_digest: str,
) -> None:
    """Persist the accumulator state in one atomic rename."""
    os.makedirs(directory, exist_ok=True)
    g = _host_array(g)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(
            f,
            g=g,
            shards_done=np.int64(shards_done),
            run_digest=np.bytes_(run_digest.encode()),
        )
    path = os.path.join(directory, _SNAP)
    os.replace(tmp, path)
    _apply_write_fault("checkpoint.snapshot_write", path)


def _encode_index(index, shape) -> np.ndarray:
    """Shard index (tuple of slices) → (ndim, 2) [start, stop) array."""
    rows = []
    for sl, dim in zip(index, shape):
        rows.append(
            (
                0 if sl.start is None else int(sl.start),
                dim if sl.stop is None else int(sl.stop),
            )
        )
    return np.asarray(rows, np.int64)


def index_key(index, shape) -> tuple:
    """Hashable normalized form of a shard index, for lookup tables."""
    return tuple(map(tuple, _encode_index(index, shape)))


def save_sharded_snapshot(
    directory: str, tiles, n: int, shards_done: int, run_digest: str
) -> None:
    """Snapshot THIS process's tiles of a sample-sharded G.

    ``tiles`` is a sequence of ``(index, tile)`` pairs: ``index`` a tuple
    of slices into the global ``(n, n)`` G, ``tile`` the host array (or
    tensor) it holds. Each process persists only the tiles it already
    holds, tagged with their global [start, stop) indices; together the
    per-process snapshots tile the full G. Same atomic tmp+rename contract
    as :func:`save_snapshot`, and the JAX package's keys (``n``,
    ``data_<i>``, ``index_<i>``).
    """
    os.makedirs(directory, exist_ok=True)
    arrays = {
        "shards_done": np.int64(shards_done),
        "run_digest": np.bytes_(run_digest.encode()),
        "n": np.int64(n),
    }
    for i, (index, tile) in enumerate(tiles):
        arrays[f"data_{i}"] = _host_array(tile)
        arrays[f"index_{i}"] = _encode_index(index, (n, n))
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, os.path.join(directory, _SHARDED_SNAP))


def load_sharded_snapshot(
    directory: str, run_digest: str, n_samples: int
) -> Optional[tuple]:
    """→ ``(shards_done, {index_key: tile})`` or None when stale/absent.

    The caller verifies the stored tile set matches the CURRENT
    sharding's indices before using it (a changed mesh or process grid
    also changes the run digest, but the tile-set check keeps the loader
    safe on its own).
    """
    snap_path = os.path.join(directory, _SHARDED_SNAP)
    if not os.path.exists(snap_path):
        return None
    tiles = {}
    try:
        with np.load(snap_path) as z:
            if (
                bytes(z["run_digest"]).decode() != run_digest
                or int(z["n"]) != n_samples
            ):
                return None
            shards_done = int(z["shards_done"])
            i = 0
            while f"data_{i}" in z:
                tiles[tuple(map(tuple, z[f"index_{i}"]))] = z[f"data_{i}"]
                i += 1
    except Exception as e:  # noqa: BLE001 — any torn-file shape
        _warn_unreadable(snap_path, e)
        return None
    return shards_done, tiles


def load_snapshot(
    directory: str, run_digest: str, n_samples: int
) -> Optional[GramianCheckpoint]:
    """Load a snapshot if it matches the run digest; stale/absent → None.

    A digest mismatch means the manifest, dataset, or filter config changed
    — the snapshot is silently ignored rather than corrupting the run.
    """
    snap_path = os.path.join(directory, _SNAP)
    if not os.path.exists(snap_path):
        return None
    try:
        with np.load(snap_path) as z:
            g = z["g"]
            shards_done = int(z["shards_done"])
            stored_digest = bytes(z["run_digest"]).decode()
    except Exception as e:  # noqa: BLE001 — any torn-file shape
        # The atomic-rename protocol cannot produce a torn snapshot, but
        # a non-atomic filesystem (or a crash inside one) can. Resume
        # must degrade to re-ingesting, never die on its own safety net.
        _warn_unreadable(snap_path, e)
        return None
    if stored_digest != run_digest or g.shape[0] != n_samples:
        return None
    return GramianCheckpoint(
        g=g,
        shards_done=shards_done,
        run_digest=run_digest,
        n_samples=n_samples,
    )
