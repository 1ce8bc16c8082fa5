"""Multi-process coordination — the ``torch.distributed`` layer.

The reference's driver⇄executor control plane (Spark master, task
scheduling, accumulator merging) maps onto one process group: one process
per card (``torchrun --nproc-per-node``, or the ``MASTER_ADDR`` /
``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK`` variables it
sets), rank 0 as the "driver" for emission, and collectives for anything
numeric. The data-parallel regime: each rank ingests ``shards[r::P]`` of
the manifest into its own partial G, and :func:`allreduce_gramian` sums the
partials; host counters merge through :func:`allreduce_host_stats`.

The backend follows the run's device: ``nccl`` for the card (rank r on
``cuda:LOCAL_RANK``), ``gloo`` for ``--device cpu``. A single process (no
variables) is the no-op path throughout.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from spark_examples_tpu_torch import obs
from spark_examples_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from spark_examples_tpu_torch.utils.stats import COUNTER_FIELDS, IoStats

__all__ = [
    "allreduce_gramian",
    "allreduce_host_stats",
    "initialize_from_env",
    "is_coordinator",
    "process_count",
    "process_index",
]


def _group_live() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def initialize_from_env(device=DEFAULT_DEVICE) -> bool:
    """Join the process group when the launcher variables are set.

    Reads ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
    ``LOCAL_RANK`` (defaulting to ``RANK``). Without ``MASTER_ADDR`` it
    does nothing and returns False. ``device`` picks the backend: the
    card's ``nccl`` (and ``cuda:LOCAL_RANK`` becomes this process's
    current device) or the CPU's ``gloo``. Returns True once the group
    is up; a second call is a no-op.
    """
    env = os.environ
    if not env.get("MASTER_ADDR"):
        return False
    if _group_live():
        return True
    import torch.distributed as dist

    world = int(env["WORLD_SIZE"])
    rank = int(env["RANK"])
    local = int(env.get("LOCAL_RANK", rank))
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(local)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(
        backend,
        init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
        world_size=world,
        rank=rank,
    )
    return True


def process_index() -> int:
    """This process's rank (0 without a group)."""
    if not _group_live():
        return 0
    import torch.distributed as dist

    return dist.get_rank()


def process_count() -> int:
    """The world size (1 without a group)."""
    if not _group_live():
        return 1
    import torch.distributed as dist

    return dist.get_world_size()


def is_coordinator() -> bool:
    """Rank 0 plays the reference's "driver" role (emission, metadata)."""
    return process_index() == 0


def _collective_device() -> torch.device:
    """Where the group's collectives take their tensors."""
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _allgather_sum(part: torch.Tensor) -> torch.Tensor:
    """Gather ``part`` from every rank and sum in rank order (the JAX
    package's ``process_allgather`` then ``sum(axis=0)``)."""
    import torch.distributed as dist

    part = part.to(_collective_device()).contiguous()
    parts = [torch.empty_like(part) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, part)
    return torch.stack(parts).sum(dim=0)


def allreduce_gramian(g_local, chunk_bytes: int = 64 << 20):
    """Sum per-rank partial Gramians into the global G.

    The data-parallel reduction: each rank ingests a disjoint slice of the
    shard manifest and accumulates its own partial ``G_r = X_r @ X_r.T``;
    the global Gramian is ``Σ_r G_r`` (the ``reduceByKey`` across
    executors of VariantsPca.scala:190). ``g_local`` is a 2-D tensor or
    array; the result has its kind, dtype and device. Identity on one
    process.

    Rows reduce in chunks, so the transient is ``world × chunk_bytes``
    instead of ``world`` copies of G. A tile grid
    (:class:`~spark_examples_tpu_torch.parallel.sharded.ShardedGramian`)
    is refused: gather it with ``.full()`` first, so that the copy is
    written where it happens.
    """
    if hasattr(g_local, "tiles"):
        raise ValueError(
            "allreduce_gramian merges one process's whole partial "
            "Gramian; this is a tile grid — gather it with .full() "
            "before merging"
        )
    if process_count() == 1:
        return g_local
    as_numpy = not isinstance(g_local, torch.Tensor)
    g = torch.as_tensor(np.asarray(g_local)) if as_numpy else g_local
    n = g.shape[0]
    row_bytes = math.prod(g.shape[1:]) * g.element_size()
    rows = max(1, chunk_bytes // max(1, row_bytes))
    out = torch.empty_like(g)
    with obs.span("allreduce_gramian", n=int(n), row_chunk=int(rows)):
        for r0 in range(0, n, rows):
            out[r0:r0 + rows] = _allgather_sum(g[r0:r0 + rows]).to(g.device)
    return out.numpy() if as_numpy else out


def allreduce_host_stats(stats: IoStats) -> IoStats:
    """Merge per-rank IoStats into global totals (the accumulator merge
    the Spark driver did). Identity on one process; otherwise an int64
    all-gather of the counter vector, returned as an untracked IoStats
    (its counts are copies of tracked instances)."""
    if process_count() == 1:
        return stats
    vec = torch.tensor(stats.as_vector(), dtype=torch.int64)
    with obs.span("allreduce_host_stats"):
        total = _allgather_sum(vec).cpu().tolist()
    merged = IoStats.untracked()
    merged.add(**dict(zip(COUNTER_FIELDS, (int(t) for t in total))))
    return merged
