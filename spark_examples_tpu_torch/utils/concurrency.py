"""Order-preserving parallel map for host ingest.

Shard extraction is independent per shard and deterministic, so it can run
on worker threads while results are consumed in manifest order: block
composition and accumulation order — and so G — never depend on the worker
count. The JAX package's ``ordered_parallel_map`` without its speculative
re-execution of stragglers (ROADMAP.md lists that with the resilience
layer).
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, TypeVar

__all__ = ["ordered_parallel_map"]

T = TypeVar("T")
R = TypeVar("R")


def ordered_parallel_map(
    fn: Callable[[T], R],
    items: Iterable[T],
    workers: int,
    lookahead: int = 2,
) -> Iterator[R]:
    """Yield ``fn(item)`` in input order, computing up to ``workers``
    items concurrently with at most ``workers + lookahead`` in flight
    (bounding memory to a few shards' worth regardless of manifest
    length). ``workers <= 1`` is the plain serial loop — no threads.

    A worker exception surfaces at the position of ITS item, as the serial
    loop would raise it, after which iteration stops; work still queued is
    cancelled.
    """
    if workers <= 1:
        for item in items:
            yield fn(item)
        return
    window = workers + max(0, lookahead)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        pending: collections.deque = collections.deque()
        try:
            for item in items:
                pending.append(pool.submit(fn, item))
                if len(pending) >= window:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()
        finally:
            for future in pending:
                future.cancel()
