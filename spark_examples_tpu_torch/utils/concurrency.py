"""Bounded parallel maps for host ingest.

Shard extraction is independent per shard and deterministic, so it can run
on worker threads. :func:`ordered_parallel_map` hands results on in
manifest order: block composition and accumulation order — and so G —
never depend on the worker count. :func:`completion_parallel_map` hands
them on as they finish, for consumers whose result does not depend on
arrival order (the integer-exact Gramian). Both are the JAX package's,
without its speculative re-execution of stragglers (ROADMAP.md lists that
with the resilience layer).
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Sequence, TypeVar

__all__ = ["completion_parallel_map", "ordered_parallel_map"]

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


def completion_parallel_map(
    fn: Callable[[T], R],
    items: Sequence[T] | Iterable[T],
    workers: int,
    lookahead: int = 2,
) -> Iterator[R]:
    """Yield ``fn(item)`` in COMPLETION order — whichever extraction
    finishes first flows downstream first — with the same bounded
    window as :func:`ordered_parallel_map` (≤ ``workers + lookahead``
    in flight). ``workers <= 1`` degrades to the serial loop.

    The head-of-line blocking the ordered map accepts to keep results
    bit-identical is pure wasted wall-clock for consumers whose
    accumulation is ORDER-INDEPENDENT: the packed Gramian accumulates
    exact integer co-occurrence counts, so ``G`` is bit-identical under
    any shard arrival order (pinned by test) — a slow remote shard then
    never stalls the device behind it. Use the ordered map whenever the
    consumer's output depends on element order (block packing for
    checkpoint digests, printed records).

    NO INTER-PHASE BARRIER: ``items`` is pulled by a dedicated feeder
    thread, so a completed result reaches the consumer the moment it
    finishes even while the items iterator itself is BLOCKED producing
    the next element.

    A worker exception surfaces at the point it is DRAINED (not at the
    failed item's submission position); an items-iterator exception
    surfaces after the results already in flight; remaining in-flight
    work is abandoned to the executor's shutdown, like the ordered map.
    """
    if workers <= 1:
        for item in items:
            yield fn(item)
        return

    window = workers + max(0, lookahead)
    done_q: queue.Queue = queue.Queue()
    slots = threading.Semaphore(window)  # bounds results in flight
    stop = threading.Event()
    _END = object()
    state = {"submitted": 0}
    pending: set = set()
    plock = threading.Lock()

    with ThreadPoolExecutor(max_workers=workers) as pool:

        def feed() -> None:
            try:
                for item in items:
                    slots.acquire()
                    if stop.is_set():
                        return
                    fut = pool.submit(fn, item)
                    state["submitted"] += 1
                    with plock:
                        pending.add(fut)

                    def _done(f) -> None:
                        with plock:
                            pending.discard(f)
                        done_q.put(f)

                    fut.add_done_callback(_done)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                done_q.put(e)
            finally:
                done_q.put(_END)

        feeder = threading.Thread(
            target=feed, name="completion-map-feed", daemon=True
        )
        feeder.start()
        end_seen = False
        yielded = 0
        try:
            while not (end_seen and yielded == state["submitted"]):
                got = done_q.get()
                if got is _END:
                    end_seen = True
                    continue
                if isinstance(got, Future):
                    slots.release()
                    yielded += 1
                    yield got.result()
                else:
                    raise got  # the items iterator itself failed
        finally:
            stop.set()
            slots.release()  # unblock a feeder parked on a full window
            with plock:
                leftover = list(pending)
            # Cancel OUTSIDE plock: cancelling a not-yet-started future
            # runs its done callbacks inline on this thread, and _done
            # re-acquires plock — holding it here self-deadlocks.
            for fut in leftover:
                fut.cancel()
