"""Bounded parallel maps for host ingest.

Shard extraction is independent per shard and deterministic, so it can run
on worker threads. :func:`ordered_parallel_map` hands results on in
manifest order: block composition and accumulation order — and so G —
never depend on the worker count. :func:`completion_parallel_map` hands
them on as they finish, for consumers whose result does not depend on
arrival order (the integer-exact Gramian). Both are the JAX package's,
the ordered map with its speculative re-execution of stragglers
(``--speculative-ingest``).
"""

from __future__ import annotations

import collections
import queue
import statistics
import threading
import time
from concurrent.futures import (
    FIRST_COMPLETED,
    Future,
    ThreadPoolExecutor,
    wait,
)
from typing import Callable, Iterable, Iterator, Optional, Sequence, TypeVar

__all__ = ["completion_parallel_map", "ordered_parallel_map"]

T = TypeVar("T")
R = TypeVar("R")

# Spark speculates a task at 1.5x the stage median once a quantile of
# tasks completed; extraction durations here are far noisier than Spark's
# cluster tasks (sidecar slices against HTTP round-trips), so the
# multiplier is more conservative and the floor avoids speculating
# millisecond shards on scheduler jitter.
SPECULATION_MULTIPLIER = 4.0
SPECULATION_MIN_COMPLETED = 6
SPECULATION_FLOOR_SECONDS = 0.05


class _Attempt:
    """One submitted extraction: its future plus the in-thread start time
    (None until a pool thread actually begins — queue time must not count
    toward straggler detection)."""

    __slots__ = ("future", "started")

    def __init__(self):
        self.future = None
        self.started = None


def ordered_parallel_map(
    fn: Callable[[T], R],
    items: Iterable[T],
    workers: int,
    lookahead: int = 2,
    speculate: bool = False,
    on_speculate: Optional[Callable[[T], None]] = None,
) -> Iterator[R]:
    """Yield ``fn(item)`` in input order, computing up to ``workers``
    items concurrently with at most ``workers + lookahead`` in flight
    (bounding memory to a few shards' worth regardless of manifest
    length). ``workers <= 1`` is the plain serial loop — no threads, and
    ``speculate`` is ignored.

    A worker exception surfaces at the position of ITS item, as the serial
    loop would raise it, after which iteration stops; work still queued is
    cancelled and the pools are joined before the exception leaves.

    ``speculate=True`` adds Spark-style speculative execution: when the
    head-of-line item — the only one blocking output — has been RUNNING
    longer than ``SPECULATION_MULTIPLIER`` × the median completed duration
    (with at least ``SPECULATION_MIN_COMPLETED`` samples, and never
    sooner than ``SPECULATION_FLOOR_SECONDS``), a duplicate attempt
    launches on a spare thread and whichever attempt finishes first wins.
    Extraction is idempotent and deterministic, so both attempts produce
    identical results. A failed attempt defers to the survivor, and the
    failure surfaces only if BOTH attempts fail. ``on_speculate(item)``
    fires at each launch.
    """
    if workers <= 1:
        for item in items:
            yield fn(item)
        return

    durations: list = []

    def submit(pool, item) -> _Attempt:
        att = _Attempt()

        def run():
            att.started = time.monotonic()
            out = fn(item)
            durations.append(time.monotonic() - att.started)
            return out

        att.future = pool.submit(run)
        return att

    def drain_head(head_item, head: _Attempt, spare_pool) -> R:
        """Block for the head-of-line result, speculating if it lags."""
        attempts = [head]
        while True:
            # Check EVERY attempt for a winner at the top of the loop: an
            # attempt can complete between a wait() timeout (where a
            # speculation launches) and the next wait.
            for a in attempts:
                if a.future.done() and a.future.exception() is None:
                    return a.future.result()
            # Wait ONLY on unfinished attempts: a failed future left in the
            # wait set would make wait() return at once, a busy spin for
            # as long as the survivor runs.
            live = [a for a in attempts if not a.future.done()]
            if not live:
                # Every attempt failed: the ORIGINAL's error surfaces.
                return attempts[0].future.result()
            deadline = None
            timeout = None
            if speculate and len(attempts) == 1:
                if (
                    len(durations) >= SPECULATION_MIN_COMPLETED
                    and head.started is not None
                ):
                    threshold = max(
                        SPECULATION_MULTIPLIER
                        * statistics.median(tuple(durations)),
                        SPECULATION_FLOOR_SECONDS,
                    )
                    deadline = head.started + threshold
                    timeout = max(0.0, deadline - time.monotonic())
                else:
                    # Not yet eligible; re-check as siblings complete.
                    timeout = 0.1
            wait(
                {a.future for a in live},
                timeout=timeout,
                return_when=FIRST_COMPLETED,
            )
            if (
                deadline is not None
                and time.monotonic() >= deadline
                and len(attempts) == 1
                and not head.future.done()
            ):
                # The deadline passed with the head still running.
                if on_speculate is not None:
                    on_speculate(head_item)
                attempts.append(submit(spare_pool, head_item))

    window = workers + max(0, lookahead)
    # The spare pool lets a speculative attempt start at once instead of
    # queueing behind the main pool's backlog. It is sized like the main
    # pool: an abandoned duplicate whose original won runs on until its IO
    # completes, and one such thread must not queue every later
    # speculation behind it. Leaving the ``with`` joins every attempt.
    with ThreadPoolExecutor(max_workers=workers) as pool, ThreadPoolExecutor(
        max_workers=workers, thread_name_prefix="speculate"
    ) as spare:
        pending: collections.deque = collections.deque()
        try:
            for item in items:
                pending.append((item, submit(pool, item)))
                if len(pending) >= window:
                    head_item, head = pending.popleft()
                    yield drain_head(head_item, head, spare)
            while pending:
                head_item, head = pending.popleft()
                yield drain_head(head_item, head, spare)
        finally:
            for _, att in pending:
                att.future.cancel()


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
