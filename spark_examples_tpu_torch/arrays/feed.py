"""Double-buffered host→device feed: overlap ingest with compute.

A background thread runs the (IO- and Python-bound) block producer — so
densify and bit-pack run in it — and copies each block to the device while
the previous block's product executes; the consumer pops blocks that are
already on their way. The JAX package's ``arrays/feed.py``, on PyTorch.

On the card every block goes through a page-locked host buffer: a ring of
buffers allocated once per block shape (allocating pinned memory per block
costs milliseconds), copied with ``non_blocking=True`` on a side stream,
with an event recorded after each copy. The producer waits for a buffer's
last copy before it overwrites that buffer; the consumer makes its own
stream wait for the copy's event and records the block on its stream, so
the caching allocator does not hand the block's memory out again while the
product still reads it. Nothing is copied from pageable memory:
:data:`PINNED_COPIES` counts the copies made from a page-locked buffer, so
a caller can hold it against the number of blocks. On the CPU the same
thread and queue yield ``torch.from_numpy`` tensors. The consumer's wait
for each block is a ``feed.wait`` span (:data:`~spark_examples_tpu_torch.
utils.tracing.FEED_WAIT`).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterable, Iterator, List, Tuple

import numpy as np
import torch

from spark_examples_tpu_torch import obs
from spark_examples_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from spark_examples_tpu_torch.utils.tracing import FEED_WAIT, INGEST_PUT

__all__ = ["PINNED_COPIES", "device_prefetch"]

_SENTINEL = object()

# Host→device copies the feed has made, each from a buffer checked to be
# page-locked; callers reset it to 0 before a run and read it after.
PINNED_COPIES = 0


class _PinnedStager:
    """Host→device copies through rings of page-locked buffers, one ring
    of ``slots`` buffers per (shape, dtype), on one side stream."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.slots = slots
        self.stream = torch.cuda.Stream(device=device)
        self._rings: Dict[tuple, List[list]] = {}
        self._next: Dict[tuple, int] = {}

    def stage(self, arr: np.ndarray) -> Tuple[torch.Tensor, torch.cuda.Event]:
        global PINNED_COPIES
        src = torch.from_numpy(arr)
        key = (tuple(src.shape), src.dtype)
        ring = self._rings.get(key)
        if ring is None:
            ring = self._rings[key] = [
                [torch.empty(src.shape, dtype=src.dtype, pin_memory=True),
                 None]
                for _ in range(self.slots)
            ]
            if not all(buf.is_pinned() for buf, _ in ring):
                raise RuntimeError("could not page-lock the feed's buffers")
            self._next[key] = 0
        slot = ring[self._next[key]]
        self._next[key] = (self._next[key] + 1) % self.slots
        buf, last_copy = slot
        if last_copy is not None:
            last_copy.synchronize()  # the buffer's previous copy is done
        buf.copy_(src)
        with torch.cuda.stream(self.stream):
            block = buf.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        slot[1] = done
        PINNED_COPIES += 1
        return block, done


def device_prefetch(
    blocks: Iterable[np.ndarray],
    depth: int = 2,
    device=DEFAULT_DEVICE,
) -> Iterator[torch.Tensor]:
    """Yield ``blocks`` as tensors on ``device``, staged ``depth`` ahead.

    The producer thread re-raises its exception in the consumer (ingest
    failures must surface, not hang), after every block it staged before
    the failure. A consumer that abandons the generator releases the
    producer: it stops drawing blocks.
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    stager = _PinnedStager(dev, depth + 1) if dev.type == "cuda" else None
    q: queue.Queue = queue.Queue(maxsize=depth)
    err: list = []
    stop = threading.Event()

    def _put(item) -> bool:
        # Bounded put that gives up when the consumer cancelled — a
        # blocked q.put with no reader would leak the thread, the staged
        # blocks, and the open ingest source.
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce() -> None:
        try:
            if stager is not None:
                torch.cuda.set_device(dev)
            for block in blocks:
                if stop.is_set():
                    return
                arr = np.ascontiguousarray(block)
                with obs.span(INGEST_PUT, bytes=int(arr.nbytes)):
                    staged = (
                        stager.stage(arr)
                        if stager is not None
                        else (torch.from_numpy(arr), None)
                    )
                if not _put(staged):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            err.append(e)
        finally:
            _put(_SENTINEL)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        for block, copied in obs.waited(iter(q.get, _SENTINEL), FEED_WAIT):
            if copied is not None:
                stream = torch.cuda.current_stream(dev)
                stream.wait_event(copied)
                block.record_stream(stream)
            yield block
        if err:
            raise err[0]
    finally:
        # Consumer abandoned the generator (close/GeneratorExit or an
        # exception in its loop body): release the producer.
        stop.set()
