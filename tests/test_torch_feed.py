"""The port's double-buffered feed (``arrays/feed.py``) on the CPU.

The six ``device_prefetch`` behaviours the JAX package pins in
``tests/test_harness.py`` — order and error, abandoned consumer, exception
and cancel at depth > 2, cancel while the producer is blocked, exception
with frames in flight — run against the port's feed with
``device="cpu"``, where it yields ``torch.from_numpy`` tensors through the
same producer thread and bounded queue it uses on the card. Each block is
compared with what the JAX package's feed yields for the same input.
"""

import threading
import time

import numpy as np
import pytest
import torch

from spark_examples_tpu.arrays.feed import device_prefetch as jax_prefetch
from spark_examples_tpu_torch.arrays.feed import device_prefetch


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cpu_prefetch(blocks, depth=2):
    return device_prefetch(blocks, depth=depth, device="cpu")


def test_order_and_error():
    blocks = [np.full((4, 4), i, np.int8) for i in range(7)]
    got = list(_cpu_prefetch(iter(blocks)))
    want = list(jax_prefetch(iter(blocks)))
    assert [int(b[0, 0]) for b in got] == list(range(7))
    for a, b in zip(got, want):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    def failing():
        yield np.zeros((2, 2), np.int8)
        raise IOError("ingest died")

    it = _cpu_prefetch(failing())
    next(it)
    with pytest.raises(IOError, match="ingest died"):
        list(it)


def test_abandoned_consumer_releases_producer():
    started = threading.Event()
    n_produced = []

    def blocks():
        for i in range(100):
            started.set()
            n_produced.append(i)
            yield np.zeros((64, 64), np.int8)

    it = _cpu_prefetch(blocks(), depth=2)
    next(it)
    assert started.wait(5)
    it.close()  # consumer abandons mid-stream
    time.sleep(0.3)
    produced_after_close = len(n_produced)
    time.sleep(0.5)
    # Producer must have stopped: no further blocks drawn from the source.
    assert len(n_produced) <= produced_after_close + 1
    assert len(n_produced) < 100


def test_producer_exception_at_depth_gt_2():
    """With depth > 2 several good blocks are queued ahead of the error;
    all of them must still be delivered first."""

    def failing():
        for i in range(5):
            yield np.full((3, 3), i, np.int8)
        raise IOError("builder worker died")

    got = []
    with pytest.raises(IOError, match="builder worker died"):
        for b in _cpu_prefetch(failing(), depth=4):
            got.append(int(b[0, 0]))
    assert got == [0, 1, 2, 3, 4]  # nothing staged was dropped


def test_consumer_cancel_at_depth_gt_2():
    """Abandoning the consumer with a deep queue must stop the producer
    promptly, well short of the stream."""
    started = threading.Event()
    n_produced = []

    def blocks():
        for i in range(1000):
            started.set()
            n_produced.append(i)
            yield np.zeros((32, 32), np.int8)

    it = _cpu_prefetch(blocks(), depth=5)
    next(it)
    assert started.wait(5)
    it.close()
    deadline = time.time() + 5
    stable_at = None
    while time.time() < deadline:
        n = len(n_produced)
        time.sleep(0.3)
        if len(n_produced) == n:
            stable_at = n
            break
    assert stable_at is not None and stable_at < 1000


def test_cancel_while_producer_blocked_in_fetch():
    """close() returns promptly although the producer is parked inside a
    slow fetch; once the fetch returns the producer stops."""
    in_fetch = threading.Event()
    release = threading.Event()
    produced = []

    def frames():
        produced.append(0)
        yield np.zeros((8, 8), np.int8)
        in_fetch.set()
        release.wait(30)  # bounded so a faulty feed cannot hang the suite
        produced.append(1)
        yield np.zeros((8, 8), np.int8)
        produced.append(2)
        yield np.zeros((8, 8), np.int8)

    it = _cpu_prefetch(frames(), depth=2)
    next(it)
    assert in_fetch.wait(5)
    t0 = time.monotonic()
    it.close()
    assert time.monotonic() - t0 < 1.0  # close never waits on the fetch
    release.set()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and len(produced) < 2:
        time.sleep(0.05)
    time.sleep(0.3)
    assert len(produced) <= 2  # frame 3 is never drawn


def test_producer_exception_with_frames_in_flight():
    """A producer that dies before the consumer takes a frame: every staged
    frame is delivered, in order, and then the failure surfaces."""

    def failing():
        for i in range(3):
            yield np.full((4, 4), i, np.int8)
        raise IOError("wire fetch died mid-stream")

    it = _cpu_prefetch(failing(), depth=3)
    time.sleep(0.5)
    got = []
    with pytest.raises(IOError, match="wire fetch died mid-stream"):
        for b in it:
            got.append(int(b[0, 0]))
    assert got == [0, 1, 2]


def test_blocks_are_produced_on_the_feed_thread():
    """The generator — densify and pack, on the driver's path — runs in
    the producer thread, not in the consumer's."""
    where = []

    def blocks():
        for i in range(3):
            where.append(threading.current_thread())
            yield np.full((2, 2), i, np.uint8)

    out = list(_cpu_prefetch(blocks()))
    assert [int(b[0, 0]) for b in out] == [0, 1, 2]
    assert out[0].dtype == torch.uint8
    assert where and all(t is not threading.current_thread() for t in where)


def test_non_contiguous_blocks_are_copied_contiguous():
    x = np.arange(60, dtype=np.uint8).reshape(6, 10)
    piece = x[:, 2:7]
    (got,) = list(_cpu_prefetch(iter([piece])))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), piece)


def test_refuses_without_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(device_prefetch(iter([np.zeros((2, 2), np.int8)])))
