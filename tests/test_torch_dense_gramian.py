"""The port's dense-blockwise Gramian against the JAX package's.

Every Gramian function is integer-exact, so each is held bit-identical to
its JAX counterpart on the same numpy-seeded 0/1 blocks, at sample counts
on both sides of the int8 product's CUDA shape rule (more than 16 rows, a
multiple of 8): N ∈ {5, 12, 13, 17, 24, 40}. The port pads every int8
operand to that rule on both devices, so these CPU runs take the padded
shapes the card takes. Also here: the fused functions (coordinates within
1e-4, eigenvalues to rtol 1e-4 — the bar of the JAX package's
``tests/test_ops_pcoa.py::TestFusedPcoa``), the block builders
(byte-identical) and the ordered worker map.
"""

import importlib
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_examples_tpu.arrays import blocks as jax_blocks
from spark_examples_tpu.ops import fused as jax_fused
from spark_examples_tpu_torch.arrays import blocks
from spark_examples_tpu_torch.ops import fused, gramian
from spark_examples_tpu_torch.utils.concurrency import ordered_parallel_map

# ops/__init__.py re-exports a function named ``gramian``: load the module.
jax_gramian = importlib.import_module("spark_examples_tpu.ops.gramian")

SAMPLE_COUNTS = (5, 12, 13, 17, 24, 40)
FEEDS = {
    "unpacked": dict(packed=False),
    "packed": dict(packed=True),
    "prepacked": dict(packed=True, prepacked=True),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _indicators(n, v, seed=0, density=0.3):
    rng = np.random.default_rng(seed)
    return (rng.random((n, v)) < density).astype(np.int8)


def _g0(n, seed=1):
    """A nonzero integer accumulator, so in-place adds are checked too."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 50, size=(n, n)).astype(np.float32)


def _blocks(n, seed=0):
    """Three blocks of 64 variants and a ragged 37-variant tail."""
    x = _indicators(n, 64 * 3 + 37, seed)
    return [x[:, i : i + 64] for i in range(0, x.shape[1], 64)]


@pytest.mark.parametrize("n", range(1, 65))
def test_int8_operands_meet_the_cuda_shape_rule(n):
    rows = gramian.int_mm_rows(n)
    assert rows > 16 and rows % 8 == 0 and rows >= n
    assert rows == max(24, -(-n // 8) * 8)  # no more padding than needed
    for v in (0, 1, 7, 8, 13, 64):
        x = torch.from_numpy(_indicators(n, v, seed=n))
        op = gramian._int_mm_operand(x)
        assert op.dtype == torch.int8 and op.is_contiguous()
        assert op.shape[0] == rows
        assert op.shape[1] % 8 == 0 and op.shape[1] >= max(v, 1)
        assert torch.equal(op[:n, :v], x)
        assert int(op.sum()) == int(x.sum())  # the padding is zeros


@pytest.mark.parametrize("n", SAMPLE_COUNTS)
@pytest.mark.parametrize("dtype", [np.int8, np.float32])
def test_gramian_matches(n, dtype):
    x = _indicators(n, 77, seed=n).astype(dtype)
    got = gramian.gramian(x, device="cpu")
    want = np.asarray(jax_gramian.gramian(jnp.asarray(x)))
    assert got.dtype == torch.float32 and got.shape == (n, n)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", SAMPLE_COUNTS)
def test_cross_product_pair_matches(n):
    a = _indicators(n, 45, seed=n)
    b = _indicators(n + 3, 45, seed=n + 100)
    got = gramian.mxu_cross_product_pair(
        torch.from_numpy(a), torch.from_numpy(b), torch.float32
    )
    want = jax_gramian.mxu_cross_product_pair(
        jnp.asarray(a), jnp.asarray(b), jnp.float32
    )
    assert got.shape == (n, n + 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    f32 = gramian.mxu_cross_product_pair(
        torch.from_numpy(a), torch.from_numpy(b), torch.float32,
        torch.float32,
    )
    np.testing.assert_array_equal(f32.numpy(), np.asarray(want))


def test_cross_product_refuses_other_compute_dtypes():
    x = torch.from_numpy(_indicators(8, 16))
    with pytest.raises(ValueError, match="compute_dtype"):
        gramian.mxu_cross_product(x, torch.float32, torch.bfloat16)


@pytest.mark.parametrize("n", SAMPLE_COUNTS)
def test_gramian_accumulate_matches(n):
    x = _indicators(n, 50, seed=n)
    g = torch.from_numpy(_g0(n))
    out = gramian.gramian_accumulate(g, x)
    want = jax_gramian.gramian_accumulate(jnp.asarray(_g0(n)), x)
    assert out is g  # in place
    np.testing.assert_array_equal(g.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", SAMPLE_COUNTS)
@pytest.mark.parametrize("n_bits", [None, 61])
def test_gramian_accumulate_packed_matches(n, n_bits):
    xp = gramian.pack_indicator_block(_indicators(n, 64, seed=n))
    g = torch.from_numpy(_g0(n))
    out = gramian.gramian_accumulate_packed(g, xp, n_bits)
    want = jax_gramian.gramian_accumulate_packed(
        jnp.asarray(_g0(n)), jnp.asarray(xp), n_bits
    )
    assert out is g
    np.testing.assert_array_equal(g.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", SAMPLE_COUNTS)
@pytest.mark.parametrize("feed", sorted(FEEDS))
def test_gramian_blockwise_matches(feed, n):
    kw = FEEDS[feed]
    bl = _blocks(n, seed=n)
    if kw.get("prepacked"):
        bl = [gramian.pack_indicator_block(b) for b in bl]
    got = gramian.gramian_blockwise(iter(bl), n, device="cpu", **kw)
    want = jax_gramian.gramian_blockwise(iter(bl), n, **kw)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("feed", sorted(FEEDS))
def test_gramian_blockwise_any_prefetch_depth(feed, depth):
    kw = FEEDS[feed]
    bl = _blocks(13, seed=depth)
    if kw.get("prepacked"):
        bl = [gramian.pack_indicator_block(b) for b in bl]
    got = gramian.gramian_blockwise(
        iter(bl), 13, prefetch_depth=depth, device="cpu", **kw
    )
    want = jax_gramian.gramian_blockwise(
        iter(bl), 13, prefetch_depth=depth, **kw
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gramian_blockwise_refuses_without_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gramian.gramian_blockwise(iter(_blocks(8)), 8)


@pytest.mark.parametrize("entry", ["gramian", "fused_forward"])
def test_whole_block_entries_refuse_without_cuda_by_default(
    monkeypatch, entry
):
    """A numpy block is moved to the card unless the caller asks for the
    CPU: without CUDA the call raises instead of computing on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _indicators(12, 40, seed=0)
    fn = gramian.gramian if entry == "gramian" else fused.fused_forward
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fn(x)


# -- the fused functions ---------------------------------------------------


def _structured(n, v, seed=0):
    """3 subpopulations (the JAX package's TestFusedPcoa cohort):
    a well-separated top-2 eigenbasis."""
    rng = np.random.default_rng(seed)
    pop = rng.integers(0, 3, n)
    base = rng.random(v) * 0.12
    shift = (rng.random((3, v)) < 0.2) * rng.random((3, v)) * 0.5
    prob = np.clip(base[None, :] + shift[pop], 0, 0.9)
    return (rng.random((n, v)) < prob).astype(np.int8)


def test_pcoa_fused_blocks_matches():
    x = _structured(96, 500)
    bl = [x[:, i : i + 128] for i in range(0, 500, 128)]
    coords, vals, rows = fused.pcoa_fused_blocks(iter(bl), 96, 2,
                                                 device="cpu")
    want, want_vals, want_rows = jax_fused.pcoa_fused_blocks(
        iter(bl), 96, 2
    )
    assert coords.shape == (96, 2)
    assert np.abs(coords - np.asarray(want)).max() <= 1e-4
    np.testing.assert_allclose(vals, np.asarray(want_vals), rtol=1e-4)
    np.testing.assert_array_equal(rows, np.asarray(want_rows))


@pytest.mark.parametrize("chunk_bits", [128, 200, 65536])
def test_pcoa_fused_packed_matches(chunk_bits):
    x = _structured(96, 500)
    xp = gramian.pack_indicator_block(x)
    coords, vals = fused.pcoa_fused_packed(
        xp, 500, 2, chunk_bits=chunk_bits, device="cpu"
    )
    want, want_vals = jax_fused.pcoa_fused_packed(
        xp, 500, 2, chunk_bits=chunk_bits
    )
    assert coords.shape == (96, 2)
    assert np.abs(coords - np.asarray(want)).max() <= 1e-4
    np.testing.assert_allclose(vals, np.asarray(want_vals), rtol=1e-4)


def test_fused_forward_matches():
    """The composition ``__graft_entry__.entry`` certifies, at its shape
    (128 × 512), on a structured cohort: the two start panels converge to
    one top-2 eigenbasis only where it is well separated."""
    x = _structured(128, 512, seed=1)
    got = fused.fused_forward(x, 2, device="cpu")
    want = np.asarray(jax_fused.fused_forward(jnp.asarray(x), 2))
    assert got.shape == (128, 2)
    assert np.abs(got.numpy() - want).max() <= 1e-4


# -- the block builders ----------------------------------------------------


def _calls(n, v, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(v):
        k = int(rng.integers(0, n + 1))
        out.append(sorted(rng.choice(n, k, replace=False).tolist()))
    return out


@pytest.mark.parametrize("width", [None, 31, 64])
def test_densify_calls_is_byte_identical(width):
    calls = _calls(20, 31, seed=2)
    got = blocks.densify_calls(calls, 20, width)
    want = jax_blocks.densify_calls(calls, 20, width)
    assert got.dtype == want.dtype == np.int8
    assert got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_densify_calls_refuses_bad_input():
    with pytest.raises(ValueError, match="out of range"):
        blocks.densify_calls([[0, 20]], 20)
    with pytest.raises(ValueError, match="out of range"):
        blocks.densify_calls([[-1]], 20)
    with pytest.raises(ValueError, match="width"):
        blocks.densify_calls([[0], [1]], 20, width=1)


def test_blocks_from_calls_is_byte_identical():
    calls = _calls(17, 200, seed=4)
    got = list(blocks.blocks_from_calls(iter(calls), 17, 64))
    want = list(jax_blocks.blocks_from_calls(iter(calls), 17, 64))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a.shape == b.shape == (17, 64)
        assert a.tobytes() == b.tobytes()


# -- the ordered worker map ------------------------------------------------


@pytest.mark.parametrize("workers", [0, 1, 4])
def test_ordered_parallel_map_keeps_input_order(workers):
    def slow_square(i):
        time.sleep(0.002 * ((7 * i) % 5))  # finish out of order
        return i * i

    got = list(ordered_parallel_map(slow_square, range(30), workers))
    assert got == [i * i for i in range(30)]


def test_ordered_parallel_map_serial_runs_in_the_caller():
    seen = []
    list(ordered_parallel_map(
        lambda i: seen.append(threading.current_thread()), range(3), 1
    ))
    assert seen == [threading.current_thread()] * 3


def test_ordered_parallel_map_error_surfaces_at_its_item():
    def fn(i):
        if i == 5:
            raise IOError("shard 5 died")
        time.sleep(0.001)
        return i

    got = []
    with pytest.raises(IOError, match="shard 5 died"):
        for r in ordered_parallel_map(fn, range(20), 4):
            got.append(r)
    assert got == [0, 1, 2, 3, 4]


def test_ordered_parallel_map_bounds_work_in_flight():
    lock = threading.Lock()
    started = []

    def fn(i):
        with lock:
            started.append(i)
        return i

    it = ordered_parallel_map(fn, range(100), 2, lookahead=1)
    assert next(it) == 0
    time.sleep(0.1)
    with lock:
        # workers + lookahead submitted before the first yield, plus at
        # most one more once it was taken.
        assert len(started) <= 4
    it.close()
