"""The port's sparse Gramian engine against the JAX package's.

Integer-exact stages are held bit-identical: packing, the int8 packed
accumulate, the carrier matrix and routing helpers, and the whole
mixed-route ``sparse_gramian_blockwise`` under shuffled window orders.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_examples_tpu_torch.ops import gramian, sparse

# ops/__init__.py re-exports a function named ``gramian``: load the module.
jax_gramian = importlib.import_module("spark_examples_tpu.ops.gramian")
jax_sparse = importlib.import_module("spark_examples_tpu.ops.sparse")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _windows(n, densities, v=96, seed=0):
    """One CSR ``(indices, lens)`` window per density, from a seeded numpy
    draw; returns the windows and their dense 0/1 (N, V_total) block."""
    rng = np.random.default_rng(seed)
    windows, blocks = [], []
    for d in densities:
        x = (rng.random((n, v)) < d).astype(np.int8)
        cols, rows = np.nonzero(x.T)
        windows.append(
            (rows.astype(np.int64), np.bincount(cols, minlength=v))
        )
        blocks.append(x)
    return windows, np.concatenate(blocks, axis=1)


def test_pack_matches_and_unpack_round_trips():
    rng = np.random.default_rng(1)
    x = (rng.random((40, 77)) < 0.3).astype(np.int8)
    packed = gramian.pack_indicator_block(x)
    np.testing.assert_array_equal(
        packed, jax_gramian.pack_indicator_block(x)
    )
    got = gramian.unpack_indicator_block(torch.from_numpy(packed), 77)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), x)
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(
            jax_gramian.unpack_indicator_block(jnp.asarray(packed), 77)
        ),
    )


def test_pack_rejects_dosage_values():
    with pytest.raises(ValueError, match="0/1"):
        gramian.pack_indicator_block(np.full((4, 8), 2, np.int8))


def test_packed_accumulate_bit_identical_and_in_place():
    rng = np.random.default_rng(2)
    x = (rng.random((48, 200)) < 0.4).astype(np.int8)
    packed = gramian.pack_indicator_block(x)
    g0 = rng.integers(0, 5, size=(48, 48)).astype(np.float32)
    g = torch.tensor(g0)
    out = gramian.gramian_accumulate_packed(g, packed)
    assert out is g
    want = jax_gramian.gramian_accumulate_packed(
        jnp.asarray(g0), jnp.asarray(packed)
    )
    np.testing.assert_array_equal(g.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        g.numpy(), g0 + x.astype(np.int64) @ x.T.astype(np.int64)
    )


@pytest.mark.parametrize(
    "idx,lens,kwargs",
    [
        ([5, 7, 2, 9, 9, 9], [2, 1, 0, 3], {}),
        (list(range(9)), [9], {"n_rows": 4}),
        ([1, 2, 3], [3], {"n_rows": 256, "k_bucket": 32}),
        ([], [0, 0], {}),
    ],
    ids=["basic", "row-padding", "explicit-bucket", "empty"],
)
def test_padded_carrier_matrix_matches(idx, lens, kwargs):
    idx = np.asarray(idx, np.int64)
    lens = np.asarray(lens, np.int64)
    got = sparse.padded_carrier_matrix(idx, lens, sentinel=10, **kwargs)
    want = jax_sparse.padded_carrier_matrix(idx, lens, sentinel=10, **kwargs)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_padded_carrier_matrix_rejects_short_shapes():
    with pytest.raises(ValueError, match="n_rows"):
        sparse.padded_carrier_matrix(np.arange(3), np.ones(3), 9, n_rows=2)
    with pytest.raises(ValueError, match="k_bucket"):
        sparse.padded_carrier_matrix(np.arange(9), [9], 99, k_bucket=8)


@pytest.mark.parametrize(
    "lens,n,threshold",
    [
        ([1, 1, 1, 1], 100, 0.01),  # exactly at the threshold: dense
        ([1, 1, 1, 0], 100, 0.01),
        ([0, 0, 0, 30], 100, 0.2),  # one common variant: dense
        ([], 100, 0.02),
        ([2, 3], 1000, 0.0),
    ],
)
def test_window_route_and_density_match(lens, n, threshold):
    lens = np.asarray(lens, np.int64)
    assert sparse.window_density(lens, n) == jax_sparse.window_density(
        lens, n
    )
    assert sparse.window_route(lens, n, threshold) == jax_sparse.window_route(
        lens, n, threshold
    )


@pytest.mark.parametrize("rows", [0, 1, 7, 9, 300, 512, 513, 4096])
def test_dense_panel_width_matches(rows):
    assert sparse.dense_panel_width(rows, 512) == jax_sparse.dense_panel_width(
        rows, 512
    )


def test_both_routes_bit_identical_to_jax_under_shuffled_order():
    n = 256
    # Densities on both sides of the 0.05 threshold: three windows scatter,
    # three go dense.
    windows, x = _windows(n, [0.004, 0.2, 0.006, 0.5, 0.008, 0.1], seed=3)
    routes = [sparse.window_route(lens, n, 0.05) for _, lens in windows]
    assert routes.count("scatter") == 3 and routes.count("dense") == 3
    want = np.asarray(
        jax_sparse.sparse_gramian_blockwise(
            iter(windows), n, density_threshold=0.05, block_variants=128
        )
    )
    np.testing.assert_array_equal(
        want, x.astype(np.int64) @ x.T.astype(np.int64)
    )
    for perm_seed in range(3):
        order = np.random.default_rng(perm_seed).permutation(len(windows))
        got = sparse.sparse_gramian_blockwise(
            (windows[i] for i in order), n, density_threshold=0.05,
            block_variants=128, device="cpu",
        )
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)


def test_accumulate_scatters_one_window_in_place():
    windows, x = _windows(32, [0.05], v=40, seed=4)
    g = torch.zeros((32, 32))
    out = sparse.sparse_gramian_accumulate(g, *windows[0])
    assert out is g
    np.testing.assert_array_equal(
        g.numpy(), x.astype(np.int64) @ x.T.astype(np.int64)
    )


def test_out_of_range_carrier_fails_loudly():
    with pytest.raises(ValueError, match="out of range"):
        sparse.sparse_gramian_blockwise(
            [(np.array([0, 9]), np.array([2]))], 4, device="cpu"
        )


def test_entry_point_defaults_to_cuda_and_refuses_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sparse.sparse_gramian_blockwise(iter(()), 4)
