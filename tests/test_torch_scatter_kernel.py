"""The port's scatter-accumulate against the JAX package's.

On the CPU, ``spark_examples_tpu_torch.ops.scatter_kernel.scatter_pairs``
takes its plain version; it must be bit-identical to the JAX package's
Pallas kernel (interpret mode) and to its chunked scan, on the cases of
``tests/test_scatter_kernel.py``. The CUDA kernel itself is held against
the same plain version on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_examples_tpu.ops import scatter_kernel as jax_kernel
from spark_examples_tpu.ops.sparse import (
    SCATTER_CHUNK_VARIANTS as JAX_CHUNK,
    scatter_pairs_chunked as jax_scatter_chunked,
)
from spark_examples_tpu_torch.ops import scatter_kernel as sk

C = sk.SCATTER_CHUNK_VARIANTS


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _random_case(rng, t_r, t_c, v, k, oob_frac=0.2):
    row = rng.integers(0, t_r, size=(v, k)).astype(np.int32)
    col = rng.integers(0, t_c, size=(v, k)).astype(np.int32)
    row[rng.random((v, k)) < oob_frac] = t_r
    col[rng.random((v, k)) < oob_frac] = t_c + 7
    g = rng.integers(0, 9, size=(t_r, t_c)).astype(np.float32)
    return g, row, col


def _port(g, row, col):
    """The port's wrapper on CPU tensors; returns a numpy copy."""
    out = sk.scatter_pairs(
        torch.tensor(g), torch.from_numpy(row), torch.from_numpy(col)
    )
    return out.numpy()


def _jax_kernel(g, row, col):
    return np.asarray(
        jax_kernel.scatter_pairs_kernel(
            jnp.asarray(g), jnp.asarray(row), jnp.asarray(col),
            interpret=True,
        )
    )


def _jax_scan(g, row, col):
    return np.asarray(
        jax_scatter_chunked(
            jnp.asarray(g), jnp.asarray(row), jnp.asarray(col)
        )
    )


def test_chunk_matches_the_jax_package():
    assert C == JAX_CHUNK


@pytest.mark.parametrize(
    "t_r,t_c,k",
    [(8, 128, 8), (64, 128, 16), (64, 256, 64), (128, 128, 8)],
)
def test_geometry_sweep_bit_identical_to_pallas_and_scan(t_r, t_c, k):
    rng = np.random.default_rng(t_r + t_c + k)
    g, row, col = _random_case(rng, t_r, t_c, C * 2, k)
    got = _port(g, row, col)
    np.testing.assert_array_equal(got, _jax_kernel(g, row, col))
    np.testing.assert_array_equal(got, _jax_scan(g, row, col))


@pytest.mark.parametrize("t_r,t_c,k", [(37, 37, 8), (100, 300, 16), (5, 3, 32)])
def test_non_aligned_tiles_bit_identical_to_scan(t_r, t_c, k):
    rng = np.random.default_rng(7 * t_r + t_c)
    g, row, col = _random_case(rng, t_r, t_c, C, k)
    np.testing.assert_array_equal(
        _port(g, row, col), _jax_scan(g, row, col)
    )


def test_shared_operand_is_the_main_path_call():
    # The single-device engine passes one carrier matrix as both operands.
    rng = np.random.default_rng(3)
    g, row, _ = _random_case(rng, 96, 96, C, 16)
    got = sk.scatter_pairs(
        torch.tensor(g), *(2 * (torch.from_numpy(row),))
    ).numpy()
    np.testing.assert_array_equal(got, _jax_scan(g, row, row))


def test_duplicate_pairs_accumulate_with_multiplicity():
    row = np.full((C, 8), 8, np.int32)  # all OOB (t_r = 8)
    col = np.full((C, 8), 200, np.int32)
    row[0, :4] = 3
    col[0, :4] = 77
    g = np.zeros((8, 128), np.float32)
    got = _port(g, row, col)
    assert got[3, 77] == 16.0  # 4 row hits x 4 col hits
    assert got.sum() == 16.0
    np.testing.assert_array_equal(got, _jax_kernel(g, row, col))


def test_all_sentinel_is_inert():
    row = np.full((C, 16), 64, np.int32)
    col = np.full((C, 16), 128, np.int32)
    g0 = np.arange(64 * 128, dtype=np.float32).reshape(64, 128)
    np.testing.assert_array_equal(_port(g0, row, col), g0)
    np.testing.assert_array_equal(_jax_kernel(g0, row, col), g0)


def test_tall_tiles_match_the_row_blocked_pallas_grid(monkeypatch):
    # The JAX kernel grids a tall tile into 8-row blocks under a small
    # VMEM budget; the port has no row blocking and must agree anyway.
    rng = np.random.default_rng(5)
    g, row, col = _random_case(rng, 64, 128, C * 2, 16)
    monkeypatch.setenv(
        "SPARK_EXAMPLES_TPU_SCATTER_KERNEL_VMEM",
        str(C * 128 * 4 + 2 * 8 * 128 * 4 + C * 8 * 4 + 2 * C * 16 * 4),
    )
    assert jax_kernel.kernel_block_rows(64, 128, 16) == 8
    np.testing.assert_array_equal(
        _port(g, row, col), _jax_kernel(g, row, col)
    )


def test_updates_in_place_and_returns_g():
    g = torch.zeros((16, 16))
    idx = torch.full((C, 8), 16, dtype=torch.int32)
    idx[0, :2] = torch.tensor([1, 2], dtype=torch.int32)
    out = sk.scatter_pairs(g, idx, idx)
    assert out is g
    assert g.sum() == 4.0


def test_cpu_call_does_not_count_a_launch():
    before = sk.SCATTER_KERNEL_LAUNCHES
    _port(*_random_case(np.random.default_rng(1), 16, 16, C, 8))
    assert sk.SCATTER_KERNEL_LAUNCHES == before


def test_non_cpu_tensor_launches_or_raises_never_falls_back(monkeypatch):
    # A tensor off the CPU goes to the kernel path only. Without CUDA
    # that raises; it must not quietly run the plain version.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = torch.zeros((16, 16), device="meta")
    idx = torch.zeros((C, 8), dtype=torch.int32, device="meta")
    before = sk.SCATTER_KERNEL_LAUNCHES
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sk.scatter_pairs(g, idx, idx)
    assert sk.SCATTER_KERNEL_LAUNCHES == before


@pytest.mark.parametrize(
    "g,idx,match",
    [
        (torch.zeros((8, 8), dtype=torch.float64),
         torch.zeros((C, 8), dtype=torch.int32), "float32"),
        (torch.zeros((8, 8)),
         torch.zeros((C, 8), dtype=torch.int64), "int32"),
        (torch.zeros((8, 8)),
         torch.zeros((C + 1, 8), dtype=torch.int32), "multiple"),
        (torch.zeros((8, 16))[:, ::2],
         torch.zeros((C, 8), dtype=torch.int32), "contiguous"),
    ],
    ids=["g-dtype", "idx-dtype", "v-pad", "non-contiguous"],
)
def test_operands_are_checked(g, idx, match):
    with pytest.raises(ValueError, match=match):
        sk.scatter_pairs(g, idx, idx)
