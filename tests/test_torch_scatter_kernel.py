"""The port's scatter-accumulate against the JAX package's.

On the CPU, ``spark_examples_tpu_torch.ops.scatter_kernel.scatter_pairs``
takes its plain version; it must be bit-identical to the JAX package's
Pallas kernel (interpret mode) and to its chunked scan, on the cases of
``tests/test_scatter_kernel.py``. The CUDA kernel itself is held against
the same plain version on the card by ``chip_smoke.py``.

The kernel's launch geometry is Python (``scatter_plan``), so it is
tested here: how G is cut into row bands and column tiles, and a numpy
walk of the plan that does what the kernel does (per-variant extents and
row-band masks, then per band and tile: filter, count, add into G).
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


# -- the band kernel's launch geometry ---------------------------------------


def _cells(plan, n_rows, n_cols):
    """Yield (r0, rows, c0, cols) of every block of the plan."""
    for band in range(plan.n_bands):
        r0 = band * plan.band_rows
        for tile in range(plan.n_tiles):
            c0 = tile * plan.tile_cols
            yield (r0, min(plan.band_rows, n_rows - r0),
                   c0, min(plan.tile_cols, n_cols - c0))


PLAN_SHAPES = [
    (2504, 2504, sk.H100_SMS, sk.SCATTER_COUNTER_BYTES),
    (64, 70000, sk.H100_SMS, sk.SCATTER_COUNTER_BYTES),
    (256, 384, sk.H100_SMS, sk.SCATTER_COUNTER_BYTES),
    (5, 3, sk.H100_SMS, sk.SCATTER_COUNTER_BYTES),
    (2504, 2504, 1, sk.SCATTER_COUNTER_BYTES),
    (37, 301, 4, 4 * 48),
    (600, 40, 132, 4 * 40),
]


@pytest.mark.parametrize("n_rows,n_cols,n_sms,budget", PLAN_SHAPES)
def test_plan_puts_every_cell_of_g_in_exactly_one_block(
    n_rows, n_cols, n_sms, budget
):
    plan = sk.scatter_plan(n_rows, n_cols, n_sms, budget)
    hits = np.zeros((n_rows, n_cols), np.int8)
    for r0, rows, c0, cols in _cells(plan, n_rows, n_cols):
        assert rows >= 1 and cols >= 1
        hits[r0:r0 + rows, c0:c0 + cols] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("n_rows,n_cols,n_sms,budget", PLAN_SHAPES)
def test_plan_counters_fit_the_shared_memory_budget(
    n_rows, n_cols, n_sms, budget
):
    plan = sk.scatter_plan(n_rows, n_cols, n_sms, budget)
    assert 4 * plan.band_rows * plan.tile_cols <= budget
    assert plan.smem_bytes == sk.SCATTER_LIST_BYTES + (
        4 * plan.band_rows * plan.tile_cols
    )
    assert plan.smem_bytes <= sk.SCATTER_SMEM_BYTES


@pytest.mark.parametrize("budget", [sk.SCATTER_COUNTER_BYTES, 4 * 48, 4 * 7])
@pytest.mark.parametrize("extra", [-1, 0, 1, 5])
def test_columns_split_exactly_when_a_full_row_does_not_fit(budget, extra):
    n_cols = budget // 4 + extra
    plan = sk.scatter_plan(16, n_cols, sk.H100_SMS, budget)
    if 4 * n_cols <= budget:
        assert (plan.n_tiles, plan.tile_cols) == (1, n_cols)
    else:
        assert plan.n_tiles > 1
        assert plan.tile_cols % 4 == 0
        # The fewest tiles that fit: one fewer would not.
        widest = budget // 4 - (budget // 4) % 4
        assert plan.n_tiles == -(-n_cols // widest)


def test_plan_spreads_the_cohort_band_over_the_card():
    # N = 2504: a one-wave grid of 132 bands of 19 rows, the last partial.
    plan = sk.scatter_plan(2504, 2504)
    assert plan == sk.ScatterPlan(19, 2504, 132, 1, plan.smem_bytes)
    assert 2504 % plan.band_rows != 0
    # With few SMs the band takes as many rows as its budget holds.
    tall = sk.scatter_plan(2504, 2504, n_sms=1)
    assert tall.band_rows == sk.SCATTER_COUNTER_BYTES // (4 * 2504)


def test_band_mask_bits_are_distinct_up_to_the_mask_width():
    for n_bands in (1, 7, 132, sk.SCATTER_MASK_BITS):
        bits = [sk.band_mask_bit(b, n_bands) for b in range(n_bands)]
        assert len(set(bits)) == n_bands
        assert max(bits) < sk.SCATTER_MASK_BITS
    many = [sk.band_mask_bit(b, 1000) for b in range(1000)]
    assert many == sorted(many) and max(many) == sk.SCATTER_MASK_BITS - 1


def _plan_walk(g, row, col, plan):
    """What csrc/scatter_pairs.cu does under ``plan``, in numpy: the
    pre-pass's extents and row-band masks, then per (band, tile) block
    the filtered variants' in-band x in-tile pairs counted in int64 and
    added into G once."""
    n_rows, n_cols = g.shape
    v_pad, k = row.shape
    row_in = (row >= 0) & (row < n_rows)
    any_in = row_in | ((col >= 0) & (col < n_cols))
    extent = np.where(
        any_in.any(axis=1), k - np.argmax(any_in[:, ::-1], axis=1), 0
    )
    masks = np.zeros((v_pad, sk.SCATTER_MASK_BITS), bool)
    v_of, a_of = np.nonzero(row_in)
    masks[v_of, [sk.band_mask_bit(int(r) // plan.band_rows, plan.n_bands)
                 for r in row[v_of, a_of]]] = True
    out = g.copy()
    for r0, rows, c0, cols in _cells(plan, n_rows, n_cols):
        band = r0 // plan.band_rows
        listed = np.nonzero(
            masks[:, sk.band_mask_bit(band, plan.n_bands)] & (extent > 0)
        )[0]
        cnt = np.zeros((rows, cols), np.int64)
        for v in listed:
            rl = row[v, :extent[v]].astype(np.int64) - r0
            cl = col[v, :extent[v]].astype(np.int64) - c0
            rl = rl[(rl >= 0) & (rl < rows)]
            cl = cl[(cl >= 0) & (cl < cols)]
            np.add.at(cnt, (rl[:, None], cl[None, :]), 1)
        out[r0:r0 + rows, c0:c0 + cols] += cnt.astype(np.float32)
    return out


@pytest.mark.parametrize("shared", [False, True], ids=["distinct", "shared"])
@pytest.mark.parametrize(
    "n_sms,budget",
    [(sk.H100_SMS, sk.SCATTER_COUNTER_BYTES), (3, 4 * 100), (64, 4 * 44)],
    ids=["h100", "tall-bands", "column-split"],
)
@pytest.mark.parametrize(
    "t_r,t_c,k",
    [(8, 128, 8), (64, 128, 16), (64, 256, 64), (128, 128, 8)],
)
def test_plan_walk_bit_identical_to_the_jax_scan(
    t_r, t_c, k, n_sms, budget, shared
):
    rng = np.random.default_rng(t_r + t_c + k + budget)
    g, row, col = _random_case(rng, t_r, t_c, C * 2, k)
    if shared:
        row = np.minimum(row, t_c)
        col = row
    plan = sk.scatter_plan(t_r, t_c, n_sms, budget)
    np.testing.assert_array_equal(
        _plan_walk(g, row, col, plan), _jax_scan(g, row, col)
    )


def test_plan_walk_with_bands_sharing_mask_bits():
    # 600 one-row bands share the 256 mask bits: the mask only filters,
    # and the in-band test keeps the count exact.
    rng = np.random.default_rng(11)
    g, row, col = _random_case(rng, 600, 40, C, 16)
    plan = sk.scatter_plan(600, 40, sk.H100_SMS, 4 * 40)
    assert plan.n_bands == 600 > sk.SCATTER_MASK_BITS
    np.testing.assert_array_equal(
        _plan_walk(g, row, col, plan), _jax_scan(g, row, col)
    )


def test_plan_walk_drops_negative_indices_like_the_pallas_kernel():
    # Rebased tile operands carry negative indices; the Pallas kernel's
    # one-hot compare never matches them, and the walk drops them too.
    rng = np.random.default_rng(12)
    g, row, col = _random_case(rng, 64, 128, C, 16)
    row[rng.random(row.shape) < 0.1] = -3
    col[rng.random(col.shape) < 0.1] = -40
    plan = sk.scatter_plan(64, 128, sk.H100_SMS, 4 * 128)
    assert plan.n_bands == 64
    got = _plan_walk(g, row, col, plan)
    np.testing.assert_array_equal(got, _jax_kernel(g, row, col))
    np.testing.assert_array_equal(got, _port(g, row, col))
