"""The port's delta and gang Gramians against the JAX package's.

Both packages run the same numpy-seeded cohorts and windows on the CPU in
one process: the ±1 signed scatter, the rank-k sample correction by both
routes (the scatter, and the int8 product at touched-column counts 1, 7, 8,
9 and 16, where ``_int_mm``'s shape rule must pad the operand), the delta
Gramian for added, removed and mixed sample sets, the gang accumulator for
B = 1..4 uneven cohorts, and the driver's ``ingest_gramian_windows`` /
``ingest_gramian_delta``. Every output is an exact integer count in
float32, so each must be bit-identical to the JAX function's and to a
from-scratch accumulation (``==``, never allclose) — the bar of
``tests/test_delta.py``.
"""

import random

import numpy as np
import pytest
import torch

from spark_examples_tpu.genomics.fixtures import (
    synthetic_cohort as jax_synthetic_cohort,
)
from spark_examples_tpu.models.pca import VariantsPcaDriver as JaxDriver
from spark_examples_tpu.ops import delta as jax_delta
from spark_examples_tpu.ops.gramian import (
    gang_gramian_blockwise as jax_gang,
)
from spark_examples_tpu.ops.sparse import (
    padded_carrier_matrix as jax_padded_carrier_matrix,
)
from spark_examples_tpu.utils.config import PcaConfig as JaxConfig
from spark_examples_tpu_torch.genomics.fixtures import (
    DEFAULT_VARIANT_SET_ID,
    synthetic_cohort,
)
from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
from spark_examples_tpu_torch.ops import delta
from spark_examples_tpu_torch.ops import scatter_kernel
from spark_examples_tpu_torch.ops.gramian import gang_gramian_blockwise
from spark_examples_tpu_torch.ops.sparse import padded_carrier_matrix
from spark_examples_tpu_torch.utils.config import PcaConfig

REFS = "17:41196311:41277499"
N, V = 12, 120
IDS = [f"{DEFAULT_VARIANT_SET_ID}-{i}" for i in range(N)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _kw(**kw):
    kw.setdefault("variant_set_ids", [DEFAULT_VARIANT_SET_ID])
    kw.setdefault("references", REFS)
    kw.setdefault("bases_per_partition", 20_000)
    kw.setdefault("block_variants", 16)
    kw.setdefault("ingest_workers", 2)
    return kw


def _conf(**kw):
    return PcaConfig(device="cpu", **_kw(**kw))


def _jconf(**kw):
    return JaxConfig(**_kw(**kw))


@pytest.fixture(scope="module")
def cohort():
    src = synthetic_cohort(N, V, seed=11)
    jsrc = jax_synthetic_cohort(N, V, seed=11)
    g_full = VariantsPcaDriver(_conf(), src).ingest_gramian().numpy()
    return src, jsrc, g_full


def _g(src, **kw):
    return VariantsPcaDriver(_conf(**kw), src).ingest_gramian().numpy()


def _random_windows(rng, n_full, n_var, p=0.3, width=16):
    """Seeded 0/1 X and its full-frame CSR windows."""
    x = (rng.random((n_full, n_var)) < p).astype(np.int64)
    windows = []
    for lo in range(0, n_var, width):
        cols = x[:, lo:lo + width]
        lens = cols.sum(axis=0).astype(np.int64)
        idx = (
            np.concatenate(
                [np.nonzero(cols[:, j])[0] for j in range(cols.shape[1])]
            )
            if lens.sum()
            else np.zeros(0, dtype=np.int64)
        )
        windows.append((idx, lens))
    return x, windows


class TestSignedScatter:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    @pytest.mark.parametrize("sign", [1, -1])
    def test_matches_the_jax_scatter(self, seed, sign):
        import jax.numpy as jnp

        rng = np.random.default_rng(seed)
        n_rows, n_cols, n_var = 23, 9, 300
        lens_r = rng.integers(0, 12, n_var)
        lens_c = rng.integers(0, 4, n_var)
        # Out-of-range carriers (>= the bounds) must drop, as the
        # sentinels do.
        idx_r = rng.integers(0, n_rows + 3, int(lens_r.sum()))
        idx_c = rng.integers(0, n_cols + 2, int(lens_c.sum()))
        kw = dict(n_rows=512)
        mat_r = padded_carrier_matrix(idx_r, lens_r, n_rows, **kw)
        mat_c = padded_carrier_matrix(idx_c, lens_c, n_cols, **kw)
        assert np.array_equal(
            mat_r, jax_padded_carrier_matrix(idx_r, lens_r, n_rows, **kw)
        )
        want = np.asarray(
            jax_delta.signed_scatter_pairs(
                jnp.zeros((n_rows, n_cols), jnp.float32),
                mat_r, mat_c, sign,
            )
        )
        got = delta.signed_scatter_pairs(
            torch.zeros((n_rows, n_cols)), torch.from_numpy(mat_r),
            torch.from_numpy(mat_c), sign,
        ).numpy()
        assert np.array_equal(got, want)
        assert np.abs(got).sum() > 0

    def test_minus_cancels_plus(self):
        lens = np.asarray([2, 3, 1, 0], dtype=np.int64)
        idx = np.asarray([0, 2, 1, 3, 4, 2], dtype=np.int64)
        mat = padded_carrier_matrix(idx, lens, sentinel=5, n_rows=256)
        acc = delta.signed_scatter_pairs(
            torch.zeros((5, 5)), mat, mat, sign=1
        )
        plus = acc.clone()
        assert float(plus.sum()) > 0
        delta.signed_scatter_pairs(acc, mat, mat, sign=-1)
        assert torch.equal(acc, torch.zeros((5, 5)))
        minus = delta.signed_scatter_pairs(
            torch.zeros((5, 5)), mat, mat, sign=-1
        )
        assert torch.equal(minus, -plus)
        with pytest.raises(ValueError, match="sign"):
            delta.signed_scatter_pairs(acc, mat, mat, sign=2)
        with pytest.raises(ValueError, match="disagree"):
            delta.signed_scatter_pairs(acc, mat, mat[:8], sign=1)

    def test_scatter_kernel_is_not_launched(self):
        # The signed scatter is torch ops, not the scatter kernel: its
        # launch count stays where it was.
        before = scatter_kernel.SCATTER_KERNEL_LAUNCHES
        mat = padded_carrier_matrix(
            np.asarray([0, 1]), np.asarray([2]), sentinel=3
        )
        delta.signed_scatter_pairs(torch.zeros((3, 3)), mat, mat)
        assert scatter_kernel.SCATTER_KERNEL_LAUNCHES == before


class TestSampleCorrection:
    # threshold 0 forces the int8 product, 2.0 the scatter.
    @pytest.mark.parametrize("threshold", [0.0, 2.0], ids=["dense", "scatter"])
    @pytest.mark.parametrize("k", [1, 7, 8, 9, 16])
    def test_both_routes_match_jax_and_gramian_columns(self, k, threshold):
        rng = np.random.default_rng(100 + k)
        n_full, n_var = 40, 200
        x, windows = _random_windows(rng, n_full, n_var, p=0.25)
        touched = np.sort(rng.choice(n_full, k, replace=False))
        row_of_full = np.arange(n_full, dtype=np.int64)
        col_of_full = np.full(n_full, k, dtype=np.int64)
        col_of_full[touched] = np.arange(k)
        args = (windows, row_of_full, col_of_full, n_full, k)
        got = delta.sample_correction(
            *args, density_threshold=threshold, device="cpu"
        )
        want = jax_delta.sample_correction(
            *args, density_threshold=threshold
        )
        assert got.dtype == np.float32 and got.shape == (n_full, k)
        assert np.array_equal(got, want)
        assert np.array_equal(got, (x @ x[touched].T).astype(np.float32))

    @pytest.mark.parametrize("threshold", [0.0, 2.0], ids=["dense", "scatter"])
    def test_routes_agree_on_the_driver_windows(self, cohort, threshold):
        src, _, g_full = cohort
        windows = list(
            VariantsPcaDriver(_conf(), src)._cohort_windows(restrict=False)
        )
        touched = [2, 7, 11]
        row_of_full = np.arange(N, dtype=np.int64)
        col_of_full = np.full(N, len(touched), dtype=np.int64)
        col_of_full[touched] = np.arange(len(touched))
        corr = delta.sample_correction(
            windows, row_of_full, col_of_full, N, len(touched),
            density_threshold=threshold, device="cpu",
        )
        assert np.array_equal(corr, g_full[:, touched])

    def test_no_touched_variant_is_all_zero(self):
        windows = [(np.asarray([0, 1]), np.asarray([2]))]
        got = delta.sample_correction(
            windows, np.arange(4), np.full(4, 2), 4, 2, device="cpu"
        )
        assert np.array_equal(got, np.zeros((4, 2), np.float32))


class TestDeltaGramian:
    @pytest.mark.parametrize(
        "anc, tgt",
        [
            ([0, 1, 2, 3, 4, 5, 6, 7, 8], [0, 2, 3, 5, 7, 8]),  # removed
            ([1, 3, 5], [0, 1, 3, 5, 6, 8]),  # added
            ([7, 0, 3, 5, 1], [0, 2, 3, 6, 7]),  # mixed, scrambled frame
        ],
        ids=["removed", "added", "mixed"],
    )
    @pytest.mark.parametrize("threshold", [0.0, 2.0], ids=["dense", "scatter"])
    def test_matches_jax_and_from_scratch(self, anc, tgt, threshold):
        rng = np.random.default_rng(3)
        n_full, n_var = 9, 40
        x, windows = _random_windows(rng, n_full, n_var)
        anc, tgt = np.asarray(anc), np.asarray(tgt)
        g_anc = (x[anc] @ x[anc].T).astype(np.float32)
        want = (x[tgt] @ x[tgt].T).astype(np.float32)
        got = delta.delta_gramian(
            g_anc, anc, tgt, n_full, windows,
            density_threshold=threshold, device="cpu",
        )
        assert np.array_equal(got, want)
        assert np.array_equal(
            got, jax_delta.delta_gramian(g_anc, anc, tgt, n_full, windows)
        )

    def test_takes_a_cached_tensor(self):
        rng = np.random.default_rng(4)
        x, windows = _random_windows(rng, 6, 32)
        anc, tgt = np.arange(4), np.arange(1, 6)
        g_anc = torch.from_numpy((x[anc] @ x[anc].T).astype(np.float32))
        got = delta.delta_gramian(g_anc, anc, tgt, 6, windows, device="cpu")
        assert np.array_equal(got, (x[tgt] @ x[tgt].T).astype(np.float32))

    def test_frame_mismatch_is_loud(self):
        with pytest.raises(ValueError, match="ancestor"):
            delta.delta_gramian(
                np.zeros((3, 3), np.float32), np.arange(4), np.arange(4),
                4, [], device="cpu",
            )


class TestGangGramian:
    @pytest.mark.parametrize("batch", [1, 2, 3, 4])
    def test_gang_matches_jax_and_serial(self, cohort, batch):
        src, jsrc, _ = cohort
        cohorts = [IDS[:5], IDS[3:9], IDS[1:], IDS[2:4]][:batch]
        driver = VariantsPcaDriver(_conf(), src)
        windows = list(driver._cohort_windows(restrict=False))
        remaps, sizes = [], []
        for members in cohorts:
            sub, remap = driver.index.restricted(members)
            remaps.append(remap)
            sizes.append(sub.size)
        g = gang_gramian_blockwise(windows, remaps, max(sizes), device="cpu")
        assert g.shape == (batch, max(sizes), max(sizes))
        assert g.dtype == np.float32
        want = jax_gang(windows, remaps, max(sizes), block_variants=16)
        assert np.array_equal(g, want)
        for b, members in enumerate(cohorts):
            serial = _g(src, samples=list(members))
            assert np.array_equal(g[b, :sizes[b], :sizes[b]], serial)
            assert not g[b, sizes[b]:, :].any()
            assert not g[b, :, sizes[b]:].any()

    def test_gang_is_order_independent(self, cohort):
        src, _, _ = cohort
        driver = VariantsPcaDriver(_conf(), src)
        windows = list(driver._cohort_windows(restrict=False))
        _, remap = driver.index.restricted(IDS[:6])
        a = gang_gramian_blockwise(windows, [remap], 6, device="cpu")
        shuffled = list(windows)
        random.Random(9).shuffle(shuffled)
        b = gang_gramian_blockwise(shuffled, [remap], 6, device="cpu")
        assert np.array_equal(a, b)

    def test_empty_gang_is_loud(self):
        with pytest.raises(ValueError, match=">= 1 cohort"):
            gang_gramian_blockwise(iter(()), [], 4, device="cpu")


class TestDriver:
    def test_windows_route_matches_jax_and_block_route(self, cohort):
        src, jsrc, _ = cohort
        kw = dict(exclude_samples=[IDS[0], IDS[4]])
        sink = []
        got = VariantsPcaDriver(
            _conf(**kw), src
        ).ingest_gramian_windows(window_sink=sink)
        assert isinstance(got, torch.Tensor)
        got = got.numpy()
        assert np.array_equal(got, _g(src, **kw))
        jsink = []
        want = np.asarray(
            JaxDriver(_jconf(**kw), jsrc).ingest_gramian_windows(
                window_sink=jsink
            )
        )
        assert np.array_equal(got, want)
        # The captured windows are the full frame, the JAX package's.
        assert len(sink) == len(jsink)
        for (i, l), (ji, jl) in zip(sink, jsink):
            assert np.array_equal(i, ji) and np.array_equal(l, jl)

    def test_windows_route_launches_the_scatter_route(self, cohort):
        # Under --pca-mode auto the driver's own ingest is dense; the
        # window route runs the sparse engine whatever the mode says.
        src, _, _ = cohort
        g = VariantsPcaDriver(
            _conf(pca_mode="auto", sparse_density_threshold=1.01), src
        ).ingest_gramian_windows()
        assert np.array_equal(g.numpy(), _g(src))

    @pytest.mark.parametrize(
        "anc_kw, tgt_kw",
        [
            ({}, dict(exclude_samples=[IDS[3], IDS[8]])),
            (dict(samples=IDS[:8]), dict(samples=IDS[4:])),
            (dict(samples=IDS[:9]), dict(samples=IDS[1:10])),
        ],
        ids=["removed", "mixed", "shifted"],
    )
    @pytest.mark.parametrize("cached", [False, True], ids=["stream", "cached"])
    def test_ingest_gramian_delta(self, cohort, anc_kw, tgt_kw, cached):
        src, jsrc, _ = cohort
        anc = VariantsPcaDriver(_conf(**anc_kw), src)
        windows = []
        g_anc = anc.ingest_gramian_windows(window_sink=windows).numpy()
        anc_ids = tuple(anc.cohort.callset_of_index())
        driver = VariantsPcaDriver(_conf(**tgt_kw), src)
        sink = []
        got = driver.ingest_gramian_delta(
            g_anc, anc_ids, windows=windows if cached else None,
            window_sink=None if cached else sink,
        )
        assert np.array_equal(got, _g(src, **tgt_kw))
        want = JaxDriver(_jconf(**tgt_kw), jsrc).ingest_gramian_delta(
            g_anc, anc_ids
        )
        assert np.array_equal(got, want)
        if not cached:
            # The re-streamed windows are captured only where a sample
            # was added: a pure removal gathers and never reads them.
            added = set(driver.cohort.callset_of_index()) - set(anc_ids)
            assert len(sink) == (len(windows) if added else 0)

    def test_delta_from_shuffled_windows(self, cohort):
        src, _, _ = cohort
        windows = []
        g_anc = VariantsPcaDriver(
            _conf(samples=IDS[:9]), src
        ).ingest_gramian_windows(window_sink=windows).numpy()
        driver = VariantsPcaDriver(_conf(samples=IDS[1:10]), src)
        shuffled = list(windows)
        random.Random(5).shuffle(shuffled)
        got = driver.ingest_gramian_delta(
            g_anc, tuple(IDS[:9]), windows=shuffled
        )
        assert np.array_equal(got, _g(src, samples=IDS[1:10]))

    def test_restricted_gramian_is_the_full_submatrix(self, cohort):
        src, _, g_full = cohort
        keep = [0, 1, 3, 4, 5, 6, 8, 9, 10, 11]
        g_sub = _g(src, exclude_samples=[IDS[2], IDS[7]])
        assert np.array_equal(g_sub, g_full[np.ix_(keep, keep)])
