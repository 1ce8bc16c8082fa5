"""The roofline counts on small shapes, and the trace's reductions on a
hand-made timeline."""

import pytest

from benchmark import roofline
from benchmark.trace import Trace, merged_busy_us


def test_int_mm_least_time_is_ops_or_bytes():
    # 8 samples, 16 sites: 2·64·16 = 2048 operations; 8·16 + 4·64 = 384 B.
    n, v = 8, 16
    assert roofline.int_mm_least_s(n, v) == pytest.approx(max(
        2048 / roofline.PEAK_INT8_OPS_PER_S, 384 / roofline.PEAK_BYTES_PER_S))
    # At the cell's width the operations bound it: 1.64e12 operations.
    n, v = 2504, 131072
    assert roofline.int_mm_least_s(n, v) == pytest.approx(
        2 * n * n * v / 1979e12)


def test_scatter_least_time_counts_carriers_and_pairs():
    # Two sites with 3 and 2 carriers: 9 + 4 ordered pairs, 5 carriers.
    n = 4
    moved = 4 * 5 + 2 * 4 * n * n
    assert roofline.scatter_least_s(n, 5, 13) == pytest.approx(max(
        13 / roofline.PEAK_F32_PER_S, moved / roofline.PEAK_BYTES_PER_S))
    # Many pairs and a small G: the operations bound it.
    assert roofline.scatter_least_s(2, 10, 10**9) == pytest.approx(
        10**9 / 67e12)


def test_merged_busy_counts_overlaps_once():
    assert merged_busy_us([(0, 10), (5, 15), (20, 30)], 0, 100) == 25
    assert merged_busy_us([(0, 10), (5, 15)], 8, 12) == 4


def _trace():
    device = [(10, 20, "k1", 0), (15, 30, "k2", 0), (60, 70, "k1", 0)]
    ranges = {
        "bench.window": [(1, 0, 100)],
        "bench.job": [(1, 0, 100)],
        "ingest+gramian": [(1, 5, 50)],
        "ingest.fetch": [(2, 5, 40), (2, 30, 45), (3, 10, 20)],
        "emit": [(1, 50, 100)],
    }
    launched = {"gramian.accumulate": [("k1", 10.0), ("k1", 10.0),
                                       ("unpack", 7.0)]}
    return Trace(device, ranges, launched, (0, 100))


def test_trace_reductions():
    t = _trace()
    assert t.window_us == 100
    assert t.busy_us() == 30
    # Thread 2's ranges overlap (5-45, 40 us) and thread 3's add 10.
    assert t.union_us(("ingest.fetch",)) == 50
    assert t.union_us((), prefix="ingest.") == 50
    assert t.kernel_us(("k1",)) == 20
    assert t.launched_us("gramian.accumulate") == 27
    assert t.launched_us("gramian.accumulate", ("k1",)) == 20
    assert t.device_ops() == [["k1", 20e-6], ["k2", 15e-6]]


def test_idle_gaps_by_what_the_host_did():
    gaps = dict(_trace().idle_gaps())
    # Idle: 0-10 and 30-50 inside ingest+gramian (but 0-5 only in the
    # job), 50-60 and 70-100 in emit.
    assert gaps["ingest+gramian"] == pytest.approx(25e-6)
    assert gaps["bench.job"] == pytest.approx(5e-6)
    assert gaps["emit"] == pytest.approx(40e-6)
    assert sum(gaps.values()) == pytest.approx(70e-6)


def test_int_mm_share_counts_only_the_int8_gemm():
    """The dense product's share divides by the int8 GEMM's device time
    alone: an unpack or accumulate launched in the same range moves it
    not."""
    import types

    from benchmark.tests.conftest import ROOT
    from benchmark import spec as spec_mod

    read = spec_mod.load(ROOT).reader("int_mm_roofline")
    gemm = "sm90_xmma_gemm_i8i32_i8i32_i32_tn_n_kernel"
    job = types.SimpleNamespace(n=2504, sites=131072)
    least = roofline.int_mm_least_s(2504, 131072)

    def run(launched):
        trace = Trace([], {"bench.window": [(1, 0, 1)]}, launched, (0, 1))
        return read(types.SimpleNamespace(jobs=[job], trace=trace))

    alone = run({"gramian.accumulate": [(gemm, 2e6 * least)]})
    assert alone == pytest.approx(50.0)
    assert run({"gramian.accumulate": [(gemm, 2e6 * least),
                                       ("BitwiseAndFunctor", 1e6)]}) == alone
    assert run({"gramian.accumulate": [("BitwiseAndFunctor", 1e6)]}) is None
