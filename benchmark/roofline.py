"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit) and the least time of each counted
kernel's work.

The counts come from the job's inputs, not from how the port lays them out:
N samples and V sites unpadded, the carriers and carrier pairs of the
job's sites. A share of a roofline is that least time over the device
time of the kernels that did the work.
"""

from __future__ import annotations

__all__ = [
    "PEAK_BYTES_PER_S",
    "PEAK_F32_PER_S",
    "PEAK_INT8_OPS_PER_S",
    "int_mm_least_s",
    "scatter_least_s",
]

PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_F32_PER_S = 67e12  # float32 outside the tensor cores
PEAK_INT8_OPS_PER_S = 1979e12  # int8 tensor cores


def int_mm_least_s(n: int, sites: int) -> float:
    """The dense product of one job: 2·N²·V int8 operations, or the int8
    panel (N·V bytes) read once and the int32 G (4·N² bytes) written once,
    whichever takes longer."""
    ops = 2.0 * n * n * sites / PEAK_INT8_OPS_PER_S
    moved = (n * sites + 4.0 * n * n) / PEAK_BYTES_PER_S
    return max(ops, moved)


def scatter_least_s(n: int, carriers: int, pairs: int) -> float:
    """The scatter of one job's carriers into G: one float32 add per
    ordered carrier pair (Σ k² over the sites), or 4 bytes a carrier plus
    G (4·N² bytes) read and written once, whichever takes longer."""
    ops = pairs / PEAK_F32_PER_S
    moved = (4.0 * carriers + 2 * 4.0 * n * n) / PEAK_BYTES_PER_S
    return max(ops, moved)
