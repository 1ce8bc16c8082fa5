"""Share of its roofline the dense product reaches, in percent: the least
time the window's jobs need for their products (``roofline.int_mm_least_s``
of each job's N and sites) over the device time of the int8 GEMM kernels
(int8 in, int32 out: ``i8i32`` in cuBLAS's kernel names) launched inside
the port's ``gramian.accumulate`` ranges. The bit unpack and the float32
accumulate into G that the same ranges launch are not the product's and
are left out. Layer: dense product."""

from benchmark import roofline

KERNELS = ("i8i32",)


def read(run):
    device_s = run.trace.launched_us("gramian.accumulate", KERNELS) / 1e6
    if not device_s:
        return None
    least = sum(roofline.int_mm_least_s(j.n, j.sites) for j in run.jobs)
    return 100.0 * least / device_s
