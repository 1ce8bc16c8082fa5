"""Share of its roofline the tile scatter reaches, in percent: the least
time the window's jobs need for their scatters (``roofline.
scatter_least_s`` of each job's N, carriers and ordered carrier pairs)
over the device time of the scatter kernel's two launches
(``variant_extent_kernel`` and ``scatter_band_kernel``) on every card of
the run. Each tile of a job's grid is scattered on its own card, so the
device time is summed over the cards, as the least time counts the whole
job's G. Layer: window routing and scatter kernel."""

from benchmark import roofline

KERNELS = ("variant_extent_kernel", "scatter_band_kernel")


def read(run):
    device_s = run.trace.kernel_us(KERNELS) / 1e6
    if not device_s:
        return None
    least = sum(roofline.scatter_least_s(j.n, j.carriers, j.pairs)
                for j in run.jobs)
    return 100.0 * least / device_s
