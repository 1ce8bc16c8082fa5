"""Seconds a job spends on its per-sample rows, a mean per job: the union,
thread by thread, of the port's ``rows.*`` ranges (the coordinates made
rows, the rows named and sorted, then printed and written) in the traced
window. Layer: emission."""


def read(run):
    us = run.trace.union_us((), prefix="rows.")
    return us / 1e6 / len(run.jobs) if us else None
