"""Seconds a job spends building its callset table, a mean per job: the
union, thread by thread, of the port's ``callsets.*`` ranges (the source's
callset list read and the table built) in the traced window. Layer: driver
and callsets."""


def read(run):
    us = run.trace.union_us((), prefix="callsets.")
    return us / 1e6 / len(run.jobs) if us else None
