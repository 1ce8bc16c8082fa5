"""Seconds of the sketch engine a job, a mean per job: the union, thread by
thread, of the port's ``gramian.sketch.*`` ranges (the panel's passes and
its finish) in the traced window. Layer: sketch."""


def read(run):
    us = run.trace.union_us((), prefix="gramian.sketch.")
    return us / 1e6 / len(run.jobs) if us else None
