"""Seconds of a tile grid's eigensolve a job, a mean per job: the union,
thread by thread, of the port's ``pcoa.tiles.*`` ranges in the traced
window (G's row sums read from the tiles once a job, and each centred
product C·Q of the randomized iteration). Layer: finish."""


def read(run):
    us = run.trace.union_us((), prefix="pcoa.tiles.")
    return us / 1e6 / len(run.jobs) if us else None
