"""Milliseconds a job's product waits on the feed for its next staged
block, a mean per job: the union, thread by thread, of the port's
``feed.wait`` ranges in the traced window (one a block pulled, and one for
the end). Layer: feed."""


def read(run):
    us = run.trace.union_us(("feed.wait",))
    return us / 1e3 / len(run.jobs) if us else None
