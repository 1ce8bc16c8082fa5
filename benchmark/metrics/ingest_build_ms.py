"""Milliseconds a job spends building packed blocks on the host, a mean
per job: the union, thread by thread, of the port's ``ingest.build``
ranges in the traced window. Layer: host ingest."""


def read(run):
    us = run.trace.union_us(("ingest.build",))
    return us / 1e3 / len(run.jobs) if us else None
