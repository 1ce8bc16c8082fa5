"""Milliseconds a job's window slicer waits on the fetch pool for the next
shard's CSR pair, a mean per job: the union, thread by thread, of the
port's ``shard.wait`` ranges in the traced window (one a shard pulled,
and one for the end). Layer: sidecar."""


def read(run):
    us = run.trace.union_us(("shard.wait",))
    return us / 1e3 / len(run.jobs) if us else None
