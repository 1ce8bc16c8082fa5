"""Milliseconds a job spends reading the sidecar, a mean per job: the
union, thread by thread, of the port's ``ingest.fetch`` and
``jsonl.stream_carrying_csr`` ranges in the traced window. Layer:
sidecar."""

RANGES = ("ingest.fetch", "jsonl.stream_carrying_csr")


def read(run):
    us = run.trace.union_us(RANGES)
    return us / 1e3 / len(run.jobs) if us else None
