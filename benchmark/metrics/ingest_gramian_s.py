"""Seconds of the driver's ``ingest+gramian`` stage, a mean per job, as the
port's stage timer (``driver.timer.seconds``) reads it: the stage that reads the cohort and builds G or the sketch panel (sidecar, host ingest, feed, product). Layer: ingest stage."""


def read(run):
    return sum(j.stages.get("ingest+gramian", 0.0) for j in run.jobs) / len(run.jobs)
