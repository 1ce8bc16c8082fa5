"""Seconds of the driver's ``emit`` stage, a mean per job, as the
port's stage timer (``driver.timer.seconds``) reads it: emission (sorting and printing the rows). Layer: emission."""


def read(run):
    return sum(j.stages.get("emit", 0.0) for j in run.jobs) / len(run.jobs)
