"""Seconds of the driver's ``pca`` stage, a mean per job, as the
port's stage timer (``driver.timer.seconds``) reads it: the finish (fused finish, eigensolve, or the sketch's finish). Layer: finish."""


def read(run):
    return sum(j.stages.get("pca", 0.0) for j in run.jobs) / len(run.jobs)
