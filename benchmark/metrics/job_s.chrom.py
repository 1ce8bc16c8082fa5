"""Seconds a job in ``kg1000.chrom``, as ``job_s`` takes them: the
window's seconds over the jobs it completed, read in the traced window.
That cell's ``job_s`` spreads past any bound the check allows (the host's
speed drifts from run to run), so it is watched here, per layer, and
moves ``peak_card_mib``, the cell's other end-to-end metric. Layer: pca
job."""


def read(run):
    return run.window_s / len(run.jobs) if run.jobs and run.window_s else None
