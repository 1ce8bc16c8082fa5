"""Seconds to construct ``VariantsPcaDriver`` (the callset table and the
driver's routing), a mean per job: the harness's own clock around the
constructor. Layer: driver and callsets."""


def read(run):
    return sum(j.construct_s for j in run.jobs) / len(run.jobs)
