"""The traffic generator: one general reader of a mix's data file.

A mix (``traffic/<mix>.json``) says which ``pca`` jobs run back to back in
one client's closed loop:

- ``pca_mode``: the job's ``--pca-mode``;
- ``regions``: ``"segment"`` (one job over every site of the cohort) or
  ``{"span_bp": b}`` (consecutive regions of b bases from the segment's
  start, one job each, rotated in an order drawn from the seed);
- ``flags``: further ``pca`` flags, as the command line takes them;
- cohort keys the generator reads (``sites``, ``af_max``);
- ``expect``: the routes the cell exists for (``scatter_launches``:
  ``"zero"`` or ``"positive"``; ``sketch_jobs``: ``"all"`` or ``"none"``).

Every seed gets the same number of distinct jobs; only their sites and
order differ.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

__all__ = ["Job", "plan"]


@dataclasses.dataclass
class Job:
    key: int  # which distinct job of the rotation
    argv: List[str]  # the ``pca`` command line, as the CLI parses it
    lo: int  # the sites the job's region holds: [lo, hi)
    hi: int


def _regions(cohort, mix, seed):
    start = int(cohort.positions[0])
    end = int(cohort.positions[-1]) + 1
    spec = mix["regions"]
    if spec == "segment":
        return [(start, end)]
    span = int(spec["span_bp"])
    count = (end - start) // span
    if count < 1:
        raise ValueError(f"the segment holds no region of {span} bases")
    bounds = [(start + i * span, start + (i + 1) * span) for i in range(count)]
    order = np.random.default_rng([seed, 2]).permutation(count)
    return [bounds[i] for i in order]


def plan(config: dict, mix: dict, cohort, root: str, seed: int,
         device: str = "cuda") -> List[Job]:
    """The distinct jobs of the rotation, in the order they run."""
    jobs = []
    for key, (start, end) in enumerate(_regions(cohort, mix, seed)):
        lo, hi = cohort.site_range(start, end)
        argv = [
            "pca",
            "--input-path", root,
            "--references", f"{cohort.contig}:{start}:{end}",
            "--variant-set-id", cohort.variant_set_id,
            "--num-pc", str(config["num_pc"]),
            "--pca-mode", mix["pca_mode"],
            "--sketch-seed", str(sketch_seed(seed)),
            "--device", device,
            *mix.get("flags", []),
        ]
        jobs.append(Job(key=key, argv=argv, lo=lo, hi=hi))
    return jobs


def sketch_seed(seed: int) -> int:
    """The ``--sketch-seed`` a run's jobs pass: drawn from the run's seed,
    so the sketch's test matrix changes with it."""
    return int(np.random.default_rng([seed, 3]).integers(0, 2**31))
