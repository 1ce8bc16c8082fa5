"""The control of the comparison: the reference put in the program's place,
computed one precision step below the configuration's (bfloat16 for its
float32), at the cell's own size. It has to come out as not correct.

    python3 -m benchmark.control --workload kg1000.chrom --seeds 1 2 3

For each seed it draws the cell's cohort, works out every distinct job's
outputs with the reference in float64 and with the control, compares them
with the benchmark's own comparison (``check.gaps``), and prints one JSON
line per seed: each number, its limit, and whether the control passed.
The program does not run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import check, cohort as cohort_mod, jobs as jobs_mod
from benchmark import spec as spec_mod

__all__ = ["control_numbers", "main"]


def control_numbers(spec, name: str, seed: int, device: str) -> dict:
    """The control's worst reading of each number of cell ``name``."""
    cell = spec.cell(name)
    cohort = cohort_mod.draw(cell.config, cell.mix, seed)
    jobs = jobs_mod.plan(cell.config, cell.mix, cohort, "", seed, device)
    worst = {}
    for job in jobs:
        want = check.reference_outputs(cell, cohort, job, seed, device)
        got = check.reference_outputs(cell, cohort, job, seed, device,
                                      control=True)
        found = check.gaps(want, coords=got["coords"][:, :2],
                           g=got.get("g"), panel=got.get("panel"))
        for key, value in found.items():
            worst[key] = max(worst.get(key, 0.0), value)
    limits = cell.config["limits"]
    numbers = {k: {"value": v, "limit": limits[k]} for k, v in worst.items()}
    return {
        "workload": name,
        "seed": seed,
        "numbers": numbers,
        "control_passed": all(n["value"] <= n["limit"]
                              for n in numbers.values()),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    spec = spec_mod.load()
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = control_numbers(spec, args.workload, seed, args.device)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
