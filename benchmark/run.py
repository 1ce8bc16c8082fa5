"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m benchmark.run ...``) from the root of a checkout. The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit.
The same numbers are the last lines of standard error.

The run exits non-zero and prints no result where fewer CUDA cards are
visible than the cell's ``chips``, and where ``jax``, ``jaxlib``, ``flax``
or the JAX package ``spark_examples_tpu`` is loaded once the window has
closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

# Top-level module names that may not be loaded in a run's process.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "spark_examples_tpu"})


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is forbidden (the port's
    ``spark_examples_tpu_torch`` is not ``spark_examples_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from benchmark import harness, spec

    bench = spec.load(_ROOT)
    chips = bench.cell(args.workload).chips
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < chips:
        print(f"benchmark: {args.workload} runs on {chips} CUDA card(s); "
              f"{seen} visible", file=sys.stderr)
        return 2

    result = harness.run_cell(
        bench, args.workload, args.seed % 2**63, args.seconds,
        bool(args.trace), device="cuda", t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
