"""The ingest stage's wall-clock by extraction threads, on one GPU.

    python3 -m spark_examples_tpu_torch.tools.ingest_workers [--reps R]

Builds ``chip_smoke.py``'s two driver cohorts at N = 2504 — the sparse
slice (V = 65536 rare variants, ``--pca-mode sparse``) and the dense
default (V = 16384 common variants at about 25 % carrier density,
``--pca-mode auto``) — and times ``driver.ingest_gramian()`` with the card
synchronized under five ingest settings, taken in turn in each of ``R``
rounds (default 3) after one warm-up call per cohort:

- ``stream``: the cohort's one shard streams into the block builder
  (``--ingest-workers 1``; the default count does the same on one shard);
- ``whole-1`` and ``whole-auto``: the shard is first extracted whole by
  ``ordered_parallel_map`` on one thread, or on the default count, before
  any block is built;
- ``shards-1`` and ``shards-auto``: ``--bases-per-partition 8192`` cuts
  the range into 10 shards, extracted by one thread (streamed) or by the
  default count of threads (each shard whole).

Every setting's G must equal ``stream``'s bit for bit. Prints each reading
and each setting's median, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import statistics
import subprocess
import time

import torch

from spark_examples_tpu_torch import cuda_build
from spark_examples_tpu_torch.genomics.fixtures import (
    DEFAULT_VARIANT_SET_ID,
    synthetic_cohort,
)
from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
from spark_examples_tpu_torch.utils.concurrency import ordered_parallel_map
from spark_examples_tpu_torch.utils.config import PcaConfig

N_SAMPLES = 2504
COHORTS = {
    "sparse": (65536, dict(rare_variant_af=0.01), "sparse"),
    "dense": (16384, {}, "auto"),
}
MANY_SHARDS = 8192  # bases per shard: 10 shards over the BRCA1 range


class WholeShardDriver(VariantsPcaDriver):
    """The driver with every shard extracted whole before its blocks are
    built, whatever the thread count."""

    def _parallel_shard_calls(self, vsid, shards):
        def extract(shard):
            return list(self.source.stream_carrying(
                vsid, shard, self.index.indexes,
                self.conf.min_allele_frequency,
            ))

        for calls in ordered_parallel_map(
            extract, list(shards), self._ingest_workers()
        ):
            yield from calls


SETTINGS = {
    "stream": (VariantsPcaDriver, dict(ingest_workers=1)),
    "whole-1": (WholeShardDriver, dict(ingest_workers=1)),
    "whole-auto": (WholeShardDriver, {}),
    "shards-1": (VariantsPcaDriver,
                 dict(ingest_workers=1, bases_per_partition=MANY_SHARDS)),
    "shards-auto": (VariantsPcaDriver,
                    dict(bases_per_partition=MANY_SHARDS)),
}


def timed_ingest(cls, source, mode, kw):
    conf = PcaConfig(
        variant_set_ids=[DEFAULT_VARIANT_SET_ID], pca_mode=mode,
        device="cuda", **kw,
    )
    with contextlib.redirect_stdout(io.StringIO()):
        driver = cls(conf, source)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = driver.ingest_gramian()
        torch.cuda.synchronize()
    return time.perf_counter() - t0, g, driver


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ingest_workers: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}; os.cpu_count "
          f"{os.cpu_count()}")
    cuda_build.build(["scatter_pairs"])
    for cell, (n_variants, extra, mode) in COHORTS.items():
        t0 = time.perf_counter()
        source = synthetic_cohort(
            N_SAMPLES, n_variants, seed=0, population_structure=3,
            sparse_calls=True, **extra,
        )
        print(f"{cell}: cohort {N_SAMPLES} x {n_variants} made in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        cls, kw = SETTINGS["stream"]
        _, ref, _ = timed_ingest(cls, source, mode, kw)  # warm-up
        readings = {name: [] for name in SETTINGS}
        for rnd in range(args.reps):
            for name, (cls, kw) in SETTINGS.items():
                s, g, driver = timed_ingest(cls, source, mode, kw)
                if not torch.equal(g, ref):
                    raise SystemExit(f"{cell} {name}: G differs")
                readings[name].append(s)
                print(f"  {cell} round {rnd} {name}: {s:.4f} s "
                      f"({len(driver._manifest())} shards, "
                      f"{driver._ingest_workers()} workers)", flush=True)
        for name, values in readings.items():
            print(f"{cell} {name}: median {statistics.median(values):.4f} s"
                  f" of " + ", ".join(f"{v:.4f}" for v in values))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
