"""The ingest stage's wall-clock by extraction and builder threads, on one GPU.

    python3 -m spark_examples_tpu_torch.tools.ingest_workers [--reps R]
        [--tables extraction,builders]

Two tables, each reading taken in turn in each of ``R`` rounds (default 3).

**builders**: ``chip_smoke.py`` phase 12's cohort on disk (the sparse
slice's N = 2504, V = 65536 written as a JSONL directory; its CSR sidecar
built once first) read with ``--input-path``'s CSR-direct tier in ``--pca-mode
auto``: ``driver.ingest_gramian()`` with the card synchronized at
``--ingest-workers`` 1, 2, 4 and 8 (the builder threads of the packed-block
stage), each with the native host core's ``csr_to_packed_blocks`` and with
the numpy densify + ``np.packbits`` (``--native/--no-native``: which of the
two, or both, the default); with the wall-clock, the ms a block the build
took (the ``ingest_block_build_seconds`` histogram of the run), and G
bit-identical to the first reading's. :func:`builder_thread_table` is the
table alone, for a caller that holds the directory.

**extraction**: builds ``chip_smoke.py``'s two driver cohorts at N = 2504 — the sparse
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
import shutil
import statistics
import subprocess
import tempfile
import time

import torch

from spark_examples_tpu_torch import cuda_build, native, obs
from spark_examples_tpu_torch.arrays.blocks import packed_blocks_from_csr
from spark_examples_tpu_torch.genomics.fixtures import (
    DEFAULT_VARIANT_SET_ID,
    synthetic_cohort,
)
from spark_examples_tpu_torch.genomics.sources import JsonlSource
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


BUILDER_THREADS = (1, 2, 4, 8)


class NumpyPackDriver(VariantsPcaDriver):
    """The driver with the numpy densify + ``np.packbits`` build of the CSR
    tier in place of the native scatter (``native=False``)."""

    def get_similarity_matrix_csr(self, csr_pairs):
        blocks = packed_blocks_from_csr(
            self._restrict_csr(csr_pairs),
            self.cohort.size,
            self.conf.block_variants,
            workers=self._block_builder_workers(),
            attempt=self._build_attempt,
            native=False,
        )
        return self._blocks_to_gramian(blocks, prepacked=True)


def _build_seconds(mode):
    """(sum, count) of the process's ``ingest_block_build_seconds{mode}``."""
    h = obs.get_registry().histogram(
        "ingest_block_build_seconds",
        "Per-block build latency (CSR window -> packed block)",
    ).labels(mode=mode)
    return h.sum, h.count


def builder_thread_table(root, reps=3, threads=BUILDER_THREADS,
                         natives=(True, False), device="cuda"):
    """Warm ``auto`` ``ingest_gramian()`` over the cohort directory ``root``
    at each builder-thread count, native and numpy build: prints every
    reading and returns ``{(native, threads): {"s": median seconds,
    "ms_per_block": median, "readings": [...]}}``. G must be bit-identical
    across every reading."""
    JsonlSource(root)._ensure_csr()  # the sidecar, built once
    ref = None
    readings = {(n, t): [] for n in natives for t in threads}
    for rnd in range(reps):
        for use_native in natives:
            cls = VariantsPcaDriver if use_native else NumpyPackDriver
            mode = "native" if use_native else "python"
            for t in threads:
                before = _build_seconds(mode)
                s, g, _ = timed_ingest(
                    cls, JsonlSource(root), "auto", dict(ingest_workers=t),
                    device)
                after = _build_seconds(mode)
                blocks = after[1] - before[1]
                ms = (after[0] - before[0]) / max(blocks, 1) * 1e3
                if ref is None:
                    ref = g
                elif not torch.equal(g, ref):
                    raise SystemExit(f"builders {mode} x{t}: G differs")
                readings[(use_native, t)].append((s, ms))
                print(f"  builders round {rnd} {mode} x{t}: {s:.4f} s, "
                      f"{blocks} blocks, {ms:.3f} ms a block", flush=True)
    table = {}
    for key, values in readings.items():
        table[key] = {
            "s": statistics.median(v[0] for v in values),
            "ms_per_block": statistics.median(v[1] for v in values),
            "readings": values,
        }
        print(f"builders {'native' if key[0] else 'python'} x{key[1]}: "
              f"median {table[key]['s']:.4f} s, "
              f"{table[key]['ms_per_block']:.3f} ms a block")
    return table


def timed_ingest(cls, source, mode, kw, device="cuda"):
    conf = PcaConfig(
        variant_set_ids=[DEFAULT_VARIANT_SET_ID], pca_mode=mode,
        device=device, **kw,
    )
    with contextlib.redirect_stdout(io.StringIO()):
        driver = cls(conf, source)
        driver._sync()
        t0 = time.perf_counter()
        g = driver.ingest_gramian()
        driver._sync()
    return time.perf_counter() - t0, g, driver


def extraction_table(reps):
    """The extraction-thread settings over the two fixture cohorts."""
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
        for rnd in range(reps):
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


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--tables", default="builders,extraction",
                   help="comma-separated: builders, extraction")
    p.add_argument("--native", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="builders table: only the native build (--native) "
                   "or only the numpy build (--no-native); default both")
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
    cuda_build.build(["scatter_pairs", native.SOURCE])
    tables = args.tables.split(",")
    if "builders" in tables:
        root = tempfile.mkdtemp(prefix="ingest_workers_")
        try:
            t0 = time.perf_counter()
            n_variants, extra, _ = COHORTS["sparse"]
            synthetic_cohort(
                N_SAMPLES, n_variants, seed=0, population_structure=3,
                sparse_calls=True, **extra,
            ).dump(root)
            print(f"builders: phase 12's cohort written in "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)
            natives = (True, False) if args.native is None else (
                args.native,)
            builder_thread_table(root, args.reps, natives=natives)
        finally:
            shutil.rmtree(root, ignore_errors=True)
    if "extraction" in tables:
        extraction_table(args.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
