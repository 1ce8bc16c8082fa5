"""The mesh layer and the data-parallel regime across several cards.

    python3 -m spark_examples_tpu_torch.tools.multi_card [--samples N]
        [--variants V] [--device cuda|cpu]

Over ``chip_smoke.py``'s sparse-slice cohort (N = 2504, V = 65536 rare
variants, ``synthetic_cohort(seed=0, population_structure=3,
rare_variant_af=0.01, sparse_calls=True)``) written as a JSONL directory:

1. **single-controller meshes over every card** of the host (``data:C``
   and, for an even card count C, ``data:C/2,model:2``): the driver in
   ``sparse``, sample-sharded ``auto`` and ``stream`` with each tile on its
   own card, its ``ingest+gramian`` and ``pca`` seconds, its scatter
   launches (one a tile and scatter window), G bit-identical to the
   meshless G and coordinates within 1e-4 of the host float64 oracle;
2. **data-parallel ranks**: C processes of one process group (NCCL, rank
   r on ``cuda:r``; the launcher's variables set by this tool) run ``pca
   --input-path`` in ``auto`` and ``sparse``; rank 0's rows must be the
   one-process rows within 1e-4 and the other ranks print none; each
   run's wall-clock from launch to exit, and the one process's.

Prints each reading, the card's name and power limit, and one JSON line.
``--device cpu`` tries the tool at a small size without a card (the CPU's
device repeats as a mesh's cards and the ranks join a gloo group; pass a
small ``--samples``/``--variants``, and a looser ``--coord-tol``: a small
rare cohort has no spectral gap, so its coordinates depend on the
eigensolver).
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import io
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from spark_examples_tpu_torch.genomics.fixtures import (
    DEFAULT_VARIANT_SET_ID,
    synthetic_cohort,
)
from spark_examples_tpu_torch.genomics.sources import JsonlSource
from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
from spark_examples_tpu_torch.ops import scatter_kernel
from spark_examples_tpu_torch.ops.pcoa import (
    mllib_principal_components_reference,
)
from spark_examples_tpu_torch.parallel import make_mesh
from spark_examples_tpu_torch.utils.config import PcaConfig


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tsv(out: str):
    return [line.split("\t") for line in out.splitlines()
            if line.count("\t") == 3]


def _run(conf, source, mesh=None):
    out = io.StringIO()
    scatter_kernel.SCATTER_KERNEL_LAUNCHES = 0
    with contextlib.redirect_stdout(out):
        driver = VariantsPcaDriver(conf, source, mesh=mesh)
        result = driver.run()
    coords = np.array([[p1, p2] for _, p1, p2 in result])
    return driver, coords, scatter_kernel.SCATTER_KERNEL_LAUNCHES


def _cli(root, device, mode, env=None):
    return subprocess.Popen(
        [sys.executable, "-m", "spark_examples_tpu_torch.cli.main", "pca",
         "--input-path", root, "--pca-mode", mode, "--device", device],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--samples", type=int, default=2504)
    p.add_argument("--variants", type=int, default=65536)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--coord-tol", type=float, default=1e-4,
                   help="coordinate bar (default: the oracle's 1e-4)")
    p.add_argument("--cards", type=int, default=None,
                   help="cards (ranks) to use; default: every card, 4 on "
                   "the CPU")
    args = p.parse_args(argv)
    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("multi_card: CUDA is not available")
    cards = args.cards or (torch.cuda.device_count() if on_card else 4)
    if on_card:
        from spark_examples_tpu_torch import cuda_build

        cuda_build.build(["scatter_pairs", "genomics_native"])
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()
    else:
        smi = ["cpu"]
    print(f"cards: {cards}; {smi[0]}", flush=True)

    n = args.samples
    root = tempfile.mkdtemp(prefix="multi_card_")
    atexit.register(shutil.rmtree, root, True)
    synthetic_cohort(n, args.variants, seed=0, population_structure=3,
                     rare_variant_af=0.01, sparse_calls=True).dump(root)
    source = JsonlSource(root)
    base = dict(variant_set_ids=[DEFAULT_VARIANT_SET_ID], device=args.device)
    plain, _, _ = _run(PcaConfig(pca_mode="sparse", **base), source)
    g_ref = plain.g.cpu().numpy()
    want, _ = mllib_principal_components_reference(g_ref, 2)
    summary = {"cards": cards, "card": smi[0], "mesh": {}, "ranks": {}}

    # 1. single-controller meshes over every card -------------------------
    specs = [f"data:{cards}"]
    if cards % 2 == 0 and cards > 2:
        specs.append(f"data:{cards // 2},model:2")
    devices = ([torch.device("cuda", i) for i in range(cards)] if on_card
               else None)
    for spec in specs:
        mesh = make_mesh(spec, devices=devices, device=args.device)
        for mode, sharded in (("sparse", True), ("auto", True),
                              ("stream", False)):
            conf = PcaConfig(pca_mode=mode, sample_sharded=sharded, **base)
            t0 = time.perf_counter()
            driver, coords, launches = _run(conf, source, mesh)
            run_s = time.perf_counter() - t0
            g = driver.g.full().cpu().numpy()
            err = float(np.abs(coords - want).max())
            if not np.array_equal(g, g_ref) or err > args.coord_tol:
                raise SystemExit(f"multi_card: {spec} {mode}: G equal "
                                 f"{np.array_equal(g, g_ref)}, coordinates "
                                 f"{err:.3e} from the oracle")
            tiles = {str(t.device) for t in driver.g.tiles.flat}
            stages = {k: round(v, 6) for k, v in
                      driver.timer.seconds.items()}
            summary["mesh"][f"{spec} {mode}"] = {
                "run_s": run_s, "launches": launches, **stages}
            print(f"{spec} {mode}: tiles {driver.g.tiles.shape} on "
                  f"{sorted(tiles)}, {launches} scatter launches, G "
                  f"bit-identical, coordinates {err:.3e} from the oracle, "
                  f"run() {run_s:.3f} s, stages {json.dumps(stages)}",
                  flush=True)

    # 2. data-parallel ranks of one process group -------------------------
    for mode in ("auto", "sparse"):
        t0 = time.perf_counter()
        alone = _cli(root, args.device, mode)
        out, err_text = alone.communicate(timeout=600)
        alone_s = time.perf_counter() - t0
        if alone.returncode:
            raise SystemExit(f"multi_card: one process: {err_text[-2000:]}")
        port = str(_free_port())
        t0 = time.perf_counter()
        procs = [
            _cli(root, args.device, mode, env={
                **os.environ, "MASTER_ADDR": "127.0.0.1",
                "MASTER_PORT": port, "WORLD_SIZE": str(cards),
                "RANK": str(r), "LOCAL_RANK": str(r)})
            for r in range(cards)
        ]
        try:
            outs = [pr.communicate(timeout=600) for pr in procs]
        finally:
            for pr in procs:
                if pr.poll() is None:
                    pr.kill()
        ranks_s = time.perf_counter() - t0
        for r, (pr, (o, e)) in enumerate(zip(procs, outs)):
            if pr.returncode:
                raise SystemExit(f"multi_card: rank {r}: {e[-2000:]}")
            if r and _tsv(o):
                raise SystemExit(f"multi_card: rank {r} printed rows")
        got, ref = _tsv(outs[0][0]), _tsv(out)
        if [x[:2] for x in got] != [x[:2] for x in ref] or len(got) != n:
            raise SystemExit("multi_card: rank 0's rows name other samples")
        err = max(abs(float(a[i]) - float(b[i]))
                  for a, b in zip(got, ref) for i in (2, 3))
        if err > args.coord_tol:
            raise SystemExit(f"multi_card: rank 0's rows {err:.3e} off")
        summary["ranks"][mode] = {"ranks_s": ranks_s, "one_process_s": alone_s,
                                  "max_abs_err": err}
        print(f"pca --input-path --pca-mode {mode}: {cards} ranks "
              f"{ranks_s:.2f} s launch to exit, one process {alone_s:.2f} s; "
              f"rank 0's rows {err:.3e} from the one process's, the others "
              f"print none", flush=True)
    print(smi[0])
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
