"""The mesh layer, the data-parallel regime, the pod, the pod sketch and
the process-group checkpoints across several cards.

    python3 -m spark_examples_tpu_torch.tools.multi_card [--samples N]
        [--variants V] [--device cuda|cpu]
        [--legs mesh,ranks,pod,sketch,podckpt,elastic]

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
   run's wall-clock from launch to exit, and the one process's;
3. **the pod**: C ranks of one process group run the driver over
   ``--input-path`` on meshes that span them (``data:C`` — a C×1 grid, no
   mirror — and ``data:C/2,model:2``, square for C = 4, with the mirror)
   in ``sparse``, sample-sharded ``auto``, sample-sharded ``stream`` and
   ``--no-sample-sharded auto`` (the replicated G); G gathered on rank 0
   must be the meshless G bit for bit and rank 0's rows the one process's
   within 1e-4; each rank's scatter launches, ``ingest+gramian`` and run
   seconds, and its launch to exit; then ``sparse`` on the square grid
   with ``--pod-pipeline-depth 0`` against 2 and
   ``--pod-coalesce-variants 0`` against 256 (protocol steps, seconds);
4. **the pod sketch**: C ranks run ``--pca-mode sketch`` on the same
   spanning meshes; rank 0's rows must be one process's sketch rows
   within 1e-4, with no scatter launch;
5. **pod checkpoints**: C ranks run ``--checkpoint-dir`` over 9 shards
   (``--bases-per-partition 10000``, one shard a round) on the square
   spanning mesh, G replicated and sample-sharded; every rank stalls after
   round 1's snapshot and the tool SIGKILLs them all; C fresh ranks resume
   from round 1, G bit-identical to the uncheckpointed G;
6. **elastic checkpoints**: C ranks run ``--elastic-checkpoint`` (one
   shard a unit); once every rank has written a lane the tool SIGKILLs
   them; C/2 ranks resume every lane and the rest of the units, G
   bit-identical.

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


# The pod leg's runs: (name, --pca-mode, sample_sharded, pipeline depth,
# coalesce variants) on each spanning mesh; the flag runs on the square
# grid only.
POD_RUNS = [
    ("sparse", "sparse", None, 2, 256),
    ("auto", "auto", True, 2, 256),
    ("stream", "stream", True, 2, 256),
    ("auto --no-sample-sharded", "auto", False, 2, 256),
]
POD_FLAG_RUNS = [
    ("sparse --pod-pipeline-depth 0", "sparse", None, 0, 256),
    ("sparse --pod-coalesce-variants 0", "sparse", None, 2, 0),
]


def _mesh_specs(cards: int):
    """``data:C`` and, for an even C above 2, ``data:C/2,model:2``."""
    specs = [f"data:{cards}"]
    if cards % 2 == 0 and cards > 2:
        specs.append(f"data:{cards // 2},model:2")
    return specs


def _pod_worker(root: str, out_dir: str, device: str) -> int:
    """One rank of the pod leg: every run of :data:`POD_RUNS` on every
    spanning mesh, in the same order on every rank."""
    from spark_examples_tpu_torch import obs
    from spark_examples_tpu_torch.parallel import (
        ShardedGramian,
        distributed,
        mesh_spans_processes,
    )

    t_start = time.perf_counter()
    assert distributed.initialize_from_env(device), "no process group"
    rank, world = distributed.process_index(), distributed.process_count()
    synced = obs.get_registry().counter(
        "sparse_pod_sync_total",
        "Pod-sparse per-window sync steps (header + carrier allgather) "
        "by outcome",
    ).labels(outcome="synced")
    source = JsonlSource(root)
    specs = _mesh_specs(world)
    report = {"rank": rank, "runs": {}}
    for spec in specs:
        runs = POD_RUNS + (POD_FLAG_RUNS if spec == specs[-1] else [])
        for name, mode, sharded, depth, coalesce in runs:
            conf = PcaConfig(
                variant_set_ids=[DEFAULT_VARIANT_SET_ID], device=device,
                pca_mode=mode, sample_sharded=sharded,
                pod_pipeline_depth=depth, pod_coalesce_variants=coalesce,
            )
            mesh = make_mesh(spec, device=device)
            assert mesh_spans_processes(mesh), spec
            steps0 = synced.value
            t0 = time.perf_counter()
            driver, coords, launches = _run(conf, source, mesh)
            run_s = time.perf_counter() - t0
            g = driver.g
            g = g.full() if isinstance(g, ShardedGramian) else g
            key = f"{spec} {name}"
            if rank == 0:
                np.save(os.path.join(out_dir, f"g {key}.npy"),
                        g.cpu().numpy())
                np.save(os.path.join(out_dir, f"rows {key}.npy"), coords)
            report["runs"][key] = {
                "run_s": run_s,
                "launches": launches,
                "steps": synced.value - steps0,
                "sparse": driver._sparse_selected(),
                "tiles": (sum(t is not None for t in driver.g.tiles.flat)
                          if isinstance(driver.g, ShardedGramian) else None),
                **{k: round(v, 6) for k, v in driver.timer.seconds.items()},
            }
    report["worker_s"] = time.perf_counter() - t_start
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    return 0


def _pod_leg(root, device, cards, g_ref, want, alone, coord_tol):
    """Leg 3: ``cards`` ranks of one process group on spanning meshes."""
    out_dir = tempfile.mkdtemp(prefix="multi_card_pod_")
    atexit.register(shutil.rmtree, out_dir, True)
    port = str(_free_port())
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "spark_examples_tpu_torch.tools.multi_card",
             "--pod-worker", root, out_dir, "--device", device],
            env={**os.environ, "MASTER_ADDR": "127.0.0.1",
                 "MASTER_PORT": port, "WORLD_SIZE": str(cards),
                 "RANK": str(r), "LOCAL_RANK": str(r)},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(cards)
    ]
    try:
        outs = [pr.communicate(timeout=900) for pr in procs]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
    exit_s = time.perf_counter() - t0
    for r, (pr, (_, e)) in enumerate(zip(procs, outs)):
        if pr.returncode:
            raise SystemExit(f"multi_card: pod rank {r}: {e[-3000:]}")
    reports = []
    for r in range(cards):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    summary = {"launch_to_exit_s": exit_s,
               "worker_s": [rep["worker_s"] for rep in reports], "runs": {}}
    for key in reports[0]["runs"]:
        mode = key.split(" ")[1]
        g = np.load(os.path.join(out_dir, f"g {key}.npy"))
        coords = np.load(os.path.join(out_dir, f"rows {key}.npy"))
        err = float(np.abs(coords - alone[mode]).max())
        oracle = float(np.abs(coords - want).max())
        if not np.array_equal(g, g_ref) or err > coord_tol:
            raise SystemExit(f"multi_card: pod {key}: G equal "
                             f"{np.array_equal(g, g_ref)}, rows {err:.3e} "
                             "from the one process's")
        per_rank = [rep["runs"][key] for rep in reports]
        summary["runs"][key] = {"max_abs_err": err, "oracle_err": oracle,
                                "ranks": per_rank}
        route = "sparse" if per_rank[0]["sparse"] else "dense"
        print(f"pod {key}: {cards} ranks, {route} route, G bit-identical, "
              f"rank 0's rows {err:.3e} from the one process's "
              f"({oracle:.3e} from the oracle); per rank: scatter "
              f"launches {[r['launches'] for r in per_rank]}, steps "
              f"{[r['steps'] for r in per_rank]}, ingest+gramian "
              f"{[r.get('ingest+gramian') for r in per_rank]} s, run "
              f"{[round(r['run_s'], 3) for r in per_rank]} s", flush=True)
    print(f"pod leg: {cards} ranks {exit_s:.2f} s launch to exit", flush=True)
    return summary


# The checkpoint legs' manifest: 9 shards of the cohort's region, one
# shard a round (pod) or a unit (elastic).
CKPT_BASES, CKPT_EVERY = 10_000, 1
# A shard stalled this long holds a rank until the tool kills it.
HOLD_S = 600


def _ckpt_conf(device, **kw):
    return PcaConfig(variant_set_ids=[DEFAULT_VARIANT_SET_ID], device=device,
                     bases_per_partition=CKPT_BASES,
                     checkpoint_every=CKPT_EVERY, **kw)


def _hold_after(shards: int):
    """A fault plan that stalls this rank's shard ingest after ``shards``
    shards (the rank then waits to be killed)."""
    from spark_examples_tpu_torch.resilience import faults
    from spark_examples_tpu_torch.resilience.faults import FaultPlan, FaultRule

    faults.install_plan(FaultPlan(rules=[FaultRule(
        site="ingest.shard", kind="stall", stall_s=HOLD_S, after=shards)]))


def _scatter_probe(device: str):
    """Seconds of this process's first and second sketch scatter updates
    on ``device``, before any pod run (a 2504-row panel and one
    8192-variant window, the card synced around each): a cost that a
    process pays once shows as their difference."""
    from spark_examples_tpu_torch.ops.sketch import _sketch_scatter_update

    rng = np.random.default_rng(0)
    n, l = 2504, 13
    lens = rng.integers(1, 9, size=8192)
    idx = np.concatenate([rng.choice(n, size=int(k), replace=False)
                          for k in lens])
    seconds = []
    for _ in range(2):
        y = torch.zeros((n, l), device=device)
        om = torch.ones((n + 1, l), device=device)
        om[n] = 0  # the carrier sentinel's row
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        _sketch_scatter_update(y, om, idx, lens)
        if device == "cuda":
            torch.cuda.synchronize()
        seconds.append(round(time.perf_counter() - t0, 6))
    return seconds


def _span_breakdown(tracer) -> dict:
    """Where a run's seconds went, from its spans: seconds and count by
    span name, each sketch pass's start and length, and the first and the
    longest window, every time in seconds from the run's start."""
    from spark_examples_tpu_torch.utils.tracing import (
        SKETCH_ACCUMULATE,
        SKETCH_WINDOW,
    )

    events = [e for e in tracer.to_chrome()["traceEvents"]
              if e.get("ph") == "X"]
    counts = tracer.stage_counts()
    out = {"seconds": {k: [round(v, 6), counts[k]]
                       for k, v in tracer.stage_seconds().items()},
           "passes": [[e["args"].get("sketch_pass"), round(e["ts"] / 1e6, 6),
                       round(e["dur"] / 1e6, 6)] for e in events
                      if e["name"] == SKETCH_ACCUMULATE]}
    wins = [e for e in events if e["name"] == SKETCH_WINDOW]
    if wins:
        first = min(wins, key=lambda e: e["ts"])
        longest = max(wins, key=lambda e: e["dur"])
        out["first_window"] = [round(first["ts"] / 1e6, 6),
                               round(first["dur"] / 1e6, 6)]
        out["longest_window"] = [round(longest["ts"] / 1e6, 6),
                                 round(longest["dur"] / 1e6, 6),
                                 longest["args"].get("route")]
    return out


def _leg_worker(leg: str, root: str, out_dir: str, phase: str,
                device: str) -> int:
    """One rank of the sketch and checkpoint legs.

    - ``sketch``: ``--pca-mode sketch`` on every spanning mesh;
    - ``podckpt``: ``--checkpoint-dir`` on the square spanning mesh with G
      replicated (``phase`` ``replicated-*``) or sample-sharded
      (``tiled-*``): ``*-kill`` stalls after the first round's snapshot
      (the tool kills the rank), ``*-resume`` resumes;
    - ``elastic``: ``--elastic-checkpoint`` with no mesh: ``kill`` stalls
      after one unit, ``resume`` (at another world size) resumes.
    """
    from spark_examples_tpu_torch.parallel import (
        ShardedGramian,
        distributed,
        mesh_spans_processes,
    )

    t_start = time.perf_counter()
    assert distributed.initialize_from_env(device), "no process group"
    rank, world = distributed.process_index(), distributed.process_count()
    source = JsonlSource(root)
    report = {"rank": rank, "world": world, "runs": {}}
    if leg == "sketch":
        from spark_examples_tpu_torch import obs

        report["scatter_probe_s"] = _scatter_probe(device)
        for spec in _mesh_specs(world):
            mesh = make_mesh(spec, device=device)
            assert mesh_spans_processes(mesh), spec
            conf = PcaConfig(variant_set_ids=[DEFAULT_VARIANT_SET_ID],
                             device=device, pca_mode="sketch")
            tracer = obs.SpanTracer()
            obs.set_tracer(tracer)
            t0 = time.perf_counter()
            try:
                driver, coords, launches = _run(conf, source, mesh)
            finally:
                obs.set_tracer(None)
            if rank == 0:
                np.save(os.path.join(out_dir, f"rows {spec}.npy"), coords)
            report["runs"][spec] = {
                "run_s": time.perf_counter() - t0, "launches": launches,
                "n_padded": int(driver.g.y.shape[0]),
                **{k: round(v, 6) for k, v in driver.timer.seconds.items()},
                "spans": _span_breakdown(tracer),
            }
    else:
        if leg == "podckpt":
            layout, step = phase.split("-")
            kw = dict(checkpoint_dir=os.path.join(out_dir, layout),
                      sample_sharded=layout == "tiled")
            mesh = make_mesh(_mesh_specs(world)[-1], device=device)
        else:
            step = phase
            kw = dict(checkpoint_dir=os.path.join(out_dir, "elastic"),
                      elastic_checkpoint=True)
            mesh = None
        if step == "kill":
            _hold_after(1)
        out = io.StringIO()
        t0 = time.perf_counter()
        scatter_kernel.SCATTER_KERNEL_LAUNCHES = 0
        with contextlib.redirect_stdout(out):
            driver = VariantsPcaDriver(_ckpt_conf(device, **kw), source,
                                       mesh=mesh)
            g = driver.get_similarity_matrix_checkpointed()
            g = g.full() if isinstance(g, ShardedGramian) else g
            g = g.cpu().numpy()
        if rank == 0:
            np.save(os.path.join(out_dir, f"g {phase}.npy"), g)
        report["runs"][phase] = {
            "s": time.perf_counter() - t0,
            "shards_read": source.stats.partitions,
            "launches": scatter_kernel.SCATTER_KERNEL_LAUNCHES,
            "lines": [ln for ln in out.getvalue().splitlines()
                      if ln.startswith(("Resuming", "Elastic"))],
        }
    report["worker_s"] = time.perf_counter() - t_start
    with open(os.path.join(out_dir, f"{leg} {phase} rank{rank}.json"),
              "w") as f:
        json.dump(report, f)
    return 0


def _spawn_ranks(leg, root, out_dir, phase, device, cards, kill_when=None):
    """``cards`` ranks of one process group running :func:`_leg_worker`.
    With ``kill_when``, every rank is SIGKILLed once it returns True (the
    ranks are then held by a stalled shard). Returns (seconds from launch
    to exit, the rank reports or None after a kill)."""
    port = str(_free_port())
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "spark_examples_tpu_torch.tools.multi_card",
             "--leg-worker", leg, root, out_dir, phase, "--device", device],
            env={**os.environ, "MASTER_ADDR": "127.0.0.1",
                 "MASTER_PORT": port, "WORLD_SIZE": str(cards),
                 "RANK": str(r), "LOCAL_RANK": str(r)},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(cards)
    ]
    try:
        if kill_when is not None:
            deadline = time.perf_counter() + HOLD_S / 2
            while not kill_when():
                dead = [r for r, pr in enumerate(procs) if pr.poll() is not None]
                if dead or time.perf_counter() > deadline:
                    errs = [pr.communicate()[1][-2000:] for pr in procs
                            if pr.poll() is not None]
                    raise SystemExit(f"multi_card: {leg} {phase}: ranks "
                                     f"{dead} ended before the kill: {errs}")
                time.sleep(0.05)
            for pr in procs:
                pr.kill()
            for pr in procs:
                pr.wait(timeout=60)
            return time.perf_counter() - t0, None
        outs = [pr.communicate(timeout=900) for pr in procs]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
    for r, (pr, (_, e)) in enumerate(zip(procs, outs)):
        if pr.returncode:
            raise SystemExit(f"multi_card: {leg} {phase} rank {r}: "
                             f"{e[-3000:]}")
    reports = []
    for r in range(cards):
        with open(os.path.join(out_dir, f"{leg} {phase} rank{r}.json")) as f:
            reports.append(json.load(f))
    return time.perf_counter() - t0, reports


def _sketch_leg(root, device, cards, alone, coord_tol):
    """Leg 4: the pod sketch on every spanning mesh against one process's
    sketch."""
    out_dir = tempfile.mkdtemp(prefix="multi_card_sketch_")
    atexit.register(shutil.rmtree, out_dir, True)
    exit_s, reports = _spawn_ranks("sketch", root, out_dir, "run", device,
                                   cards)
    summary = {"launch_to_exit_s": exit_s, "runs": {}}
    for spec in reports[0]["runs"]:
        coords = np.load(os.path.join(out_dir, f"rows {spec}.npy"))
        err = float(np.abs(coords - alone).max())
        per_rank = [rep["runs"][spec] for rep in reports]
        if err > coord_tol or any(r["launches"] for r in per_rank):
            raise SystemExit(f"multi_card: pod sketch {spec}: rows {err:.3e} "
                             "from the one process's, launches "
                             f"{[r['launches'] for r in per_rank]}")
        if per_rank[0]["n_padded"] % cards:
            raise SystemExit(f"multi_card: pod sketch {spec}: n_padded "
                             f"{per_rank[0]['n_padded']}")
        summary["runs"][spec] = {"max_abs_err": err, "ranks": per_rank}
        print(f"pod sketch {spec}: {cards} ranks, rank 0's rows {err:.3e} "
              f"from the one process's sketch; per rank: ingest+gramian "
              f"{[r.get('ingest+gramian') for r in per_rank]} s, pca "
              f"{[r.get('pca') for r in per_rank]} s, run "
              f"{[round(r['run_s'], 3) for r in per_rank]} s", flush=True)
        for rank, r in enumerate(per_rank):
            print(f"  rank {rank} spans: {json.dumps(r['spans'])}",
                  flush=True)
    print("pod sketch leg: each rank's first and second sketch scatter "
          f"updates before its runs: "
          f"{[rep['scatter_probe_s'] for rep in reports]} s", flush=True)
    print(f"pod sketch leg: {cards} ranks {exit_s:.2f} s launch to exit",
          flush=True)
    return summary


def _snapshots_at_round_one(directory, cards, tiled):
    name = ("gramian_sharded_snapshot.npz" if tiled
            else "gramian_snapshot.npz")
    for r in range(cards):
        path = os.path.join(directory, f"host-{r}", name)
        try:
            with np.load(path) as z:
                if int(z["shards_done"]) < 1:
                    return False
        except (OSError, ValueError, KeyError):
            return False
    return True


def _checkpoint_legs(root, device, cards, g_ckpt, legs):
    """Legs 5 and 6: a pod checkpoint killed and resumed on both layouts,
    and an elastic run of ``cards`` ranks killed and resumed at half as
    many. Every resumed G must be ``g_ckpt`` bit for bit."""
    out_dir = tempfile.mkdtemp(prefix="multi_card_ckpt_")
    atexit.register(shutil.rmtree, out_dir, True)
    summary = {}

    def resumed(name, phase, n_ranks, want_line):
        exit_s, reports = _spawn_ranks(name, root, out_dir, phase, device,
                                       n_ranks)
        g = np.load(os.path.join(out_dir, f"g {phase}.npy"))
        runs = [rep["runs"][phase] for rep in reports]
        lines = runs[0]["lines"]
        if not np.array_equal(g, g_ckpt):
            raise SystemExit(f"multi_card: {name} {phase}: G is not the "
                             "uncheckpointed G")
        if not any(ln.startswith(want_line) for ln in lines):
            raise SystemExit(f"multi_card: {name} {phase}: {lines}")
        if any(r["launches"] for r in runs):
            raise SystemExit(f"multi_card: {name} {phase} launched the "
                             "scatter kernel")
        return {"launch_to_exit_s": exit_s, "lines": lines,
                "shards_read": [r["shards_read"] for r in runs],
                "s": [round(r["s"], 6) for r in runs]}

    for layout in ("replicated", "tiled") if "podckpt" in legs else ():
        directory = os.path.join(out_dir, layout)
        kill_s, _ = _spawn_ranks(
            "podckpt", root, out_dir, f"{layout}-kill", device, cards,
            kill_when=lambda: _snapshots_at_round_one(
                directory, cards, layout == "tiled"))
        rec = resumed("podckpt", f"{layout}-resume", cards,
                      "Resuming pod ingest from round 1/")
        rec["killed_after_s"] = kill_s
        summary[f"pod checkpoint {layout}"] = rec
        print(f"pod checkpoint, G {layout}: {cards} ranks SIGKILLed "
              f"{kill_s:.2f} s after launch, at round 1's snapshots; the "
              f"resume ({rec['lines'][0]}) read {rec['shards_read']} shards, "
              f"G bit-identical, {rec['launch_to_exit_s']:.2f} s launch to "
              f"exit", flush=True)
    if "elastic" in legs:
        lanes = os.path.join(out_dir, "elastic", "elastic")

        def all_ranks_banked():
            try:
                names = [f for f in os.listdir(lanes)
                         if f.startswith("lane-") and f.endswith(".npz")]
            except OSError:
                return False
            return len(names) >= cards

        kill_s, _ = _spawn_ranks("elastic", root, out_dir, "kill", device,
                                 cards, kill_when=all_ranks_banked)
        half = max(1, cards // 2)
        rec = resumed("elastic", "resume", half,
                      f"Elastic resume: {cards}/")
        rec["killed_after_s"] = kill_s
        summary[f"elastic {cards} -> {half} ranks"] = rec
        print(f"elastic: {cards} ranks SIGKILLed {kill_s:.2f} s after launch "
              f"with a lane each; {half} ranks resumed ({rec['lines'][0]}), "
              f"read {rec['shards_read']} shards, G bit-identical, "
              f"{rec['launch_to_exit_s']:.2f} s launch to exit", flush=True)
    return summary


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv[:1] == ["--pod-worker"]:
        w = argparse.ArgumentParser()
        w.add_argument("--pod-worker", nargs=2, metavar=("ROOT", "OUT"))
        w.add_argument("--device", default="cuda")
        a = w.parse_args(argv)
        return _pod_worker(*a.pod_worker, a.device)
    if argv[:1] == ["--leg-worker"]:
        w = argparse.ArgumentParser()
        w.add_argument("--leg-worker", nargs=4,
                       metavar=("LEG", "ROOT", "OUT", "PHASE"))
        w.add_argument("--device", default="cuda")
        a = w.parse_args(argv)
        return _leg_worker(*a.leg_worker, a.device)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--samples", type=int, default=2504)
    p.add_argument("--variants", type=int, default=65536)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--coord-tol", type=float, default=1e-4,
                   help="coordinate bar (default: the oracle's 1e-4)")
    p.add_argument("--cards", type=int, default=None,
                   help="cards (ranks) to use; default: every card, 4 on "
                   "the CPU")
    p.add_argument("--legs", default="mesh,ranks,pod,sketch,podckpt,elastic",
                   help="comma-separated legs to run (default all six)")
    args = p.parse_args(argv)
    legs = set(args.legs.split(","))
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
    plain, plain_coords, _ = _run(PcaConfig(pca_mode="sparse", **base),
                                  source)
    g_ref = plain.g.cpu().numpy()
    want, _ = mllib_principal_components_reference(g_ref, 2)
    summary = {"cards": cards, "card": smi[0], "mesh": {}, "ranks": {}}

    # 1. single-controller meshes over every card -------------------------
    specs = _mesh_specs(cards) if "mesh" in legs else []
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
    for mode in ("auto", "sparse") if "ranks" in legs else ():
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

    # 3. the pod: meshes that span the ranks --------------------------------
    if "pod" in legs:
        alone = {"sparse": plain_coords}
        for mode in ("auto", "stream"):
            _, alone[mode], _ = _run(PcaConfig(pca_mode=mode, **base), source)
        summary["pod"] = _pod_leg(root, args.device, cards, g_ref, want,
                                  alone, args.coord_tol)

    # 4. the pod sketch; 5 and 6. pod and elastic checkpoints --------------
    if "sketch" in legs:
        _, sketch_alone, _ = _run(PcaConfig(pca_mode="sketch", **base),
                                  source)
        summary["sketch"] = _sketch_leg(root, args.device, cards,
                                        sketch_alone, args.coord_tol)
    if legs & {"podckpt", "elastic"}:
        g_ckpt = VariantsPcaDriver(
            _ckpt_conf(args.device), source).ingest_gramian().cpu().numpy()
        if not np.array_equal(g_ckpt, g_ref):
            raise SystemExit("multi_card: the 9-shard G is not the G")
        summary["checkpoints"] = _checkpoint_legs(root, args.device, cards,
                                                  g_ckpt, legs)
    print(smi[0])
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
