#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, on a GPU host

Drives the port's paths through ``VariantsPcaDriver.run()`` at the 1000
Genomes phase-3 cohort width (N = 2504 samples): meshless
``pca --pca-mode sparse`` over V = 65536 rare variants, from the in-memory
fixture, from the same cohort on disk (``--input-path``, through the CSR
sidecar) and from the same directory served over HTTP (``--api-url``), and
the default ``pca`` (``--pca-mode auto``: dense-blockwise
ingest through the bit-packed pinned feed, then the fused finish); the
sketch engine at the biobank width (N = 2^20), alone and through the
driver over an on-disk cohort; the same cohort on one-card meshes, with the
kernel's tile path on rebased operands, and under a one-rank process
group; and holds every hand-written kernel against its plain PyTorch
version on the card. Phases, each of which exits non-zero
on failure:

1. device: the card's name, CUDA version, name and power limit;
2. build: every kernel of the path compiled from ``csrc/`` (timed), with
   the compiler's report of registers, shared memory and spills;
3. kernel vs plain version on the card, bit-identical (``torch.equal``),
   across square, rectangular, K ∈ {1, 8, 64, 512, 1024}, duplicate-carrier
   and all-sentinel cases, and the band kernel's edges: a partial last row
   band, a tile wide enough to split its columns, unsorted carriers, a
   variant and duplicates across a band edge, negative (rebased) indices;
   and one window run twice, bit-identical (the kernel is deterministic);
4. main path: kernel launch counts reset, one driver run, counts read;
   G bit-identical to a host float64 product of the same carrier lists
   (exact below 2^53, compared as int64); coordinates within 1e-4 of the
   host float64 MLlib-literal oracle after sign normalization; then a
   second run under ``torch.profiler``: device time by kernel, and the
   device's idle share of each stage;
5. kernel timings at the main path's own shapes (every scatter window of
   the cohort) and at the K = 8 and K = 512 shapes of phase 3: kernel,
   plain version, one-call library yardstick, the bound the card's memory
   and f32 rates set, and the library/kernel ratio;
6. the CLI in a subprocess on the card: ``--pca-mode sparse``, the
   default command (no ``--pca-mode``), and ``--input-path`` over phase 4's
   cohort written to disk with ``FixtureSource.dump`` (phase 12's
   directory; the run builds the CSR sidecar);
7. odd sample counts: ``gramian_accumulate_packed`` at N ∈ {12, 13, 2500}
   (shapes ``torch._int_mm`` refuses unpadded) equal to the host int64
   product; ``gramian`` and ``fused_forward`` given a numpy block compute
   on the card by default, G exact and coordinates within 1e-4 of the
   oracle;
8. the dense main path (``--pca-mode auto``, V = 16384 at about 25 %
   carrier density): scatter launch count reset, one driver run, count
   read (it must be 0: meshless ``auto`` routes dense, as in the JAX
   package); G bit-identical to the host product; coordinates within 1e-4
   of the host float64 oracle; ``fused`` and ``stream`` runs of the cohort
   agree within 1e-4; ``fused`` with ``--precise`` raises before ingest;
   the feed's count of pinned copies equals the block count in every run;
   then a second run under ``torch.profiler``: device time by kernel, the
   idle share per stage, and every feed copy from pinned memory;
9. the bench shape (N = 2504, V = 65536 in 8 blocks of 8192, ``bench.py``'s
   cohort formula) through ``pcoa_fused_blocks``: wall-clock, the
   north-star rate samples²·variants/s, the ``torch._int_mm`` time per
   block against its bound (2·N²·V int8 operations at 1,979 TOP/s), the
   host→device copy rate of one packed block from pinned memory, the
   feed's count of pinned copies equal to the block count in every run,
   and coordinates within 1e-4 of the oracle.

10. the biobank width of ``bench.py``'s sketch leg, uncut: N = 2^20
    samples, V = 2048 variants of 128 distinct carriers each (its
    formula, copied), one ``csr_windows`` window, k = 10, seed 0, through
    ``sketch_panel_blockwise`` and ``sketch_eig`` on the card: a warm run,
    then the best of 2 (seconds, samples per second), a ``torch.profiler``
    window (host/device split), peak card memory beside the documented
    panel bound and the 4 TiB of an f32 G; Y within 1e-5 relative
    (Frobenius) of a host float64 panel of the same CSR, row sums exact,
    every run's panel bit-identical, no scatter launch, under 2 GiB;
11. ``--pca-mode auto`` past the 4 GiB G bound: the driver on
    ``synthetic_cohort(40000, 4096, rare_variant_af=0.01)`` must return a
    ``SketchPanel`` with no scatter launch and under 2 GiB of card memory
    (stage times, route mix, idle share per stage from a profiled run
    with ``--sketch-power-iters 2``); the same windows all dense and all
    scattered give panels within 1e-5 of each other; a float64 oracle on
    the card (the V×V dual Xᵀ·H·X) gives the exact top 2, against which
    the sketch's error is printed; and on a common-variant cohort at the
    same width (``synthetic_cohort(40000, 256)``, whose spectrum has the
    gap the reference's top-k contract assumes), ``auto`` with
    ``--sketch-power-iters 2`` must meet ``SKETCH_TOPK_ATOL`` and
    ``SKETCH_TOPK_RTOL`` against that oracle;
12. ``pca --input-path`` over phase 4's cohort on disk, uncut (N = 2504,
    V = 65536): a ``--pca-mode sparse`` run that builds the sidecar (cold)
    and one that maps it (warm), each with the scatter launch count set to
    0 before and read after: it must equal phase 4's, and G must be phase
    4's bit for bit, coordinates within 1e-4 of the oracle; ``auto`` (the
    CSR-direct dense route): no scatter launch, one pinned copy per block,
    G bit-identical; the same ``auto`` run from the fixture source (the
    record loop) for comparison; ``--samples`` with the first 2000 callset
    ids: G the 2000 x 2000 corner; ``--ingest-order completion`` over 9
    shards on 4 threads: G bit-identical; a ``torch.profiler`` window over
    a warm ``auto`` and a warm ``sparse`` run (idle share per stage, the
    ingest host ranges and the threads they ran on); the sidecar's build,
    map and per-shard query times;
13. the biobank width through the driver, uncut: phase 10's cohort written
    as a JSONL directory (2^20 callsets, 2048 variants) and read with
    ``--input-path --pca-mode auto --num-pc 10``: a cold-sidecar, a warm
    and a profiled warm run must each return a ``SketchPanel``, launch no
    scatter kernel, stay under 2 GiB of card memory, and give phase 10's
    panel and coordinates bit for bit; stage times, samples per second,
    idle share per stage, and the ordinal lookup over 2^20 ids;
14. the network tier over HTTP, uncut: phase 12's directory behind the
    port's ``GenomicsServiceServer`` (a thread, 127.0.0.1, a bearer
    token), read through ``HttpVariantSource`` by the driver: ``sparse``
    over the binary frame tier (the scatter launch count set to 0 before
    and read after: it must be phase 4's; G phase 4's bit for bit; one
    frame fetched per shard), warm ``sparse`` and ``auto`` (no launch,
    one pinned copy per block) beside warm ``--input-path`` runs, the
    gzip record tier, one injected ``transport.http.request`` fault on
    ``/variants-csr`` (retried; G unchanged; IoStats clean), a profiled
    run (idle share, the host ranges), the frame tier's host steps timed
    alone (server slice and zlib encode, client decode and remap); then
    ``serve-cohort`` and ``pca --api-url --trace-out --metrics-out
    --manifest-out --fault-plan`` in subprocesses: the trace holds
    ``ingest.fetch`` and ``wire_frame_fetch``, the metrics phase 4's
    scatter windows, RPC latency samples and the one injected fault, the
    manifest names the card;
15. gRPC and the cohort mirror over phase 12's directory: the port's
    ``GenomicsServiceServer`` and ``GrpcGenomicsServer`` on one
    ``JsonlSource`` (127.0.0.1, a bearer token). With grpcio: ``sparse``
    and ``auto`` over the gRPC frame tier (the frame bytes), ``sparse`` over
    the record tier (cut to the first 2 of 9 10-kb shards, G bit-identical
    to the frame tier's over them), one injected ``transport.grpc.request``
    fault
    (retried), and ``serve-cohort --grpc-port`` with ``pca --api-url
    grpc://`` in subprocesses; without grpcio one line says the gRPC legs
    did not run. The mirror legs over HTTP, each on a fresh cache: a cold
    ``sparse`` run with the cold stream over 8 shards on 4 workers
    (``cold_stream_shards_total`` 8 fetched and 8 accumulated, the
    write-through joined and ``.complete``), warm ``sparse`` and ``auto``
    from that mirror with no frame, record or export request (a profiled
    run: the idle share), ``--mirror-mode light`` and ``--no-cold-stream``
    (download seconds and bytes), and a gRPC client warm over the HTTP
    client's cache. Every ``sparse`` run's scatter launches are counted
    (phase 4's count where the windows are phase 4's); G is phase 4's bit
    for bit in every leg, coordinates within 1e-4 of the oracle.
16. reads and PairHMM: ``PairHmmDriver`` at ``bench.py``'s PairHMM shape
    (2048 reads of 100 bases, seed 7, 10,000 bases a shard, batch 128;
    not cut): pipeline pairs/s (best of 2 after a warm-up), 64 sampled
    pairs within ``PAIRHMM_FORWARD_RTOL/ATOL`` of the float64
    ``pairhmm_forward_ref``, every pair within the bars of a ``--device
    cpu`` run, rows bit-identical at ``--pairhmm-batch`` 128 and 2048;
    bench.py's resident r128xh128 tile at B = 128 and 2048 (ms, pairs/s),
    a shuffled tile bit-identical, one tile under ``torch.profiler``
    (CUDA kernels per tile and per diagonal, device idle share); the
    coverage set, 15,000 reads over 50 kb (30x), scored with
    ``--pairhmm-batch 2048`` (wall-clock, host prep and forward), then
    ``reads-example 3`` over it in 5 shards and ``reads-example 4`` over
    a 30x tumor/normal pair: their files byte-identical to ``--device
    cpu``'s, example 4 recovering every somatic position; the bench
    directory behind the port's HTTP and gRPC servers and a warm mirror:
    rows bit-identical to the local run, the warm run asking for no reads;
    no scatter launch in the phase.
17. the host ingest core (``csrc/genomics_native.cpp``, built with ``g++``
    in phase 2 beside the kernels) and the resilience of ingest, over phase
    12's directory, uncut: (a) the cold sidecar built by the Python parse
    and by the native parse (timed; the two sidecars equal member by
    member), and the native parse on 1 thread, the auto count and 4
    threads, bit-identical; (b) warm ``sparse`` and ``auto`` with the
    native build under ``torch.profiler`` (G phase 4's bit for bit, the
    idle share of ``ingest+gramian``, phase 4's scatter launches) and the
    packed block of every window built native and with numpy (ms a block,
    byte-identical); (c) ``sparse`` and ``auto`` with ``--shard-retries 3``
    under a plan of ``ingest.stream`` error x2, ``ingest.build`` error x2
    and ``ingest.shard`` stall x2: G bit-identical, the scatter launches
    the fault-free run's, every rule that the route reaches fired (the
    ``sparse`` route builds no packed block, so ``ingest.build`` fires only
    under ``auto``), ``genomics_rpc_retries_total{transport="ingest"}``
    read; the same plan with ``--shard-retries 1`` raises; (d)
    ``--speculative-ingest`` at ``--ingest-workers 4`` over 33 shards with
    the 11th stalled 2 s once: the straggler line, G and coordinates
    bit-identical to the run without speculation, both wall-clocks; (e)
    ``tools/ingest_workers.py``'s builder-thread table (1, 2, 4, 8 threads,
    native and numpy, one rep).
18. delta and gang serving over phase 12's directory, uncut: the analysis
    tier set up by the CLI's own ``_analysis_tier`` (``serve-cohort
    --analyze --analyze-journal-dir``, deltas up to 16 samples, gangs up
    to 256) behind the port's HTTP server, driven with ``POST /analyze``
    and ``GET /jobs``: (a) a cold ``{}`` job, which under the journal takes
    the checkpointed dense-block route (0 scatter launches, rows equal the
    driver's run, G phase 4's), and a cold ``{}`` job on a tier without a
    journal, which takes the window route (phase 4's scatter launches, G
    phase 4's); (b) its cached resubmission
    (0 launches); (c) an 8-sample removal (a delta hit in ``/metrics``);
    (d) those 8 added back and 8 others dropped, then the same cohort on an
    engine whose only ancestor is (c)'s (a rank-8 correction), and the
    correction alone by the int8 product and by the ±1 scatter: every G
    phase 4's submatrix bit for bit, coordinates against the f64 oracle;
    (e) four 256-sample cohorts queued behind a held worker, one gang
    dispatch (``serving_gang_size``), each G bit-identical, and
    ``run_gang`` against four serial runs; (f) a sketch job leaving the
    delta index unchanged; (g) a ``pairhmm`` job over phase 16's reads
    directory equal to ``PairHmmDriver.run_rows``; (h) ``serve-cohort
    --analyze`` in a subprocess with a ``serving.job.kill`` fault, killed
    and restarted on its journal: the job replayed, a delta hit on the
    re-loaded G; (i) two tiers over one ``--store-dir`` with a 1 s lease:
    one replica's job killed, the survivor adopts and finishes it (a
    checkpointed cold run: 0 launches), the zombie's write refused. Each
    job's wall-clock, and the device idle share of a profiled cold job and
    a profiled rank-8 delta job; no job may record a delta ``fallback``.
19. checkpointed ingest, soft cancel, the job's resume, the bridge and
    ``--trace-dir`` over phase 12's directory (N = 2504, V = 65536, 9
    shards at ``--bases-per-partition 10000``, ``--checkpoint-every 3``: 3
    groups): (a) a checkpointed ``auto`` run, G phase 4's bit for bit, each
    snapshot's device-to-host copy and write timed apart, its bytes and its
    share of ``ingest+gramian``, against uncheckpointed runs in turns, and
    the JAX package's deflated write of the same G beside it; (b) an
    ``ingest.shard`` error on shard 4 with ``--shard-retries 1`` raises
    after the snapshot of 3 shards, a fresh driver resumes and ingests 6, G
    phase 4's; (c) a CLI ``pca --checkpoint-dir``, started with phase 18,
    whose ``SPARK_EXAMPLES_TPU_TORCH_SOFT_DEADLINE`` (launch + 60 s) passes
    during group 2 (the group's first shard stalled 60 s) exits 75 leaving
    the snapshot of 6 shards, with the margin by which group 1 beat the
    deadline, and a rerun resumes to phase 4's G; ``sparse`` with a future
    deadline launches phase 4's scatter windows and gives phase 4's G, with
    a past one exits 75 with 0 launches; (d) ``serve-cohort --analyze
    --analyze-journal-dir`` in a subprocess, SIGKILLed once its job's
    ``ckpt/<id>/gramian_snapshot.npz`` appears, restarted on the journal:
    the job resumes from its snapshot and its rows equal the driver's; (e)
    ``pca-bridge`` and ``ComputePca`` over ``serve-cohort --grpc-port`` fed
    phase 4's carrier lists, coordinates within 1e-4 of the f64 oracle,
    seconds per call and bytes sent; (f) a CLI ``pca --trace-dir`` run: the
    trace's size and its CUDA kernel events.
20. the mesh layer's single-controller half and the process group over
    phase 12's directory (N = 2504, V = 65536): (a) the driver on one-card
    meshes ``data:1`` and ``data:1,model:1``, ``sparse`` and ``auto`` with
    ``--sample-sharded`` (auto routes sparse: phase 4's scatter launches,
    through the tile scatter) and ``stream`` with ``--no-sample-sharded``
    (0 launches): G a tile grid, phase 4's bit for bit, coordinates within
    1e-4 of the f64 oracle; (b) phase 4's first scatter window re-based
    onto a 2x2 and a 1x3 grid of rectangular tiles, the kernel launched
    tile by tile: each tile equal to its plain version and to the full
    G's block, each timed against its bound; (c) ``sharded_pcoa`` below
    ``dense_eigh_limit``: the randomized eig, fixed and with ``eig_tol``
    (the JAX package's cap of 30 iterations), iterations, seconds and the
    distance to dense eigh, and the same eig over the implicitly centred
    tile grid (``CenteredGramian``) with a cap of 100 held within 1e-4 of
    dense eigh; (d) a
    cold ``AnalysisEngine`` job on a ``data:1`` mesh and a meshed
    ``TorchPcaBackend`` call, rows within 1e-4 of the meshless ones; (e) a
    CLI ``pca --mesh-shape data:1`` under a one-rank NCCL group
    (``MASTER_ADDR``/``WORLD_SIZE=1``), started first: the group is up and
    its rows are (a)'s.
21. the pod regime's per-rank work on one card (NCCL takes one rank a
    card, so the pod itself runs in ``spark_examples_tpu_torch/tools/
    multi_card.py``), over phase 4's cohort: (a) phase 4's first scatter
    window re-based onto a 2x2 grid with the mirror masks, the kernel
    launched once a tile, each masked tile equal to its plain version, the
    mirror fill giving the unmasked tiles, the four masked launches timed
    against the four unmasked ones in turns; then every window of phase 4
    through the mirrored tile path on one card (the kernel for scatter
    windows, the pod dense tile step for dense ones) and the fill: G phase
    4's bit for bit; (b) the pod dense tile step over phase 4's packed
    blocks, cut into four rank slices and gathered, with the mirror on and
    off: every tile phase 4's G block.
22. the sketch on a mesh at the biobank width (phase 10's CSR, N = 2^20,
    V = 2048, k = 10): (a) ``sharded_sketch_panel`` on a one-card
    ``data:1`` mesh, a warm run and the best of 2: Y within 1e-5 of phase
    10's panel, row sums equal, ``host_peak_bytes`` the formula, no
    scatter launch, under 2 GiB of card memory, coordinates within 1e-4 of
    phase 10's; (b) ``sketch_tsqr`` over a ``data:2,model:2`` grid of row
    blocks on the one card (the repeated-device list of phase 20b): ``Q·R``
    within 1e-5 of the shifted panel, ``QᵀQ`` within 1e-5 of I, R the host
    float64 R up to row signs, and ``sharded_sketch_finish`` through it,
    coordinates within 1e-4 of phase 10's, each timed; (c) the driver's
    ``auto`` flip on a ``data:1`` mesh over phase 11's common cohort (N =
    40000): a mesh ``SketchPanel``, no launch, under 2 GiB, rows within
    1e-4 of phase 11's; (d) a pod rank's card work: phase 10's window cut
    into two ranks' windows, their global carrier matrix through the pod
    scatter step, and phase 11's dense window cut into two ranks' packed
    columns, their contributions summed as the all-reduce sums them: each
    within 1e-5 of the one-device update, timed.
23. checkpoints on the card over phase 12's directory (9 shards, 3 units
    of 3): (a) a CLI ``pca --elastic-checkpoint``, started with phase 22,
    its fourth shard stalled, SIGKILLed once its first lane appears; a
    fresh driver resumes the lane (one lane, two new units) and G is phase
    4's bit for bit, and a second resume reads no shard; (b) a CLI ``pca
    --checkpoint-dir`` under a one-rank NCCL group, started with phase 22:
    the group is up, the snapshot holds 9 shards, coordinates within 1e-4
    of the f64 oracle; (c) the lane and snapshot writes of the 2504 x 2504
    G, and a pod rank's tile snapshot of a 2x2 grid, timed; no scatter
    launch in the phase.

The last lines are one ``{"kernels": [...]}`` JSON line, the card's name
and power limit as ``nvidia-smi`` reports them, and the result line
``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout of
the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import atexit
import concurrent.futures
import contextlib
import io
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth,
# float32 rate outside the tensor cores (the kernel does f32 adds) and the
# dense int8 tensor-core rate (the dense route's product).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_INT8_OPS_PER_S = 1979e12

N_SAMPLES = 2504  # 1000 Genomes phase 3
N_VARIANTS = 65536
# The dense path's depth: bench.py's 65536 cut to 16384, because the record
# fixture holds about 170 KB of host memory per variant at 25 % density.
DENSE_VARIANTS = 16384
BENCH_BLOCK_V, BENCH_BLOCKS = 8192, 8  # bench.py's shape
COORD_TOL = 1e-4  # the MLlib-oracle parity bar
# bench.py's sketch leg (_sketch_scale_leg): the 2^20-sample biobank width,
# 2048 variants of 128 carriers, k = 10, one window of at most 8192.
BIOBANK_N, BIOBANK_V, BIOBANK_CARRIERS, BIOBANK_K = 1 << 20, 2048, 128, 10
SKETCH_BLOCK_V = 8192
# auto's flip: the smallest round width past N = 32768, where the float32
# G would exceed 4 GiB (6.4 GB here).
FLIP_N, FLIP_V, FLIP_COMMON_V = 40000, 4096, 256
SKETCH_PEAK_BYTES = 2 << 30  # card memory the sketch phases may use
PANEL_RTOL = 1e-5  # float32 panel sums against float64 ones


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, reps: int, flush=None) -> float:
    """Median milliseconds of ``fn()`` by CUDA events, after one warm-up.
    With ``flush`` (a large tensor), L2 is overwritten before each timed
    call, so every call finds its operands cold, as the main path does."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.add_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def time_cuda_loop(fn, reps: int) -> float:
    """Milliseconds per call of ``fn()`` by CUDA events around ``reps``
    calls in a row, after one warm-up: the host enqueues ahead of the
    card, so its launch overhead does not show between calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_case(rng, t_r, t_c, v_pad, k, same, negative=False):
    """Carrier matrices with pad sentinels (and, with ``negative``, the
    negative indices of rebased tile operands) over a random integer G."""
    row = rng.integers(0, t_r, size=(v_pad, k)).astype(np.int32)
    row[rng.random((v_pad, k)) < 0.2] = t_r
    if negative:
        row[rng.random((v_pad, k)) < 0.1] = -5
    if same:
        col = row
    else:
        col = rng.integers(0, t_c, size=(v_pad, k)).astype(np.int32)
        col[rng.random((v_pad, k)) < 0.2] = t_c + 7
        if negative:
            col[rng.random((v_pad, k)) < 0.1] = -9
    g0 = rng.integers(0, 9, size=(t_r, t_c)).astype(np.float32)
    return g0, row, col


def one_variant(n, carriers, k=8):
    """A 256-variant window whose first variant carries ``carriers``."""
    mat = np.full((256, k), n, np.int32)
    mat[0, :len(carriers)] = carriers
    return np.zeros((n, n), np.float32), mat, mat


def kernel_cases(torch, sk, dev):
    """Phase 3: the scatter kernel against its plain version, on the card.
    Returns the largest absolute difference seen (0.0 when all agree) and
    the phase's cases, for phase 5's timings."""
    rng = np.random.default_rng(0)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = sk.scatter_plan(N_SAMPLES, N_SAMPLES, n_sms)
    band = plan.band_rows
    print(f"  plan at N={N_SAMPLES} on {n_sms} SMs: {plan}")
    check(N_SAMPLES % band != 0, "the square cases need a partial last band")

    cases = {}
    for k in (1, 8, 64, 512, 1024):
        cases[f"square N={N_SAMPLES} K={k}"] = random_case(
            rng, N_SAMPLES, N_SAMPLES, 256 if k >= 512 else 1024, k, True
        )
    cases["rectangular 256x384 K=16"] = random_case(
        rng, 256, 384, 512, 16, False
    )
    wide = sk.scatter_plan(64, 70000, n_sms)
    check(wide.n_tiles > 1, "the 64x70000 case must split its columns")
    cases[f"column split 64x70000 K=16 ({wide.n_tiles} tiles)"] = (
        random_case(rng, 64, 70000, 256, 16, False)
    )
    cases["negative indices 300x500 K=33"] = random_case(
        rng, 300, 500, 256, 33, False, negative=True
    )
    unsorted = np.full((1024, 64), N_SAMPLES, np.int32)
    for v in range(1024):
        carriers = rng.choice(N_SAMPLES, int(rng.integers(0, 65)), False)
        unsorted[v, :carriers.size] = carriers  # in no order
    cases["unsorted carriers K=64"] = (
        rng.integers(0, 9, size=(N_SAMPLES, N_SAMPLES)).astype(np.float32),
        unsorted, unsorted,
    )
    straddle = [band - 3, band - 2, band - 1, band, band + 1, band + 2]
    cases["one variant across a band edge"] = one_variant(
        N_SAMPLES, straddle
    )
    edge_dups = [band - 1, band - 1, band, band, band]
    cases["duplicates across a band edge"] = one_variant(
        N_SAMPLES, edge_dups
    )
    dup = np.full((256, 64), N_SAMPLES, np.int32)
    dup[0, :] = 5  # one variant whose 64 carriers are all sample 5
    cases["duplicates K=64"] = (
        np.zeros((N_SAMPLES, N_SAMPLES), np.float32), dup, dup,
    )
    cases["all-sentinel K=64"] = (
        rng.integers(0, 9, size=(N_SAMPLES, N_SAMPLES)).astype(np.float32),
        np.full((256, 64), N_SAMPLES, np.int32),
        np.full((256, 64), N_SAMPLES, np.int32),
    )
    max_err = 0.0
    for name, (g0, row, col) in cases.items():
        r = torch.from_numpy(row).to(dev)
        c = r if col is row else torch.from_numpy(col).to(dev)
        got = sk.scatter_pairs(torch.tensor(g0, device=dev), r, c)
        want = sk.scatter_pairs_chunked(torch.tensor(g0, device=dev), r, c)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        check(torch.equal(got, want), f"kernel != plain version: {name}")
        print(f"  {name}: equal (max abs err {err})")
        if name.startswith("duplicates K=64"):
            check(float(got[5, 5]) == 64.0 * 64.0 and
                  float(got.sum()) == 64.0 * 64.0,
                  "duplicate carriers must count with multiplicity")
        if name.startswith("duplicates across"):
            lo, hi = band - 1, band
            check([float(got[lo, lo]), float(got[lo, hi]),
                   float(got[hi, lo]), float(got[hi, hi]),
                   float(got.sum())] == [4.0, 6.0, 6.0, 9.0, 25.0],
                  "duplicates across a band edge must count 2x2, 2x3, 3x3")
        if name.startswith("one variant"):
            block = got.cpu().numpy()[np.ix_(straddle, straddle)]
            check(float(got.sum()) == 36.0 and bool((block == 1).all()),
                  "a variant across a band edge must add each pair once")
        if name.startswith("all-sentinel"):
            check(torch.equal(got.cpu(), torch.from_numpy(g0)),
                  "an all-sentinel index matrix must leave G unchanged")

    g0, row, _ = cases["square N=2504 K=64"]
    r = torch.from_numpy(row).to(dev)
    first = sk.scatter_pairs(torch.tensor(g0, device=dev), r, r)
    second = sk.scatter_pairs(torch.tensor(g0, device=dev), r, r)
    torch.cuda.synchronize()
    check(torch.equal(first, second),
          "two runs of one window must give the same G bit for bit")
    print("  square N=2504 K=64 run twice: bit-identical")
    return max_err, cases


def ptxas_report(log: str):
    """Each kernel's registers, shared memory and spills, from the
    ``-Xptxas -v`` output ``cuda_build`` keeps beside the library."""
    names = {
        "scatter_band_kernelILb1E": "scatter_band_kernel<same operands>",
        "scatter_band_kernelILb0E": "scatter_band_kernel<two operands>",
        "variant_extent_kernel": "variant_extent_kernel",
    }
    lines, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = next((v for k, v in names.items() if k in line), line)
        elif name and ("registers" in line or "spill" in line):
            text = line.split(":", 1)[1] if line.startswith("ptxas") else line
            lines.append(f"{name}: {text.strip()}")
    return lines


STAGES = ("ingest+gramian", "pca", "emit")
# Host ranges of the dense route and of the sketch engine; like the stages,
# they also appear on the device timeline as annotations, which are not
# device work.
DENSE_RANGES = ("ingest.pack", "ingest.put", "gramian.accumulate",
                "pcoa_fused_blocks")
SKETCH_RANGES = ("gramian.sketch.accumulate", "gramian.sketch.window",
                 "gramian.sketch.finish", "sketch_run")
# Host ranges of the on-disk cohort's CSR-direct ingest (one shard stream,
# each shard's sidecar extraction, each block's build in a builder thread).
FILE_RANGES = ("ingest.stream", "ingest.fetch", "jsonl.stream_carrying_csr",
               "ingest.build", "ingest.pack", "ingest.put",
               "gramian.accumulate")
# Host ranges of the network tier (each shard's frame fetch and decode on
# the client, its sidecar slice on the server) and of the sparse Gramian.
NET_RANGES = ("ingest.stream", "ingest.fetch", "wire_frame_fetch",
              "jsonl.stream_carrying_frame", "gramian.sparse.accumulate",
              "gramian.sparse.window")
ANNOTATIONS = (STAGES + DENSE_RANGES + SKETCH_RANGES + FILE_RANGES
               + NET_RANGES + ("jsonl.stream_carrying",))


def merged_busy_us(intervals, lo, hi) -> float:
    """Microseconds of [lo, hi] covered by the union of ``intervals``."""
    busy, end = 0.0, lo
    for start, stop in sorted(intervals):
        start, stop = max(start, end), min(stop, hi)
        if stop > start:
            busy += stop - start
            end = stop
    return busy


def profile_split(prof) -> None:
    """Phase 4's profiler window: device time by kernel name, and each
    stage's wall-clock against the device's busy time inside it."""
    from torch.autograd import DeviceType

    events = prof.events()
    # The stage ranges also appear on the device timeline as annotations;
    # only kernels, copies and sets are device work.
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.name not in ANNOTATIONS]
    stages = {e.name: (e.time_range.start, e.time_range.end)
              for e in events
              if e.name in STAGES and e.device_type == DeviceType.CPU}
    check(set(stages) == set(STAGES),
          f"the profile must hold every stage range, got {sorted(stages)}")
    if not device:
        print("  device time by kernel: not measured (no CUDA events)")
        for name in STAGES:
            lo, hi = stages[name]
            print(f"  {name}: {(hi - lo) / 1e3:.3f} ms wall-clock, device "
                  "idle share not measured")
        return {}
    by_name = print_device_time(device)
    spans = [(e.time_range.start, e.time_range.end) for e in device]
    for name in STAGES:
        lo, hi = stages[name]
        busy = merged_busy_us(spans, lo, hi)
        print(f"  {name}: {(hi - lo) / 1e3:.3f} ms wall-clock, device busy "
              f"{busy / 1e3:.3f} ms, idle share {1 - busy / (hi - lo):.4f}")
    return by_name


def print_device_time(device, top=14):
    """Device time by kernel name over ``device`` events, the largest
    first; returns ``{name: (total us, count)}``."""
    by_name = {}
    for e in device:
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + e.time_range.elapsed_us(), count + 1)
    total_us = sum(t for t, _ in by_name.values())
    print(f"  device busy {total_us / 1e3:.3f} ms over {len(device)} "
          "kernels and copies; the largest by total time:")
    for name, (t, count) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][0])[:top]:
        print(f"    {t / 1e3:9.3f} ms  x{count:<5d} {name[:90]}")
    return by_name


def host_ranges(prof, names):
    """Host time of the named ``record_function`` ranges, summed over the
    profile (any thread): ``{name: (total ms, count)}``."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.events():
        if e.name in names and e.device_type == DeviceType.CPU:
            total, count = out.get(e.name, (0.0, 0))
            out[e.name] = (total + e.time_range.elapsed_us() / 1e3,
                           count + 1)
    return out


def all_threads_profile(torch):
    """A CPU and CUDA profiler over every thread of the process, so the
    feed's producer-thread ranges (pack, put) are captured too, where this
    torch offers that; else over the calling thread, said so."""
    from torch.profiler import ProfilerActivity, profile

    kw = {}
    try:
        kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except TypeError:
        print("  (this torch profiles the calling thread only: the feed "
              "thread's host ranges are not captured)")
    return profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], **kw)


def pageable_copies_in(prof, stage):
    """Host-to-device copies from pageable memory issued inside the host
    range ``stage``, and all pageable copies the profile attributes to a
    host op. Each device copy is attributed to the op that launched it
    (the profiler's correlation), and the op's host time is compared with
    the range's: the device clock's alignment with the host's, which can
    put a copy launched just after the range inside it, plays no part."""
    from torch.autograd import DeviceType

    events = prof.events()
    windows = [(e.time_range.start, e.time_range.end) for e in events
               if e.name == stage and e.device_type == DeviceType.CPU]
    launched = [e.time_range.start for e in events
                if e.device_type == DeviceType.CPU
                for k in e.kernels
                if "HtoD" in k.name and "Pageable" in k.name]
    inside = sum(1 for t in launched
                 if any(lo <= t <= hi for lo, hi in windows))
    return inside, len(launched)


def copies_by_kind(by_name):
    """Host-to-device copy counts from pinned and from pageable memory."""
    pinned = sum(c for n, (_, c) in by_name.items()
                 if "HtoD" in n and "Pinned" in n)
    pageable = sum(c for n, (_, c) in by_name.items()
                   if "HtoD" in n and "Pageable" in n)
    return pinned, pageable


def valid_pairs(torch, r, c, n_rows, n_cols):
    """The flat G index of every in-range pair (the library yardstick's
    operand)."""
    ri = r.long()[:, :, None]
    ci = c.long()[:, None, :]
    valid = (ri >= 0) & (ri < n_rows) & (ci >= 0) & (ci < n_cols)
    return (ri * n_cols + ci)[valid]


def time_shape(torch, sk, dev, flush, name, shape, r, c):
    """Phase 5 for one shape: kernel, plain version, library call and
    bound, each call with L2 overwritten first. Returns the numbers."""
    n_rows, n_cols = shape
    flat_idx = valid_pairs(torch, r, c, n_rows, n_cols)
    ones = torch.ones(flat_idx.numel(), device=dev)
    g_k, g_p, g_l = (torch.zeros(shape, device=dev) for _ in range(3))

    def kernel():
        sk.scatter_pairs(g_k, r, c)

    def plain():
        sk.scatter_pairs_chunked(g_p, r, c)

    def library():
        g_l.view(-1).index_put_((flat_idx,), ones, accumulate=True)

    for fn in (kernel, plain, library):
        fn()
    check(torch.equal(g_k, g_p) and torch.equal(g_k, g_l),
          f"kernel, plain version and library call disagree: {name}")
    ms = time_cuda(kernel, 20, flush)
    plain_ms = time_cuda(plain, 3, flush)
    library_ms = time_cuda(library, 10, flush)
    index_bytes = r.numel() * 4 * (1 if c is r else 2)
    moved = index_bytes + 2 * n_rows * n_cols * 4
    pairs = flat_idx.numel()
    bytes_ms = moved / PEAK_BYTES_PER_S * 1e3
    ops_ms = pairs / PEAK_F32_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"  {name}: V_pad={r.shape[0]} K={r.shape[1]} pairs={pairs} "
          f"bytes={moved}")
    print(f"    kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
          f"share {bound_ms / ms:.3f}, library/kernel "
          f"{library_ms / ms:.1f}x")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def exact_product(x: np.ndarray) -> np.ndarray:
    """``X @ X.T`` of a 0/1 block on the host, as int64. A float32 BLAS
    product is exact here: every partial sum is an integer no larger than
    the variant count, below 2^24."""
    check(x.shape[1] < 1 << 24, "too many variants for an exact f32 sum")
    xf = x.astype(np.float32)
    return (xf @ xf.T).astype(np.int64)


def make_bench_cohort(seed=0):
    """``bench.py``'s cohort formula (its ``make_cohort``): 3 populations
    with distinct allele frequencies, N_SAMPLES x BLOCK_V*BLOCKS int8."""
    n_variants = BENCH_BLOCK_V * BENCH_BLOCKS
    rng = np.random.default_rng(seed)
    pop = rng.integers(0, 3, N_SAMPLES)
    base = rng.random(n_variants) * 0.12
    shift = (
        (rng.random((3, n_variants)) < 0.15)
        * rng.random((3, n_variants))
        * 0.5
    )
    prob = np.clip(base[None, :] + shift[pop], 0, 0.9)
    return (rng.random((N_SAMPLES, n_variants)) < prob).astype(np.int8)


def odd_sample_counts(torch, dev):
    """Phase 7: the int8 product at sample counts ``torch._int_mm`` takes
    only zero-padded, equal to the host product; and the whole-block
    entry points on the card by default."""
    from spark_examples_tpu_torch.ops.fused import fused_forward
    from spark_examples_tpu_torch.ops.gramian import (
        gramian,
        gramian_accumulate_packed,
        int_mm_rows,
        pack_indicator_block,
    )
    from spark_examples_tpu_torch.ops.pcoa import (
        mllib_principal_components_reference,
    )

    for n in (12, 13, 2500):
        rng = np.random.default_rng(n)
        for n_bits in (8192, 8190):
            x = (rng.random((n, n_bits)) < 0.25).astype(np.int8)
            xp = torch.from_numpy(pack_indicator_block(x)).to(dev)
            g = torch.zeros((n, n), device=dev)
            gramian_accumulate_packed(g, xp, n_bits)
            torch.cuda.synchronize()
            got = g.cpu().numpy()
            want = exact_product(x)
            check(np.array_equal(got.astype(np.int64), want)
                  and np.array_equal(got, want.astype(np.float32)),
                  f"int8 product at N={n}, {n_bits} bits != host product")
            print(f"  N={n} (operand rows {int_mm_rows(n)}), {n_bits} "
                  f"bits: equal to the host product (max {want.max()})")

    # The whole-block entry points take a numpy block to the card by
    # default: ``__graft_entry__``'s shape (128 x 512), 3 subpopulations.
    rng = np.random.default_rng(1)
    n, v = 128, 512
    pop = rng.integers(0, 3, n)
    base = rng.random(v) * 0.12
    shift = (rng.random((3, v)) < 0.2) * rng.random((3, v)) * 0.5
    prob = np.clip(base[None, :] + shift[pop], 0, 0.9)
    x = (rng.random((n, v)) < prob).astype(np.int8)
    want_g = exact_product(x)
    g = gramian(x)
    check(g.device.type == "cuda"
          and np.array_equal(g.cpu().numpy(), want_g.astype(np.float32)),
          "gramian of a numpy block must run on the card, exact")
    coords = fused_forward(x, 2)
    want, _ = mllib_principal_components_reference(want_g, 2)
    err = float(np.abs(coords.cpu().numpy() - want).max())
    print(f"  gramian and fused_forward of a numpy {n}x{v} block on "
          f"{coords.device}: G exact, coordinates vs host f64 oracle "
          f"{err:.3e}")
    check(coords.device.type == "cuda" and err <= COORD_TOL,
          "fused_forward of a numpy block must run on the card, within "
          "the oracle bar")


def dense_main_path(torch, dev):
    """Phase 8: the default ``pca`` (``--pca-mode auto``) at N = 2504."""
    from spark_examples_tpu_torch.arrays import feed
    from spark_examples_tpu_torch.genomics.fixtures import (
        DEFAULT_VARIANT_SET_ID,
        synthetic_cohort,
    )
    from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
    from spark_examples_tpu_torch.ops import scatter_kernel as sk
    from spark_examples_tpu_torch.ops.pcoa import (
        mllib_principal_components_reference,
    )
    from spark_examples_tpu_torch.utils.config import PcaConfig
    from spark_examples_tpu_torch.utils.tracing import (
        GRAMIAN_ACCUMULATE,
        INGEST_PACK,
        INGEST_PUT,
    )

    t0 = time.perf_counter()
    source = synthetic_cohort(
        N_SAMPLES, DENSE_VARIANTS, seed=0, population_structure=3,
        sparse_calls=True,
    )
    print(f"  cohort generated in {time.perf_counter() - t0:.2f} s")

    def conf(mode, **kw):
        return PcaConfig(variant_set_ids=[DEFAULT_VARIANT_SET_ID],
                         pca_mode=mode, device="cuda", **kw)

    partitions = source.stats.partitions
    try:
        VariantsPcaDriver(conf("fused", precise=True), source)
    except ValueError as e:
        print(f"  fused --precise refused before ingest: {e}")
    else:
        fail("--pca-mode fused with --precise must raise")
    check(source.stats.partitions == partitions,
          "the refused run must read no shard")

    def run(mode):
        sk.SCATTER_KERNEL_LAUNCHES = 0
        feed.PINNED_COPIES = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            driver = VariantsPcaDriver(conf(mode), source)
            result = driver.run()
        run_s = time.perf_counter() - t0
        launches = sk.SCATTER_KERNEL_LAUNCHES
        pinned_copies[mode] = feed.PINNED_COPIES
        lines = out.getvalue().splitlines()
        tsv = [line for line in lines if line.count("\t") == 3]
        stage_s = {k: round(v, 6) for k, v in driver.timer.seconds.items()}
        print(f"  {mode}: driver.run() {run_s:.3f} s, {len(tsv)} result "
              f"lines, scatter launches {launches}, pinned feed copies "
              f"{feed.PINNED_COPIES}, stage seconds {json.dumps(stage_s)}")
        check(len(tsv) == N_SAMPLES, f"expected {N_SAMPLES} result lines")
        check(launches == 0,
              "meshless auto/fused/stream must not launch the scatter "
              "kernel (the dense-blockwise route)")
        return driver, result, lines

    pinned_copies = {}
    driver, result, lines = run("auto")
    for line in lines:
        if line.count("\t") != 3:
            print(f"  | {line}")

    t0 = time.perf_counter()
    calls = []
    for shard in driver.conf.shards():
        calls.extend(source.stream_carrying(
            DEFAULT_VARIANT_SET_ID, shard, driver.index.indexes))
    x = np.zeros((N_SAMPLES, len(calls)), np.int8)
    for col, carriers in enumerate(calls):
        x[carriers, col] = 1
    g_ref = exact_product(x)
    print(f"  {len(calls)} variants, carrier density {x.mean():.4f}, "
          f"{-(-len(calls) // driver.conf.block_variants)} blocks; host "
          f"product in {time.perf_counter() - t0:.2f} s")
    want, _ = mllib_principal_components_reference(g_ref, 2)

    def check_run(name, drv, res):
        g_dev = drv.g.cpu().numpy()
        check(np.array_equal(g_dev.astype(np.int64), g_ref)
              and np.array_equal(g_dev, g_ref.astype(np.float32)),
              f"{name}: G is not bit-identical to the host int64 product")
        coords = np.array([[pc1, pc2] for _, pc1, pc2 in res])
        check(coords.shape == (N_SAMPLES, 2) and np.isfinite(coords).all(),
              f"{name}: coordinates must be finite, one pair per sample")
        err = float(np.abs(coords - want).max())
        print(f"  {name}: G bit-identical (max entry {g_ref.max()}); "
              f"coordinates vs host f64 oracle {err:.3e} (bar {COORD_TOL})")
        check(err <= COORD_TOL, f"{name}: coordinates beyond the bar")
        return coords

    auto_coords = check_run("auto", driver, result)
    fused_coords = check_run("fused", *run("fused")[:2])
    stream_coords = check_run("stream", *run("stream")[:2])
    agree = float(np.abs(fused_coords - stream_coords).max())
    print(f"  fused vs stream: max abs difference {agree:.3e}")
    check(agree <= COORD_TOL, "fused and stream disagree beyond 1e-4")
    check(np.array_equal(auto_coords, fused_coords),
          "auto at N <= --dense-eigh-limit must run the fused finish")

    n_blocks = -(-len(calls) // driver.conf.block_variants)
    check(all(n == n_blocks for n in pinned_copies.values()),
          f"each run must copy its {n_blocks} feed blocks from pinned "
          f"memory, copied {pinned_copies}")

    print("  a second auto run under torch.profiler:", flush=True)
    feed.PINNED_COPIES = 0
    with contextlib.redirect_stdout(io.StringIO()), all_threads_profile(
        torch
    ) as prof:
        profiled = VariantsPcaDriver(conf("auto"), source)
        profiled.run()
    check(feed.PINNED_COPIES == n_blocks,
          "the profiled run must copy every feed block from pinned memory")
    stage_s = {k: round(v, 6) for k, v in profiled.timer.seconds.items()}
    print(f"  stage seconds under the profiler: {json.dumps(stage_s)}")
    by_name = profile_split(prof)
    pinned, pageable = copies_by_kind(by_name)
    in_ingest, attributed = pageable_copies_in(prof, "ingest+gramian")
    print(f"  host-to-device copies in the profile: {pinned} from pinned "
          f"memory, {pageable} from pageable memory ({attributed} of them "
          f"attributed to the host op that issued it, {in_ingest} issued "
          f"inside ingest+gramian); the feed's own count: "
          f"{feed.PINNED_COPIES} of {n_blocks} blocks copied from pinned "
          "memory")
    # The profiler keeps the device records of none, some or all of this
    # window's feed copies (0, 1 and 2 of 2 in three runs on one card),
    # so the feed's own count above is the proof that every block was
    # copied from pinned memory, and the profile shows that nothing in
    # the ingest stage was copied from pageable memory.
    check(attributed == pageable,
          "every pageable copy must be attributed to the op that issued it")
    check(in_ingest == 0,
          "the ingest stage must copy nothing from pageable memory")
    for name, (ms, count) in sorted(host_ranges(
            prof, (INGEST_PACK, INGEST_PUT, GRAMIAN_ACCUMULATE)).items()):
        print(f"  host range {name}: {ms:.3f} ms over {count}")


def bench_shape(torch, dev):
    """Phase 9: ``pcoa_fused_blocks`` at the bench shape."""
    from spark_examples_tpu_torch.arrays import feed
    from spark_examples_tpu_torch.ops.fused import pcoa_fused_blocks
    from spark_examples_tpu_torch.ops.gramian import (
        gramian_accumulate_packed,
        int_mm_rows,
        pack_indicator_block,
    )
    from spark_examples_tpu_torch.ops.pcoa import (
        mllib_principal_components_reference,
    )
    from spark_examples_tpu_torch.utils.tracing import (
        GRAMIAN_ACCUMULATE,
        INGEST_PACK,
        INGEST_PUT,
    )

    t0 = time.perf_counter()
    x = make_bench_cohort()
    n_variants = x.shape[1]
    blocks = [x[:, i:i + BENCH_BLOCK_V]
              for i in range(0, n_variants, BENCH_BLOCK_V)]
    print(f"  cohort {x.shape}, density {x.mean():.4f}, {len(blocks)} "
          f"blocks, made in {time.perf_counter() - t0:.2f} s", flush=True)

    def fused_run():
        feed.PINNED_COPIES = 0
        t0 = time.perf_counter()
        out = pcoa_fused_blocks(iter(blocks), N_SAMPLES, 2, device=dev)
        wall = time.perf_counter() - t0
        check(feed.PINNED_COPIES == len(blocks),
              f"the feed must copy all {len(blocks)} blocks from pinned "
              f"memory, copied {feed.PINNED_COPIES}")
        return wall, out

    walls = []
    for _ in range(4):  # the first run pays first-use library set-up
        wall, (coords, vals, row_sums) = fused_run()
        walls.append(wall)
    best = min(walls[1:])
    rate = N_SAMPLES ** 2 * n_variants / best
    print(f"  pcoa_fused_blocks wall-clock: first {walls[0]:.4f} s, then "
          + ", ".join(f"{w:.4f}" for w in walls[1:]) + " s")
    print(f"  north-star rate (best of the warm runs): {rate:.4e} "
          "samples^2*variants/s")

    t0 = time.perf_counter()
    g_ref = exact_product(x)
    want, _ = mllib_principal_components_reference(g_ref, 2)
    check(np.array_equal(row_sums.astype(np.int64), g_ref.sum(axis=1)),
          "row sums of G must equal the host product's")
    err = float(np.abs(coords - want).max())
    print(f"  coordinates vs host f64 oracle {err:.3e} (bar {COORD_TOL}); "
          f"row sums exact; host check {time.perf_counter() - t0:.2f} s")
    check(coords.shape == (N_SAMPLES, 2) and np.isfinite(coords).all(),
          "coordinates must be finite, one pair per sample")
    check(err <= COORD_TOL, "coordinates beyond the oracle bar")

    xb = torch.from_numpy(np.ascontiguousarray(blocks[0])).to(dev)
    xp = torch.from_numpy(pack_indicator_block(blocks[0])).to(dev)
    g = torch.zeros((N_SAMPLES, N_SAMPLES), device=dev)
    int_mm_ms = time_cuda_loop(lambda: torch._int_mm(xb, xb.t()), 50)
    step_ms = time_cuda_loop(lambda: gramian_accumulate_packed(g, xp), 50)
    rows = int_mm_rows(N_SAMPLES)
    ops = 2 * rows * rows * BENCH_BLOCK_V
    bound_ms = ops / PEAK_INT8_OPS_PER_S * 1e3
    print(f"  torch._int_mm per {BENCH_BLOCK_V}-variant block: "
          f"{int_mm_ms:.4f} ms against a {bound_ms:.4f} ms bound "
          f"(operations: {ops:.4e} int8 ops at 1979 TOP/s), share "
          f"{bound_ms / int_mm_ms:.3f}")
    print(f"  one accumulate step (unpack, product, add into G): "
          f"{step_ms:.4f} ms")

    host = torch.empty(tuple(xp.shape), dtype=torch.uint8, pin_memory=True)
    check(host.is_pinned(), "the staging buffer must be page-locked")
    pageable = torch.empty(tuple(xp.shape), dtype=torch.uint8)
    dst = torch.empty_like(xp)
    pin_ms = time_cuda_loop(
        lambda: dst.copy_(host, non_blocking=True), 50)
    page_ms = time_cuda_loop(lambda: dst.copy_(pageable), 50)
    nbytes = host.numel()
    print(f"  host-to-device copy of one packed block ({nbytes} bytes): "
          f"pinned {pin_ms:.4f} ms = {nbytes / pin_ms / 1e6:.2f} GB/s; "
          f"pageable {page_ms:.4f} ms = {nbytes / page_ms / 1e6:.2f} GB/s")

    from torch.autograd import DeviceType
    from torch.profiler import record_function

    feed.PINNED_COPIES = 0
    with all_threads_profile(torch) as prof:
        with record_function("pcoa_fused_blocks"):
            pcoa_fused_blocks(iter(blocks), N_SAMPLES, 2, device=dev)
    print(f"  the feed's own count: {feed.PINNED_COPIES} of {len(blocks)} "
          "blocks copied from pinned memory")
    check(feed.PINNED_COPIES == len(blocks),
          "every feed block must be copied from pinned memory")
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.name not in DENSE_RANGES]
    window = [(e.time_range.start, e.time_range.end) for e in events
              if e.name == "pcoa_fused_blocks"
              and e.device_type == DeviceType.CPU]
    print("  one run under torch.profiler:")
    if device and window:
        by_name = print_device_time(device, top=10)
        lo, hi = window[0]
        busy = merged_busy_us(
            [(e.time_range.start, e.time_range.end) for e in device], lo, hi)
        print(f"  wall-clock {(hi - lo) / 1e3:.3f} ms, device busy "
              f"{busy / 1e3:.3f} ms, idle share {1 - busy / (hi - lo):.4f}")
        pinned, pageable_n = copies_by_kind(by_name)
        products = sum(c for n, (_, c) in by_name.items() if "i8i32" in n)
        for kind, keys in (("int8 products", ("i8i32",)),
                           ("pinned host-to-device copies",
                            ("HtoD", "Pinned"))):
            starts = sorted((e.time_range.start - lo) / 1e3 for e in device
                            if all(k in e.name for k in keys))
            print(f"  {kind} start at ms " + ", ".join(
                f"{t:.2f}" for t in starts) + " of the window")
        print(f"  host-to-device copies: {pinned} pinned, {pageable_n} "
              f"pageable; device records of {products} of {len(blocks)} "
              f"int8 products and {pinned} of {len(blocks)} feed copies "
              "captured")
        # This window has lost the records of its first block or two in
        # runs where it was the process's third profiler window: the
        # feed's own count above proves all its copies pinned, and the
        # profile that none came from pageable memory (the one pageable
        # copy is the finish's start panel).
        check(pinned >= 1 and pageable_n <= 1,
              "the feed's copies must come from pinned memory")
    else:
        print("  device time by kernel: not measured (no CUDA events)")
    for name, (ms, count) in sorted(host_ranges(
            prof, (INGEST_PACK, INGEST_PUT, GRAMIAN_ACCUMULATE)).items()):
        print(f"  host range {name}: {ms:.3f} ms over {count}")


def biobank_csr():
    """``bench.py``'s sketch-leg cohort (its ``_sketch_scale_leg`` formula,
    copied): per variant, 128 distinct carriers of 2^20 samples."""
    rng = np.random.default_rng(1000)
    kc = BIOBANK_CARRIERS
    idx = np.empty(BIOBANK_V * kc, dtype=np.int64)
    for v in range(BIOBANK_V):
        idx[v * kc:(v + 1) * kc] = rng.choice(BIOBANK_N, size=kc,
                                              replace=False)
    offsets = np.arange(BIOBANK_V + 1, dtype=np.int64) * kc
    return idx, offsets


def rel_frobenius(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def biobank_sketch(torch, dev):
    """Phase 10: the sketch engine at N = 2^20 on the card."""
    import warnings

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from spark_examples_tpu_torch.arrays.blocks import csr_windows
    from spark_examples_tpu_torch.ops import scatter_kernel as sk
    from spark_examples_tpu_torch.ops import sketch
    from spark_examples_tpu_torch.ops.pcoa import randomized_panel_width
    from spark_examples_tpu_torch.utils.tracing import (
        SKETCH_ACCUMULATE,
        SKETCH_FINISH,
        SKETCH_WINDOW,
    )

    n, k = BIOBANK_N, BIOBANK_K
    t0 = time.perf_counter()
    idx, offsets = biobank_csr()
    l = randomized_panel_width(n, k)
    print(f"  cohort: N={n}, V={BIOBANK_V}, {BIOBANK_CARRIERS} carriers per "
          f"variant, nnz={idx.size}, panel width l={l}; made in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    def windows():
        return csr_windows(iter([(idx, offsets)]), SKETCH_BLOCK_V)

    check(len(list(windows())) == 1, "the cohort must be one window")

    def run():
        t0 = time.perf_counter()
        panel = sketch.sketch_panel_blockwise(
            windows, n, k, power_iters=0, seed=0,
            block_variants=SKETCH_BLOCK_V, device=dev,
        )
        t1 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            coords, vals = sketch.sketch_eig(panel, k)
        t2 = time.perf_counter()
        return t2 - t0, t1 - t0, panel, coords, vals, len(caught)

    sk.SCATTER_KERNEL_LAUNCHES = 0
    before = dict(sketch.SKETCH_WINDOWS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # by earlier phases
    runs = [run() for _ in range(3)]  # one warm run, then the best of 2
    peak = torch.cuda.max_memory_allocated()
    launches = sk.SCATTER_KERNEL_LAUNCHES
    routes = {r: sketch.SKETCH_WINDOWS[r] - before[r] for r in before}
    best = min(runs[1:], key=lambda r: r[0])
    print(f"  sketch_panel_blockwise + sketch_eig: warm {runs[0][0]:.4f} s, "
          "then " + ", ".join(f"{r[0]:.4f}" for r in runs[1:]) + " s (panel "
          + ", ".join(f"{r[1]:.4f}" for r in runs) + " s)")
    print(f"  sketch_samples_per_sec (best of 2): {n / best[0]:.2f}")
    print(f"  windows by route {routes}; scatter kernel launches {launches}; "
          f"spectral-gap warnings per run {runs[0][5]} (the cohort has no "
          "structure)")
    print(f"  peak card memory {peak} bytes ({peak / 2**20:.1f} MiB), "
          f"{peak - held} of them allocated by these runs; the "
          f"documented panel bound sketch_host_bytes(N, l) = "
          f"{sketch.sketch_host_bytes(n, l)} bytes; an f32 G would take "
          f"{4 * n * n} bytes (4 TiB)")
    check(launches == 0, "the sketch engine must not launch the scatter "
          "kernel")
    check(routes == {"scatter": 3, "dense": 0},
          f"each run must scatter its one window, got {routes}")
    check(peak < SKETCH_PEAK_BYTES, "peak card memory must stay under 2 GiB")

    _, _, panel, coords, vals, _ = runs[0]
    check(coords.shape == (n, k) and np.isfinite(coords).all()
          and np.isfinite(vals).all(),
          "coordinates must be finite, (N, k)")
    for other in runs[1:]:
        check(np.array_equal(other[2].y, panel.y)
              and np.array_equal(other[2].omega, panel.omega)
              and np.array_equal(other[2].row_sums, panel.row_sums)
              and np.array_equal(other[3], coords),
              "two runs with one seed must give bit-identical panels")
    print("  the three runs' panels and coordinates are bit-identical")

    t0 = time.perf_counter()
    om = sketch.gaussian_test_matrix(n, l, 0).astype(np.float64)
    om -= om.mean(axis=0, keepdims=True)
    t = om[idx].reshape(BIOBANK_V, BIOBANK_CARRIERS, l).sum(axis=1)
    t = np.repeat(t, BIOBANK_CARRIERS, axis=0)
    y_ref = np.stack([np.bincount(idx, weights=t[:, j], minlength=n)
                      for j in range(l)], axis=1)
    y_ref -= y_ref.mean(axis=0, keepdims=True)
    err = rel_frobenius(panel.y, y_ref)
    want_sums = BIOBANK_CARRIERS * np.bincount(idx, minlength=n)
    print(f"  Y vs the host float64 panel: relative Frobenius error "
          f"{err:.3e} (bar {PANEL_RTOL}); row sums exact: "
          f"{np.array_equal(panel.row_sums, want_sums)}; host check "
          f"{time.perf_counter() - t0:.2f} s")
    check(err <= PANEL_RTOL, "Y beyond the float64 panel's bar")
    check(np.array_equal(panel.row_sums, want_sums.astype(np.float64)),
          "row sums must be exact")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("sketch_run"):
            run()
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.name not in ANNOTATIONS]
    window = [(e.time_range.start, e.time_range.end) for e in events
              if e.name == "sketch_run" and e.device_type == DeviceType.CPU]
    print("  one run under torch.profiler:")
    if device and window:
        print_device_time(device, top=10)
        lo, hi = window[0]
        busy = merged_busy_us(
            [(e.time_range.start, e.time_range.end) for e in device], lo, hi)
        print(f"  wall-clock {(hi - lo) / 1e3:.3f} ms, device busy "
              f"{busy / 1e3:.3f} ms, idle share {1 - busy / (hi - lo):.4f}")
    else:
        print("  device time by kernel: not measured (no CUDA events)")
    for name, (ms, count) in sorted(host_ranges(
            prof, (SKETCH_ACCUMULATE, SKETCH_WINDOW, SKETCH_FINISH)).items()):
        print(f"  host range {name}: {ms:.3f} ms over {count}")
    return panel, coords, n / best[0], (idx, offsets)


def dual_oracle(torch, dev, windows, n, k=3):
    """Exact top-k eigenpairs of C = H·X·Xᵀ·H in float64 on the card,
    through the V×V dual (H·X)ᵀ·(H·X): sign-normalized unit eigenvectors
    of C and their eigenvalues, descending."""
    from spark_examples_tpu_torch.ops.pcoa import normalize_eigvec_signs

    v = sum(lens.size for _, lens in windows)
    x = torch.zeros((n, v), dtype=torch.float64, device=dev)
    col = 0
    for idx, lens in windows:
        cols = np.repeat(np.arange(col, col + lens.size), lens)
        x[torch.from_numpy(np.asarray(idx, np.int64)).to(dev),
          torch.from_numpy(cols).to(dev)] = 1.0
        col += lens.size
    x -= x.mean(dim=0, keepdim=True)
    w, vecs = torch.linalg.eigh(x.T @ x)
    top = torch.argsort(w, descending=True)[:k]
    u = (x @ vecs[:, top]) / torch.sqrt(w[top])
    return normalize_eigvec_signs(u.cpu().numpy()), w[top].cpu().numpy()


def auto_flip(torch, dev):
    """Phase 11: ``--pca-mode auto`` flips to the sketch engine past the
    4 GiB G bound, on the driver."""
    import warnings

    from spark_examples_tpu_torch.genomics.fixtures import (
        DEFAULT_VARIANT_SET_ID,
        synthetic_cohort,
    )
    from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
    from spark_examples_tpu_torch.ops import scatter_kernel as sk
    from spark_examples_tpu_torch.ops import sketch
    from spark_examples_tpu_torch.utils.config import PcaConfig

    def conf(**kw):
        return PcaConfig(variant_set_ids=[DEFAULT_VARIANT_SET_ID],
                         pca_mode="auto", num_pc=2, device="cuda", **kw)

    def drive(source, name, profiled=False, **kw):
        sk.SCATTER_KERNEL_LAUNCHES = 0
        before = dict(sketch.SKETCH_WINDOWS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # by earlier phases
        out = io.StringIO()
        prof = all_threads_profile(torch) if profiled else (
            contextlib.nullcontext())
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), warnings.catch_warnings(
                record=True), prof:
            warnings.simplefilter("always")
            driver = VariantsPcaDriver(conf(**kw), source)
            selected = driver.sketch_selected()
            result = driver.run()
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = sk.SCATTER_KERNEL_LAUNCHES
        routes = {r: sketch.SKETCH_WINDOWS[r] - before[r] for r in before}
        lines = out.getvalue().splitlines()
        tsv = [line for line in lines if line.count("\t") == 3]
        for line in lines:
            if line not in tsv and not line.startswith(("Stage", "---")):
                print(f"  | {line}")
        stage_s = {k: round(v, 6) for k, v in driver.timer.seconds.items()}
        print(f"  {name}: driver.run() {run_s:.3f} s, stage seconds "
              f"{json.dumps(stage_s)}; windows by route {routes}; scatter "
              f"launches {launches}; peak card memory {peak} bytes "
              f"({peak / 2**20:.1f} MiB), {peak - held} of them allocated "
              f"by the run, against {4 * FLIP_N * FLIP_N} bytes of an f32 "
              "G", flush=True)
        check(selected and isinstance(driver.g, sketch.SketchPanel),
              f"{name}: auto past 4 GiB of G must return a SketchPanel")
        check(launches == 0, f"{name}: no scatter kernel launch")
        check(peak < SKETCH_PEAK_BYTES,
              f"{name}: peak card memory must stay under 2 GiB")
        check(len(tsv) == FLIP_N, f"expected {FLIP_N} result lines")
        if profiled:
            profile_split(prof)
        coords = np.array([[pc1, pc2] for _, pc1, pc2 in result])
        check(np.isfinite(coords).all(), f"{name}: coordinates not finite")
        return driver, coords

    def against_oracle(name, driver, coords, windows):
        t0 = time.perf_counter()
        want, want_vals = dual_oracle(torch, dev, windows, FLIP_N)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _, vals = sketch.sketch_eig(driver.g, 2)
        ratio = want_vals[2] / want_vals[1]
        val_err = np.abs(vals - want_vals[:2]) / want_vals[:2]
        coord_err = float(np.abs(coords - want[:, :2]).max())
        q, _ = np.linalg.qr(coords)
        cos = np.linalg.svd(want[:, :2].T @ q, compute_uv=False)
        sin = float(np.sqrt(max(0.0, 1.0 - cos.min() ** 2)))
        print(f"  {name} vs the float64 dual oracle "
              f"({time.perf_counter() - t0:.2f} s): exact top 3 {want_vals.tolist()}, λ3/λ2 {ratio:.4f}; "
              f"sketch {vals.tolist()}, eigenvalue relative errors "
              f"{val_err.tolist()} (bar {sketch.SKETCH_TOPK_RTOL}), "
              f"coordinates max abs err {coord_err:.3e} (bar "
              f"{sketch.SKETCH_TOPK_ATOL}), sine of the largest angle between "
              f"the top-2 subspaces {sin:.3e}", flush=True)
        return ratio, val_err, coord_err

    t0 = time.perf_counter()
    source = synthetic_cohort(FLIP_N, FLIP_V, seed=0, population_structure=3,
                              rare_variant_af=0.01, sparse_calls=True)
    print(f"  rare-variant cohort N={FLIP_N}, V={FLIP_V} generated in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    drive(source, "auto")
    driver, coords = drive(source, "auto --sketch-power-iters 2 (profiled)",
                           profiled=True, sketch_power_iters=2)

    t0 = time.perf_counter()
    windows = host_windows(source, driver.conf, driver.index.indexes)
    panels = {}
    for route, threshold in (("dense", 0.0), ("scatter", float("inf"))):
        before = dict(sketch.SKETCH_WINDOWS)
        panels[route] = sketch.sketch_panel_blockwise(
            lambda: iter(windows), FLIP_N, 2, density_threshold=threshold,
            device=dev)
        applied = sketch.SKETCH_WINDOWS[route] - before[route]
        check(applied == len(windows),
              f"threshold {threshold} must route every window {route}")
    err = rel_frobenius(panels["dense"].y, panels["scatter"].y)
    same_sums = np.array_equal(panels["dense"].row_sums,
                               panels["scatter"].row_sums)
    print(f"  all-dense vs all-scatter panels of the same {len(windows)} "
          f"window(s): relative Frobenius error {err:.3e} (bar "
          f"{PANEL_RTOL}), row sums equal {same_sums}; "
          f"{time.perf_counter() - t0:.2f} s")
    check(err <= PANEL_RTOL, "the dense and scatter routes disagree")
    check(same_sums, "the two routes' row sums must be equal")
    ratio, _, _ = against_oracle("rare cohort, 2 power iterations", driver,
                                 coords, windows)
    check(ratio < 0.95, "the rare cohort's λ3/λ2 must be below 0.95")
    del source, driver, windows, panels

    t0 = time.perf_counter()
    common = synthetic_cohort(FLIP_N, FLIP_COMMON_V, seed=0,
                              population_structure=3, sparse_calls=True)
    print(f"  common-variant cohort N={FLIP_N}, V={FLIP_COMMON_V} generated "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    driver, coords = drive(common, "common cohort, auto "
                           "--sketch-power-iters 2", sketch_power_iters=2)
    windows = host_windows(common, driver.conf, driver.index.indexes)
    ratio, val_err, coord_err = against_oracle(
        "common cohort, 2 power iterations", driver, coords, windows)
    check(ratio < 0.95, "the common cohort's λ3/λ2 must be below 0.95")
    check(val_err.max() <= sketch.SKETCH_TOPK_RTOL
          and coord_err <= sketch.SKETCH_TOPK_ATOL,
          "the sketch must meet the reference's top-k bars on a gapped "
          "spectrum")
    return common, coords, windows


def same_g(g, g_ref) -> bool:
    """G bit-identical to the host int64 product (exact as float32)."""
    return (g.shape == g_ref.shape
            and np.array_equal(g.astype(np.int64), g_ref)
            and np.array_equal(g, g_ref.astype(np.float32)))


def thread_sets(prof, names):
    """The threads each named host range ran on: ``{name: [thread ids]}``."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.events():
        if e.name in names and e.device_type == DeviceType.CPU:
            out.setdefault(e.name, set()).add(e.thread)
    return {k: sorted(v) for k, v in out.items()}


def drive_file(torch, source, name, profiled=False, **kw):
    """One ``VariantsPcaDriver.run()`` on the card with the scatter and
    pinned-copy counts set to 0 just before and read just after; stdout
    captured. Returns the driver, its result, G on the host (or None
    under the sketch engine), the two counts and the profile."""
    from spark_examples_tpu_torch.arrays import feed
    from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
    from spark_examples_tpu_torch.ops import scatter_kernel as sk
    from spark_examples_tpu_torch.ops.sketch import SketchPanel
    from spark_examples_tpu_torch.utils.config import PcaConfig

    conf = PcaConfig(device="cuda", **kw)
    sk.SCATTER_KERNEL_LAUNCHES = 0
    feed.PINNED_COPIES = 0
    out = io.StringIO()
    prof = all_threads_profile(torch) if profiled else (
        contextlib.nullcontext())
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), prof:
        t1 = time.perf_counter()
        driver = VariantsPcaDriver(conf, source)
        init_s = time.perf_counter() - t1
        result = driver.run()
    run_s = time.perf_counter() - t0
    launches, pinned = sk.SCATTER_KERNEL_LAUNCHES, feed.PINNED_COPIES
    lines = out.getvalue().splitlines()
    n_tsv = sum(line.count("\t") == 3 for line in lines)
    stage_s = {k: round(v, 6) for k, v in driver.timer.seconds.items()}
    print(f"  {name}: driver construction {init_s:.3f} s, run() "
          f"{run_s - init_s:.3f} s, stage seconds {json.dumps(stage_s)}; "
          f"scatter launches {launches}, pinned feed copies {pinned}",
          flush=True)
    check(n_tsv == driver.cohort.size,
          f"{name}: expected {driver.cohort.size} result lines, got {n_tsv}")
    g = None if isinstance(driver.g, SketchPanel) else driver.g.cpu().numpy()
    return driver, result, g, launches, pinned, prof


def on_disk_cohort(torch, root, fixture, g_ref, want, n_blocks,
                   phase4_launches):
    """Phase 12: ``pca --input-path`` over phase 4's cohort on disk."""
    from spark_examples_tpu_torch.genomics.fixtures import (
        DEFAULT_VARIANT_SET_ID,
    )
    from spark_examples_tpu_torch.genomics.sources import (
        LINEIDX_BASENAME,
        SIDECAR_BASENAME,
        JsonlSource,
    )
    from spark_examples_tpu_torch.utils.config import PcaConfig

    base = dict(variant_set_ids=[DEFAULT_VARIANT_SET_ID])
    sidecar = os.path.join(root, SIDECAR_BASENAME)
    for name in (SIDECAR_BASENAME, LINEIDX_BASENAME):
        path = os.path.join(root, name)
        if os.path.exists(path):
            os.unlink(path)  # written by phase 6's CLI run
    print(f"  cohort directory: variants.jsonl "
          f"{os.path.getsize(os.path.join(root, 'variants.jsonl'))} bytes; "
          "no sidecar", flush=True)

    def coords_err(result):
        coords = np.array([[pc1, pc2] for _, pc1, pc2 in result])
        check(np.isfinite(coords).all(), "coordinates must be finite")
        return float(np.abs(coords - want).max())

    for name in ("sparse, cold sidecar", "sparse, warm sidecar"):
        _, result, g, launches, _, _ = drive_file(
            torch, JsonlSource(root), name, pca_mode="sparse", **base)
        err = coords_err(result)
        print(f"    G bit-identical to phase 4's: {same_g(g, g_ref)}; "
              f"coordinates vs host f64 oracle {err:.3e}")
        check(os.path.exists(sidecar), "the run must write the sidecar")
        check(launches == phase4_launches,
              f"{name}: {launches} scatter launches, phase 4 launched "
              f"{phase4_launches}")
        check(same_g(g, g_ref), f"{name}: G is not phase 4's bit for bit")
        check(err <= COORD_TOL, f"{name}: coordinates beyond the bar")
    main_launches = launches

    driver, result, g, launches, pinned, _ = drive_file(
        torch, JsonlSource(root), "auto, warm sidecar", pca_mode="auto",
        **base)
    err = coords_err(result)
    print(f"    G bit-identical to phase 4's: {same_g(g, g_ref)}; "
          f"coordinates vs host f64 oracle {err:.3e}; {n_blocks} blocks")
    check(launches == 0, "auto must route dense: no scatter launch")
    check(pinned == n_blocks,
          f"auto: {pinned} pinned copies for {n_blocks} blocks")
    check(same_g(g, g_ref), "auto: G is not phase 4's bit for bit")
    check(err <= COORD_TOL, "auto: coordinates beyond the bar")

    _, _, g_fix, _, _, _ = drive_file(
        torch, fixture, "auto, the same cohort from the fixture source "
        "(the record loop)", pca_mode="auto", **base)
    check(same_g(g_fix, g_ref), "the fixture auto run's G differs")

    ids = [c.id for c in JsonlSource(root).list_callsets(
        DEFAULT_VARIANT_SET_ID)]
    _, _, g, _, _, _ = drive_file(
        torch, JsonlSource(root), "auto --samples <the first 2000 ids>",
        pca_mode="auto", samples=ids[:2000], **base)
    print(f"    G bit-identical to G[:2000, :2000]: "
          f"{same_g(g, g_ref[:2000, :2000])}")
    check(same_g(g, g_ref[:2000, :2000]),
          "--samples: G is not the unrestricted G's submatrix")

    driver, _, g, _, pinned, _ = drive_file(
        torch, JsonlSource(root),
        "auto --ingest-order completion --ingest-workers 4 "
        "--bases-per-partition 10000", pca_mode="auto",
        ingest_order="completion", ingest_workers=4,
        bases_per_partition=10_000, **base)
    shards = len(driver._manifest())
    print(f"    {shards} shards; G bit-identical: {same_g(g, g_ref)}")
    check(shards >= 8, "the completion run needs at least 8 shards")
    check(same_g(g, g_ref), "completion order: G must stay bit-identical")
    check(pinned == n_blocks,
          f"completion order: {pinned} pinned copies for {n_blocks} blocks")

    for mode in ("auto", "sparse"):
        print(f"  a warm {mode} run under torch.profiler (all threads):",
              flush=True)
        driver, _, _, _, _, prof = drive_file(
            torch, JsonlSource(root), f"{mode}, profiled", profiled=True,
            pca_mode=mode, **base)
        profile_split(prof)
        for name, (ms, count) in sorted(host_ranges(
                prof, FILE_RANGES).items()):
            print(f"  host range {name}: {ms:.3f} ms over {count}")
        threads = thread_sets(prof, FILE_RANGES + STAGES)
        print(f"  threads per host range: {json.dumps(threads)}")

    os.unlink(sidecar)
    t0 = time.perf_counter()
    cold = JsonlSource(root)._ensure_csr()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm_src = JsonlSource(root)
    warm_src._ensure_csr()
    map_s = time.perf_counter() - t0
    nnz = int(cold._d["ords"].size)
    index = driver.index.indexes
    shard_ms = []
    for shard in PcaConfig(bases_per_partition=10_000).shards():
        t0 = time.perf_counter()
        warm_src.stream_carrying_csr(DEFAULT_VARIANT_SET_ID, shard, index)
        shard_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"  sidecar: built in {build_s:.3f} s "
          f"({os.path.getsize(sidecar)} bytes, "
          f"{int(cold._d['starts'].size)} variants, {nnz} carriers), "
          f"mapped warm in {map_s * 1e3:.3f} ms; warm query per shard "
          f"(9 shards, ms): " + ", ".join(f"{t:.3f}" for t in shard_ms))
    return main_launches


def write_biobank_cohort(root, idx, offsets, vsid):
    """The phase-10 cohort as a JSONL directory, written with ``json``
    only: 2^20 callsets in column order, and one record per variant at
    ascending starts inside the BRCA1 range, carriers in ``biobank_csr()``
    order."""
    ids = [f"bb{i}" for i in range(BIOBANK_N)]
    with open(os.path.join(root, "callsets.json"), "w") as f:
        json.dump([{"id": cid, "name": f"S{i:07d}", "variant_set_id": vsid}
                   for i, cid in enumerate(ids)], f)
    with open(os.path.join(root, "variants.jsonl"), "w") as f:
        for v in range(BIOBANK_V):
            start = 41196311 + 16 * v
            carriers = idx[offsets[v]:offsets[v + 1]].tolist()
            f.write(json.dumps({
                "reference_name": "17", "start": start, "end": start + 1,
                "reference_bases": "A", "alternate_bases": ["G"],
                "info": {"AF": [f"{len(carriers) / BIOBANK_N:.6f}"]},
                "variant_set_id": vsid,
                "calls": [{"callset_id": ids[c], "genotype": [0, 1]}
                          for c in carriers],
            }) + "\n")


def biobank_driver(torch, panel10, coords10, rate10):
    """Phase 13: the biobank width through ``VariantsPcaDriver.run()``."""
    from spark_examples_tpu_torch.genomics.sources import JsonlSource
    from spark_examples_tpu_torch.ops import sketch
    from spark_examples_tpu_torch.ops.sketch import SketchPanel
    from spark_examples_tpu_torch.utils.stats import IoStats

    vsid = "biobank"
    root = tempfile.mkdtemp(prefix="chip_smoke_biobank_")
    try:
        t0 = time.perf_counter()
        idx, offsets = biobank_csr()
        write_biobank_cohort(root, idx, offsets, vsid)
        print(f"  cohort directory written in {time.perf_counter() - t0:.2f}"
              f" s: callsets.json "
              f"{os.path.getsize(os.path.join(root, 'callsets.json'))} "
              f"bytes, variants.jsonl "
              f"{os.path.getsize(os.path.join(root, 'variants.jsonl'))} "
              "bytes", flush=True)
        kw = dict(variant_set_ids=[vsid], pca_mode="auto", num_pc=BIOBANK_K,
                  sketch_power_iters=0, sketch_seed=0)
        for name, profiled in (("cold sidecar", False),
                               ("warm sidecar", False),
                               ("warm sidecar, profiled", True)):
            before = dict(sketch.SKETCH_WINDOWS)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            driver, result, _, launches, _, prof = drive_file(
                torch, JsonlSource(root), f"auto, {name}", profiled=profiled,
                **kw)
            peak = torch.cuda.max_memory_allocated()
            routes = {r: sketch.SKETCH_WINDOWS[r] - before[r]
                      for r in before}
            panel = driver.g
            secs = driver.timer.seconds
            rate = BIOBANK_N / (secs["ingest+gramian"] + secs["pca"])
            print(f"    SketchPanel: {isinstance(panel, SketchPanel)}; "
                  f"windows by route {routes}; peak card memory {peak} "
                  f"bytes ({peak / 2**20:.1f} MiB), {peak - held} of them "
                  f"allocated by the run; samples/s over ingest+gramian and "
                  f"pca {rate:.2f} (phase 10's panel and finish: "
                  f"{rate10:.2f})", flush=True)
            check(driver.sketch_selected() and isinstance(panel, SketchPanel),
                  "auto at N = 2^20 must return a SketchPanel")
            check(launches == 0, "the sketch route must not launch the "
                  "scatter kernel")
            check(peak < SKETCH_PEAK_BYTES,
                  "peak card memory must stay under 2 GiB")
            check(np.array_equal(panel.y, panel10.y)
                  and np.array_equal(panel.omega, panel10.omega)
                  and np.array_equal(panel.row_sums, panel10.row_sums),
                  "the driver's panel must be phase 10's bit for bit")
            coords = np.array([[pc1, pc2] for _, pc1, pc2 in result])
            check(np.array_equal(coords, coords10[:, :2]),
                  "the emitted coordinates must be phase 10's bit for bit")
            if profiled:
                profile_split(prof)
                for rng, (ms, count) in sorted(host_ranges(
                        prof, FILE_RANGES + SKETCH_RANGES).items()):
                    print(f"  host range {rng}: {ms:.3f} ms over {count}")
        print("  every run's panel and coordinates are phase 10's, bit for "
              "bit")
        csr = driver.source._ensure_csr()
        shard = driver._manifest()[0]
        csr._lookup_indexes = None
        t0 = time.perf_counter()
        csr._shard_keep(shard, driver.index.indexes, vsid, IoStats(), None)
        print(f"  _shard_keep with its ordinal->index lookup over 2^20 "
              f"ids: {(time.perf_counter() - t0) * 1e3:.3f} ms; sidecar "
              f"{os.path.getsize(os.path.join(root, '.variants.csr.npz'))} "
              "bytes")
    finally:
        shutil.rmtree(root, ignore_errors=True)


NET_TOKEN = "chip-smoke-token"


def phase_took(n, t0):
    print(f"  phase {n} took {time.perf_counter() - t0:.2f} s; the script "
          f"so far {time.perf_counter() - T_START:.2f} s")


def in_background(fn, *args):
    """``fn(*args)`` on a thread, started now: a phase's subprocess leg
    beside its in-process legs. Returns the future; ``.result()`` joins it
    and raises what the leg raised."""
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    future = pool.submit(fn, *args)
    pool.shutdown(wait=False)
    return future


def start_cli(root, out_dir, name, *args):
    """``python -m spark_examples_tpu_torch.cli.main *args`` in a
    subprocess, started now, its output in files under ``out_dir`` (a pipe
    left unread would fill and stall it). :func:`collect_cli` waits for
    it."""
    out = open(os.path.join(out_dir, f"{name}.out"), "w+")
    err = open(os.path.join(out_dir, f"{name}.err"), "w+")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "spark_examples_tpu_torch.cli.main", *args],
        cwd=root, stdout=out, stderr=err, text=True)
    atexit.register(proc.kill)
    ended = {}

    def note_end():
        # When the run ends, not when the script collects it.
        proc.wait()
        ended["s"] = time.perf_counter() - t0

    watcher = threading.Thread(target=note_end, daemon=True)
    watcher.start()
    return proc, out, err, watcher, ended


def collect_cli(started, timeout):
    """Wait for a :func:`start_cli` subprocess: (exit code, its standard
    output's lines, the tail of its standard error, seconds from its start
    to its end)."""
    proc, out, err, watcher, ended = started
    try:
        code = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        fail(f"CLI {proc.args[3:]} did not end within {timeout} s")
    watcher.join(timeout=30)
    seconds = ended["s"]
    out.seek(0)
    err.seek(0)
    lines, tail = out.read().splitlines(), err.read()[-2000:]
    out.close()
    err.close()
    return code, lines, tail, seconds


def metric(snapshot, name):
    """One counter of a registry snapshot (0.0 when never incremented)."""
    return float(snapshot["counters"].get(name, 0.0))


def serve_cli(root, env, *extra, seen=None, echo=True):
    """``serve-cohort`` in a subprocess on an ephemeral port; returns the
    process and its URLs (``{"http": ..., "grpc": ...}``, the second with
    ``--grpc-port``) once it listens. The lines it printed until then are
    appended to ``seen`` when given, and printed unless ``echo`` is
    False."""
    return await_listening(spawn_serve_cli(root, env, *extra), seen=seen,
                           echo=echo)


def spawn_serve_cli(root, env, *extra):
    """Start ``serve-cohort`` in a subprocess on an ephemeral port, without
    waiting for it (:func:`await_listening` does)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "spark_examples_tpu_torch.cli.main",
         "serve-cohort", "--input-path", root, "--port", "0",
         "--token", NET_TOKEN, *extra],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    atexit.register(proc.kill)
    return proc


def await_listening(proc, seen=None, echo=True):
    """Read a ``serve-cohort`` subprocess's output until it listens:
    (the process, its URLs)."""
    deadline = time.monotonic() + 120
    urls = {}
    for line in proc.stdout:
        if echo:
            print(f"  serve-cohort | {line.rstrip()}", flush=True)
        if seen is not None:
            seen.append(line.rstrip())
        for scheme in ("grpc", "http"):
            if f" on {scheme}://" in line:
                urls[scheme] = line.split(" on ", 1)[1].split()[0]
        if "http" in urls:
            return proc, urls
        check(time.monotonic() < deadline, "serve-cohort did not listen")
    fail(f"serve-cohort exited {proc.wait()} before listening")


def frame_breakdown(served, driver):
    """The frame tier's host steps for the cohort's one shard, each timed
    alone (best of 3): the server's sidecar slice and frame encoding
    (zlib), the client's decode (CRC, inflate) and ordinal remap."""
    from spark_examples_tpu_torch.genomics import wire

    vsid = driver.conf.variant_set_ids[0]
    shard = driver._manifest()[0]
    ids = served.callset_order()
    digest = wire.callsets_digest(ids)
    lookup = wire.OrdinalLookupCache().get(ids, driver.index.indexes)
    steps = {
        "server slice": lambda: served.stream_carrying_frame(vsid, shard),
    }
    payload = steps["server slice"]()
    steps["server encode (zlib)"] = lambda: wire.encode_shard_frames(
        shard, payload, digest)
    body = steps["server encode (zlib)"]()

    def decode():
        dec = wire.FrameDecoder(expect_digest=digest)
        frames = [f for i in range(0, len(body), 1 << 20)
                  for f in dec.feed(body[i:i + (1 << 20)])]
        dec.finish()
        return frames

    steps["client decode (CRC, inflate)"] = decode
    frames = decode()
    steps["client remap"] = lambda: wire.remap_frames(
        frames, lookup, ids, shard)
    out = {}
    for name, fn in steps.items():
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        out[name] = round(best * 1e3, 3)
    print(f"  frame tier host steps, ms (best of 3; {len(body)} bytes, "
          f"{int(payload[0].size)} carriers): {json.dumps(out)}")


def network_cli_leg(root):
    """Phase 14's CLI leg, on a thread beside its in-process legs:
    ``serve-cohort`` and ``pca --api-url http://`` (with a trace, metrics,
    a manifest and one injected fault) in subprocesses. Returns the pca
    run's completed process, its seconds, its output files and the
    server's lines until it listened."""
    work = tempfile.mkdtemp(prefix="chip_smoke_net_")
    atexit.register(shutil.rmtree, work, True)
    token_file = os.path.join(work, "token.json")
    with open(token_file, "w") as f:
        json.dump({"token": NET_TOKEN}, f)
    env = dict(os.environ, GENOMICS_APPLICATION_CREDENTIALS=token_file)
    seen = []
    proc, urls = serve_cli(root, env, seen=seen, echo=False)
    cli_url = urls["http"]
    try:
        outs = {k: os.path.join(work, k) for k in ("trace.json",
                                                  "metrics.prom",
                                                  "manifest.json")}
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "spark_examples_tpu_torch.cli.main",
             "pca", "--api-url", cli_url, "--pca-mode", "sparse",
             "--trace-out", outs["trace.json"],
             "--metrics-out", outs["metrics.prom"],
             "--manifest-out", outs["manifest.json"],
             "--fault-plan", json.dumps({"seed": 0, "rules": [
                 {"site": "transport.http.request",
                  "match": "/variants-csr", "times": 1}]})],
            cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
            capture_output=True, text=True, timeout=300)
        cli_s = time.perf_counter() - t0
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    return cli, cli_s, outs, seen


def network_tier(torch, root, g_ref, want, n_blocks, phase4_launches):
    """Phase 14: ``serve-cohort`` and ``pca --api-url http://`` over phase
    12's directory. Returns the scatter launches of the frame-tier sparse
    run."""
    from spark_examples_tpu_torch import obs
    from spark_examples_tpu_torch.genomics.auth import Credentials
    from spark_examples_tpu_torch.genomics.fixtures import (
        DEFAULT_VARIANT_SET_ID,
    )
    from spark_examples_tpu_torch.genomics.service import (
        GenomicsServiceServer,
        HttpVariantSource,
    )
    from spark_examples_tpu_torch.genomics.sources import (
        SIDECAR_BASENAME,
        JsonlSource,
    )
    from spark_examples_tpu_torch.resilience import faults

    base = dict(variant_set_ids=[DEFAULT_VARIANT_SET_ID])
    creds = Credentials(NET_TOKEN, "chip-smoke")
    cli_leg = in_background(network_cli_leg, root)
    sidecar_bytes = os.path.getsize(os.path.join(root, SIDECAR_BASENAME))
    served = JsonlSource(root)
    t0 = time.perf_counter()
    indexed = served.ensure_serving_index()
    server = GenomicsServiceServer(served, port=0, token=NET_TOKEN).start()
    url = f"http://127.0.0.1:{server.port}"
    print(f"  server on {url} (token auth), {indexed} records indexed in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    def client(**kw):
        return HttpVariantSource(url, credentials=creds, timeout=120, **kw)

    def coords_err(result):
        coords = np.array([[pc1, pc2] for _, pc1, pc2 in result])
        check(np.isfinite(coords).all(), "coordinates must be finite")
        return float(np.abs(coords - want).max())

    def ingest_s(driver):
        return driver.timer.seconds["ingest+gramian"]

    times = {}
    try:
        frames_client = client()
        with obs.telemetry_session(command="chip_smoke") as session:
            driver, result, g, launches, _, _ = drive_file(
                torch, frames_client, "sparse over the frame tier",
                pca_mode="sparse", **base)
            snap = session.registry.snapshot()
        shards = len(driver._manifest())
        frames = metric(snap, 'wire_frames_total{transport="http"}')
        wire_bytes = metric(snap, 'wire_frame_bytes_total{transport="http"}')
        err = coords_err(result)
        print(f"    G bit-identical to phase 4's: {same_g(g, g_ref)}; "
              f"coordinates vs host f64 oracle {err:.3e}; {frames:.0f} "
              f"frames for {shards} shards, {wire_bytes:.0f} frame bytes "
              f"on the wire (the sidecar file: {sidecar_bytes} bytes)")
        check(launches == phase4_launches,
              f"network sparse: {launches} scatter launches, phase 4 "
              f"launched {phase4_launches}")
        check(same_g(g, g_ref), "network sparse: G is not phase 4's")
        check(err <= COORD_TOL, "network sparse: coordinates beyond the bar")
        check(frames == shards, "one frame per shard must be fetched")
        net_launches = launches

        for mode in ("sparse", "auto"):
            driver, _, g, launches, pinned, _ = drive_file(
                torch, frames_client, f"{mode} over the frame tier, warm",
                pca_mode=mode, **base)
            check(same_g(g, g_ref), f"network {mode}: G is not phase 4's")
            if mode == "auto":
                check(launches == 0, "network auto: no scatter launch")
                check(pinned == n_blocks,
                      f"network auto: {pinned} pinned copies for "
                      f"{n_blocks} blocks")
            times[f"{mode}, frame tier"] = ingest_s(driver)
            driver, _, g, _, _, _ = drive_file(
                torch, JsonlSource(root), f"{mode} --input-path, warm",
                pca_mode=mode, **base)
            check(same_g(g, g_ref), f"--input-path {mode}: G differs")
            times[f"{mode}, --input-path"] = ingest_s(driver)

        driver, _, g, launches, _, _ = drive_file(
            torch, client(wire_frames=False), "sparse over the record tier "
            "(gzip)", pca_mode="sparse", **base)
        check(same_g(g, g_ref), "record tier: G is not phase 4's")
        check(launches == phase4_launches, "record tier: scatter launches")
        times["sparse, record tier"] = ingest_s(driver)

        plan = faults.FaultPlan.from_spec(json.dumps({"seed": 0, "rules": [
            {"site": "transport.http.request", "match": "/variants-csr",
             "times": 1}]}))
        faulted = client()
        with faults.active_plan(plan):
            _, _, g, _, _, _ = drive_file(
                torch, faulted, "sparse, one injected transport.http.request "
                "fault on /variants-csr", pca_mode="sparse", **base)
        print("    " + " | ".join(faulted.stats.report().splitlines()[2:]))
        check(plan.fired_total == 1, "the fault must fire exactly once")
        check(same_g(g, g_ref), "the retried run's G is not phase 4's")
        check(faulted.stats.unsuccessful_responses == 0
              and faulted.stats.io_exceptions == 0,
              "a retried fault must leave IoStats clean")

        print("  a warm sparse run over the frame tier under torch.profiler "
              "(all threads):", flush=True)
        _, _, _, _, _, prof = drive_file(
            torch, frames_client, "sparse over the frame tier, profiled",
            profiled=True, pca_mode="sparse", **base)
        profile_split(prof)
        for name, (ms, count) in sorted(host_ranges(
                prof, NET_RANGES).items()):
            print(f"  host range {name}: {ms:.3f} ms over {count}")
        frame_breakdown(served, driver)
    finally:
        server.stop()
    print("  ingest+gramian seconds, warm: " + json.dumps(
        {k: round(v, 6) for k, v in times.items()}))

    print("  the CLI in subprocesses, run beside the legs above: "
          "serve-cohort and pca --api-url", flush=True)
    cli, cli_s, outs, seen = cli_leg.result(timeout=600)
    for line in seen:
        print(f"  serve-cohort | {line}")
    lines = cli.stdout.splitlines()
    print(f"  pca --api-url ({cli_s:.2f} s):")
    for line in lines:
        if line.count("\t") != 3:
            print(f"  | {line}")
    check(cli.returncode == 0,
          f"pca --api-url exited {cli.returncode}: {cli.stderr[-2000:]}")
    check(sum(line.count("\t") == 3 for line in lines) == N_SAMPLES,
          "pca --api-url must emit one result line per sample")
    with open(outs["trace.json"]) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    with open(outs["metrics.prom"]) as f:
        prom = f.read()
    with open(outs["manifest.json"]) as f:
        manifest = json.load(f)
    samples = dict(line.rsplit(" ", 1) for line in prom.splitlines()
                   if line and not line.startswith("#"))
    scatter = float(samples.get(
        'sparse_gramian_windows_total{route="scatter"}', 0))
    rpc_count = sum(float(v) for k, v in samples.items()
                    if k.startswith("genomics_rpc_latency_seconds_count"))
    faults_fired = float(samples.get(
        'resilience_faults_injected_total{kind="error",'
        'site="transport.http.request"}', 0))
    devices = manifest["environment"]["torch"]["device_names"]
    print(f"  trace spans ingest.fetch {'ingest.fetch' in names}, "
          f"wire_frame_fetch {'wire_frame_fetch' in names}; metrics: "
          f"scatter windows {scatter:.0f}, RPC latency samples "
          f"{rpc_count:.0f}, injected faults {faults_fired:.0f}; manifest "
          f"devices {devices}")
    check({"ingest.fetch", "wire_frame_fetch"} <= names,
          "the trace must hold ingest.fetch and wire_frame_fetch spans")
    check(scatter == phase4_launches,
          "the metrics must count phase 4's scatter windows")
    check(rpc_count > 0, "genomics_rpc_latency_seconds must have samples")
    check(faults_fired == 1, "the CLI's --fault-plan must fire once")
    check(torch.cuda.get_device_name(0) in devices,
          "the manifest must name the card")
    return net_launches


class CountingSource:
    """The served ``JsonlSource`` with a count of the requests a warm
    mirror must not make: frame fetches, record streams, file exports and
    sidecar exports."""

    def __init__(self, inner):
        self._inner = inner
        self._lock = threading.Lock()
        self.counts = {"frames": 0, "records": 0, "exports": 0,
                       "sidecar": 0}

    def _count(self, key):
        with self._lock:
            self.counts[key] += 1

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def stream_carrying_frame(self, *args, **kwargs):
        self._count("frames")
        return self._inner.stream_carrying_frame(*args, **kwargs)

    def stream_variant_lines(self, *args, **kwargs):
        self._count("records")
        return self._inner.stream_variant_lines(*args, **kwargs)

    def export_lines(self, name):
        self._count("exports")
        return self._inner.export_lines(name)

    def ensure_sidecar(self):
        self._count("sidecar")
        return self._inner.ensure_sidecar()


def tree_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def grpc_cli_leg(root):
    """Phase 15's CLI leg, on a thread beside its in-process legs:
    ``serve-cohort --grpc-port`` and ``pca --api-url grpc://`` in
    subprocesses. Returns the pca run's completed process (None when the
    server printed no gRPC URL), its seconds, the server's URLs and its
    lines until it listened."""
    work = tempfile.mkdtemp(prefix="chip_smoke_grpc_cli_")
    atexit.register(shutil.rmtree, work, True)
    token_file = os.path.join(work, "token.json")
    with open(token_file, "w") as f:
        json.dump({"token": NET_TOKEN}, f)
    env = dict(os.environ, GENOMICS_APPLICATION_CREDENTIALS=token_file)
    seen = []
    proc, urls = serve_cli(root, env, "--grpc-port", "0", seen=seen,
                           echo=False)
    cli, cli_s = None, 0.0
    try:
        if "grpc" in urls:
            t0 = time.perf_counter()
            cli = subprocess.run(
                [sys.executable, "-m", "spark_examples_tpu_torch.cli.main",
                 "pca", "--api-url", urls["grpc"], "--pca-mode", "sparse"],
                cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                capture_output=True, text=True, timeout=300)
            cli_s = time.perf_counter() - t0
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    return cli, cli_s, urls, seen


def grpc_and_mirror(torch, root, g_ref, want, n_blocks, phase4_launches):
    """Phase 15: ``pca --api-url grpc://``, ``serve-cohort --grpc-port``
    and the cohort mirror (``--cache-dir``, ``--mirror-mode``, the cold
    stream) over phase 12's directory. Returns the scatter launches of each
    ``sparse`` run, by leg."""
    from spark_examples_tpu_torch import obs
    from spark_examples_tpu_torch.genomics.auth import Credentials
    from spark_examples_tpu_torch.genomics.fixtures import (
        DEFAULT_VARIANT_SET_ID,
    )
    from spark_examples_tpu_torch.genomics.grpc_transport import (
        GrpcGenomicsServer,
        GrpcVariantSource,
        grpc_available,
    )
    from spark_examples_tpu_torch.genomics.mirror import ColdStreamMirror
    from spark_examples_tpu_torch.genomics.service import (
        GenomicsServiceServer,
        HttpVariantSource,
    )
    from spark_examples_tpu_torch.genomics.shards import (
        shards_for_references,
    )
    from spark_examples_tpu_torch.genomics.sources import JsonlSource
    from spark_examples_tpu_torch.resilience import faults
    from spark_examples_tpu_torch.utils.config import PcaConfig

    base = dict(variant_set_ids=[DEFAULT_VARIANT_SET_ID])
    creds = Credentials(NET_TOKEN, "chip-smoke")
    have_grpc = grpc_available()
    if have_grpc:
        cli_leg = in_background(grpc_cli_leg, root)
    served = CountingSource(JsonlSource(root))
    served.ensure_serving_index()
    http = GenomicsServiceServer(served, port=0, token=NET_TOKEN).start()
    url = f"http://127.0.0.1:{http.port}"
    rpc = None
    if have_grpc:
        import grpc

        rpc = GrpcGenomicsServer(served, port=0, token=NET_TOKEN).start()
        print(f"  {url} and grpc://127.0.0.1:{rpc.port} (token auth) on "
              f"one JsonlSource; grpcio {grpc.__version__}", flush=True)
    else:
        print("  gRPC legs: not run, grpcio is not installed on this host")
    work = tempfile.mkdtemp(prefix="chip_smoke_mirror_")
    atexit.register(shutil.rmtree, work, True)

    def http_client(**kw):
        return HttpVariantSource(url, credentials=creds, timeout=120, **kw)

    def grpc_client(**kw):
        return GrpcVariantSource(f"grpc://127.0.0.1:{rpc.port}",
                                 credentials=creds, timeout=120, **kw)

    def coords_err(result):
        coords = np.array([[pc1, pc2] for _, pc1, pc2 in result])
        check(np.isfinite(coords).all(), "coordinates must be finite")
        return float(np.abs(coords - want).max())

    def ingest_s(driver):
        return driver.timer.seconds["ingest+gramian"]

    def sparse_leg(name, source, expect_launches=True, **kw):
        driver, result, g, launches, _, prof = drive_file(
            torch, source, name, pca_mode="sparse", **base, **kw)
        check(same_g(g, g_ref), f"{name}: G is not phase 4's")
        err = coords_err(result)
        check(err <= COORD_TOL, f"{name}: coordinates beyond the bar")
        if expect_launches:
            check(launches == phase4_launches,
                  f"{name}: {launches} scatter launches, phase 4 launched "
                  f"{phase4_launches}")
        check(launches > 0, f"{name}: the scatter kernel never launched")
        launched[name] = launches
        times[name] = ingest_s(driver)
        return driver, err, prof

    def counts_since(before):
        return {k: served.counts[k] - before[k] for k in served.counts}

    launched, times, sizes = {}, {}, {}
    try:
        if have_grpc:
            frames_client = grpc_client()
            try:
                with obs.telemetry_session(command="chip_smoke") as session:
                    driver, err, _ = sparse_leg("grpc sparse, frame tier",
                                                frames_client)
                    snap = session.registry.snapshot()
                shards = len(driver._manifest())
                frames = metric(snap, 'wire_frames_total{transport="grpc"}')
                sizes["grpc frame bytes"] = metric(
                    snap, 'wire_frame_bytes_total{transport="grpc"}')
                print(f"    G bit-identical to phase 4's; coordinates vs "
                      f"host f64 oracle {err:.3e}; {frames:.0f} frames for "
                      f"{shards} shards, {sizes['grpc frame bytes']:.0f} "
                      "frame bytes over gRPC")
                check(frames == shards, "one frame stream per shard")
                sparse_leg("grpc sparse, frame tier, warm", frames_client)
                driver, _, g, launches, pinned, _ = drive_file(
                    torch, frames_client, "grpc auto, frame tier, warm",
                    pca_mode="auto", **base)
                check(same_g(g, g_ref), "grpc auto: G is not phase 4's")
                check(launches == 0 and pinned == n_blocks,
                      f"grpc auto: {launches} launches, {pinned} pinned "
                      f"copies for {n_blocks} blocks")
                times["grpc auto, frame tier, warm"] = ingest_s(driver)
            finally:
                frames_client.close()
            # The record tier over the first of phase 12's 9 10-kb shards
            # (its window scatters), against the frame tier over the same
            # shard: cut to keep the script inside half its limit.
            cut = dict(references=RECORD_REFS, bases_per_partition=CKPT_BASES,
                       pca_mode="sparse", **base)
            frames_client = grpc_client()
            try:
                _, _, g_cut, want_launches, _, _ = drive_file(
                    torch, frames_client,
                    "grpc sparse, frame tier, the record tier's shards", **cut)
            finally:
                frames_client.close()
            records_client = grpc_client(wire_frames=False)
            try:
                driver, _, g, launches, _, _ = drive_file(
                    torch, records_client, "grpc sparse, record tier", **cut)
            finally:
                records_client.close()
            shards = len(driver._manifest())
            check(np.array_equal(g, g_cut),
                  "record tier: G is not the frame tier's over its shards")
            check(launches == want_launches and launches > 0,
                  f"record tier: {launches} scatter launches, the frame tier "
                  f"{want_launches} over the same {shards} shards")
            print(f"    the record tier over {shards} shards ({RECORD_REFS}): "
                  f"G bit-identical to the frame tier's over them, "
                  f"{launches} scatter launches as there")
            launched["grpc sparse, frame tier, the record tier's shards"] = (
                want_launches)
            launched["grpc sparse, record tier"] = launches
            times["grpc sparse, record tier"] = ingest_s(driver)
            plan = faults.FaultPlan.from_spec(json.dumps({"seed": 0,
                "rules": [{"site": "transport.grpc.request",
                           "match": "StreamVariantFrames", "times": 1}]}))
            faulted = grpc_client()
            try:
                with faults.active_plan(plan):
                    sparse_leg("grpc sparse, one injected "
                               "transport.grpc.request fault", faulted)
            finally:
                faulted.close()
            check(plan.fired_total == 1, "the fault must fire exactly once")
            check(faulted.stats.unsuccessful_responses == 0
                  and faulted.stats.io_exceptions == 0,
                  "a retried fault must leave IoStats clean")

        # Mirror legs over HTTP, each on a fresh --cache-dir. The cold leg
        # cuts the cohort's reference range into 8 shards.
        refs = PcaConfig().references
        _, start, end = refs.split(":")
        bases = -(-(int(end) - int(start)) // 8)
        check(len(shards_for_references(refs, bases)) == 8,
              "the cold leg needs 8 shards")
        cold_cache = os.path.join(work, "cold")
        before = dict(served.counts)
        cold_client = http_client(cache_dir=cold_cache)
        t0 = time.perf_counter()
        with obs.telemetry_session(command="chip_smoke") as session:
            driver, _, g, launches, _, _ = drive_file(
                torch, cold_client, "sparse, cold stream (8 shards, 4 "
                "workers)", pca_mode="sparse", bases_per_partition=bases,
                ingest_workers=4, **base)
            cold_run_s = time.perf_counter() - t0
            writer = cold_client._resolve_mirror()
            check(isinstance(writer, ColdStreamMirror),
                  "the cold leg must stream while the mirror writes through")
            check(writer.join(timeout=300), "the mirror writer did not end")
            cold_total_s = time.perf_counter() - t0
            snap = session.registry.snapshot()
        fetched = metric(snap, 'cold_stream_shards_total{stage="fetched"}')
        accumulated = metric(
            snap, 'cold_stream_shards_total{stage="accumulated"}')
        scatter = metric(snap,
                         'sparse_gramian_windows_total{route="scatter"}')
        (mirror_dir,) = [d for d in os.listdir(cold_cache)
                         if d.startswith("cohort-")]
        complete = os.path.exists(os.path.join(cold_cache, mirror_dir,
                                               ".complete"))
        print(f"    cold_stream_shards_total fetched {fetched:.0f}, "
              f"accumulated {accumulated:.0f}; {launches} scatter launches "
              f"for {scatter:.0f} scatter windows (completion order); run "
              f"{cold_run_s:.3f} s, mirror complete {complete} after "
              f"{cold_total_s:.3f} s; requests {counts_since(before)}")
        check(same_g(g, g_ref), "cold stream: G is not phase 4's")
        check(fetched == 8 and accumulated == 8,
              "every shard must be fetched and accumulated once")
        check(launches > 0 and launches == scatter,
              "the cold run must launch the kernel once per scatter window")
        check(complete, "the write-through mirror must be .complete")
        launched["sparse, cold stream"] = launches
        times["sparse, cold stream"] = ingest_s(driver)
        sizes["full mirror bytes"] = tree_bytes(
            os.path.join(cold_cache, mirror_dir))

        before = dict(served.counts)
        warm = http_client(cache_dir=cold_cache)
        check(not warm.cold_stream_active(), "the second run must be warm")
        sparse_leg("sparse, warm mirror", warm)
        driver, _, g, launches, pinned, _ = drive_file(
            torch, warm, "auto, warm mirror", pca_mode="auto", **base)
        check(same_g(g, g_ref) and launches == 0 and pinned == n_blocks,
              "auto over the warm mirror")
        times["auto, warm mirror"] = ingest_s(driver)
        print("  the warm mirror-served sparse run under torch.profiler "
              "(all threads):", flush=True)
        _, _, prof = sparse_leg("sparse, warm mirror, profiled", warm,
                                profiled=True)
        profile_split(prof)
        asked = counts_since(before)
        print(f"    server requests over the warm runs: {asked}; client "
              f"{warm.stats.report().splitlines()[2:]}")
        check(asked == {"frames": 0, "records": 0, "exports": 0,
                        "sidecar": 0},
              "a warm mirror must make no frame, record or export request")

        for mode in ("light", "full"):
            cache = os.path.join(work, f"phased-{mode}")
            client = http_client(cache_dir=cache, mirror_mode=mode,
                                 cold_stream=False)
            t0 = time.perf_counter()
            client.list_callsets(DEFAULT_VARIANT_SET_ID)  # the download
            times[f"{mode} mirror download"] = time.perf_counter() - t0
            (mdir,) = [d for d in os.listdir(cache)
                       if d.startswith("cohort-")]
            files = sorted(os.listdir(os.path.join(cache, mdir)))
            sizes[f"{mode} mirror bytes"] = tree_bytes(
                os.path.join(cache, mdir))
            check(("variants.jsonl" in files) == (mode == "full"),
                  f"{mode} mirror files: {files}")
            sparse_leg(f"sparse, {mode} mirror"
                       + (", --no-cold-stream" if mode == "full" else ""),
                       client)
        phased_s = (times["full mirror download"]
                    + times["sparse, full mirror, --no-cold-stream"])
        print(f"    cold stream: run {cold_run_s:.3f} s (mirror complete "
              f"after {cold_total_s:.3f} s); phased: download "
              f"{times['full mirror download']:.3f} s + ingest+gramian "
              f"{times['sparse, full mirror, --no-cold-stream']:.3f} s; "
              f"phased/cold {phased_s / cold_run_s:.2f}")

        if have_grpc:
            before = dict(served.counts)
            shared = grpc_client(cache_dir=cold_cache)
            try:
                sparse_leg("grpc sparse, warm over the HTTP client's cache",
                           shared)
            finally:
                shared.close()
            check(counts_since(before) == {"frames": 0, "records": 0,
                                           "exports": 0, "sidecar": 0},
                  "the gRPC client must be served by the HTTP mirror")
    finally:
        http.stop()
        if rpc is not None:
            rpc.stop()
    print("  ingest+gramian and download seconds: " + json.dumps(
        {k: round(v, 6) for k, v in times.items()}))
    print("  bytes: " + json.dumps({k: int(v) for k, v in sizes.items()}))

    if have_grpc:
        print("  the CLI in subprocesses, run beside the legs above: "
              "serve-cohort --grpc-port and pca --api-url grpc://",
              flush=True)
        cli, cli_s, urls, seen = cli_leg.result(timeout=600)
        for line in seen:
            print(f"  serve-cohort | {line}")
        check("grpc" in urls, "serve-cohort must print its gRPC URL")
        lines = cli.stdout.splitlines()
        print(f"  pca --api-url grpc:// ({cli_s:.2f} s):")
        for line in lines:
            if line.count("\t") != 3:
                print(f"  | {line}")
        check(cli.returncode == 0, f"pca --api-url grpc:// exited "
              f"{cli.returncode}: {cli.stderr[-2000:]}")
        check(sum(line.count("\t") == 3 for line in lines) == N_SAMPLES,
              "pca --api-url grpc:// must emit one result line per sample")
    return launched


# -- phase 16: reads and PairHMM ---------------------------------------------

# bench.py's PairHMM leg (its pairhmm_bench): 2048 reads of 100 bases over
# 40 kb, seed 7, 10,000 bases a shard, --pairhmm-batch 128.
PHMM_REFS = "11:6880000:6920000"
PHMM_READS = 2048
PHMM_SEED = 7
READS_BASES = 10_000
# 30x whole-genome-sequencing depth over a 50 kb window (cut from 60,000
# reads over 200 kb to keep the script inside half its time limit), and a
# tumor/normal pair at 30x in each readset over 100 kb.
# Phase 15's gRPC record tier reads this part of phase 12's directory: its
# first 10-kb shard of nine (cut from all of them, 28-34 s, then from two,
# 9.2 s, to keep the script inside half its time limit).
RECORD_REFS = "17:41196311:41206311"
COVERAGE_REFS = "11:6800000:6850000"
COVERAGE_READS = 15_000
TN_REFS = "1:100000000:100100000"
TN_READS = 30_000


class CountingReads(CountingSource):
    """:class:`CountingSource` that also counts read streams."""

    def __init__(self, inner):
        super().__init__(inner)
        self.counts["reads"] = 0

    def stream_reads(self, *args, **kwargs):
        self._count("reads")
        return self._inner.stream_reads(*args, **kwargs)


def timed_pairhmm_driver():
    """``PairHmmDriver`` with its host prep (summed over the prep
    threads) and its forward tiles (the driver's thread) timed."""
    from spark_examples_tpu_torch.models.pairhmm import PairHmmDriver

    class TimedPairHmmDriver(PairHmmDriver):
        def __init__(self, conf, source):
            super().__init__(conf, source)
            self.prep_s = 0.0
            self.forward_s = 0.0
            self.tiles = 0
            self._lock = threading.Lock()

        def _shard_pairs(self, shard):
            t0 = time.perf_counter()
            pairs = super()._shard_pairs(shard)
            with self._lock:
                self.prep_s += time.perf_counter() - t0
            return pairs

        def _score_tile(self, r_bucket, h_bucket, tile):
            t0 = time.perf_counter()
            rows = super()._score_tile(r_bucket, h_bucket, tile)
            self.forward_s += time.perf_counter() - t0
            self.tiles += 1
            return rows

    return TimedPairHmmDriver


def bench_tile(b, r_b, h_b, read_len, hap_len, seed=11):
    """bench.py's resident tile: random reads and haplotypes of the
    pipeline's dominant bucket."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 4, (b, r_b)).astype(np.int8),
            rng.integers(10, 50, (b, r_b)).astype(np.int32),
            np.full(b, read_len, np.int32),
            rng.integers(0, 4, (b, h_b)).astype(np.int8),
            np.full(b, hap_len, np.int32))


def profile_tile(torch, forward, tile):
    """One tile under ``torch.profiler``: (kernels launched, wall ms,
    device idle share, the kernel events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("chip_smoke.tile"):
            forward(tile)
            torch.cuda.synchronize()
    events = prof.events()
    (window,) = [(e.time_range.start, e.time_range.end) for e in events
                 if e.name == "chip_smoke.tile"
                 and e.device_type == DeviceType.CPU]
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.name != "chip_smoke.tile"]
    kernels = [e for e in device if not e.name.startswith(("Memcpy",
                                                           "Memset"))]
    lo, hi = window
    busy = merged_busy_us([(e.time_range.start, e.time_range.end)
                           for e in device], lo, hi)
    idle = 1 - busy / (hi - lo) if device else float("nan")
    return len(kernels), (hi - lo) / 1e3, idle, kernels


def pairhmm_and_reads(torch, dev):
    """Phase 16: ``pairhmm``, ``reads-example 3/4`` and the reads
    transports on the card. Returns the scatter launches of the phase
    (there must be none) and its numbers."""
    from spark_examples_tpu_torch.genomics.auth import Credentials
    from spark_examples_tpu_torch.genomics.fixtures import (
        FIXTURE_READSET_ID,
        synthetic_reads,
        synthetic_tumor_normal,
    )
    from spark_examples_tpu_torch.genomics.grpc_transport import (
        GrpcGenomicsServer,
        GrpcVariantSource,
        grpc_available,
    )
    from spark_examples_tpu_torch.genomics.service import (
        GenomicsServiceServer,
        HttpVariantSource,
    )
    from spark_examples_tpu_torch.genomics.shards import (
        shards_for_references,
    )
    from spark_examples_tpu_torch.genomics.sources import JsonlSource
    from spark_examples_tpu_torch.models.pairhmm import PairHmmDriver
    from spark_examples_tpu_torch.models.search_reads import (
        per_base_depth_example,
        tumor_normal_diff,
    )
    from spark_examples_tpu_torch.ops import scatter_kernel as sk
    from spark_examples_tpu_torch.ops.pairhmm import (
        PAIRHMM_FORWARD_ATOL,
        PAIRHMM_FORWARD_RTOL,
        PAIRHMM_NEG_INF,
        pairhmm_bucket,
        pairhmm_forward_batch,
        pairhmm_forward_ref,
    )
    from spark_examples_tpu_torch.utils.config import PcaConfig

    work = tempfile.mkdtemp(prefix="chip_smoke_reads_")
    atexit.register(shutil.rmtree, work, True)
    Timed = timed_pairhmm_driver()
    numbers = {}

    def within_bars(got, want):
        return abs(got - want) <= PAIRHMM_FORWARD_ATOL + (
            PAIRHMM_FORWARD_RTOL * abs(want))

    def conf(references=PHMM_REFS, device="cuda", **kw):
        return PcaConfig(references=references,
                         bases_per_partition=READS_BASES,
                         read_group_set_id=FIXTURE_READSET_ID,
                         device=device, **kw)

    sk.SCATTER_KERNEL_LAUNCHES = 0

    # -- the bench shape ------------------------------------------------------
    t0 = time.perf_counter()
    bench = synthetic_reads(PHMM_READS, references=PHMM_REFS, read_len=100,
                            seed=PHMM_SEED)
    print(f"  bench shape: {PHMM_READS} reads of 100 bases over "
          f"{PHMM_REFS}, generated in {time.perf_counter() - t0:.2f} s",
          flush=True)
    t0 = time.perf_counter()
    rows = Timed(conf(), bench).run_rows()
    print(f"  first run (warm-up): {time.perf_counter() - t0:.3f} s")
    values = np.array([v for _, v, _ in rows])
    check(len(rows) == PHMM_READS
          and np.isfinite(values).all()
          and (values > PAIRHMM_NEG_INF / 2).all() and (values < 0).all(),
          "the bench shape must score every read with a finite "
          "log-likelihood below 0")
    buckets = sorted({b for _, _, b in rows})
    runs = []
    for _ in range(2):
        driver = Timed(conf(), bench)
        t0 = time.perf_counter()
        again = driver.run_rows()
        runs.append((time.perf_counter() - t0, driver))
        check(again == rows, "a repeat's rows differ from the first run's")
    best_s, best = min(runs, key=lambda r: r[0])
    numbers["pipeline_pairs_per_s"] = len(rows) / best_s
    numbers["pipeline_s"] = best_s
    print(f"  pipeline: best of 2 {best_s:.4f} s, "
          f"{numbers['pipeline_pairs_per_s']:.1f} pairs/s; {best.tiles} "
          f"tiles, forward {best.forward_s:.4f} s, host prep "
          f"{best.prep_s:.4f} s (summed over threads); buckets {buckets}")
    wide = Timed(conf(pairhmm_batch=2048), bench)
    check(wide.run_rows() == rows,
          "rows at --pairhmm-batch 2048 differ from 128's")
    print(f"  --pairhmm-batch 2048: rows bit-identical to 128's "
          f"({wide.tiles} tile(s), forward {wide.forward_s:.4f} s)")

    pairs = {}
    for shard in shards_for_references(PHMM_REFS, READS_BASES):
        for name, codes, quals, seg in best._shard_pairs(shard):
            pairs[name] = (codes, quals, seg)
    by_name = {name: v for name, v, _ in rows}
    pick = np.random.default_rng(16).choice(sorted(pairs), 64,
                                            replace=False)
    t0 = time.perf_counter()
    gold = {n: pairhmm_forward_ref(*pairs[n]) for n in pick}
    ref_err = max(abs(by_name[n] - gold[n]) for n in pick)
    check(all(within_bars(by_name[n], gold[n]) for n in pick),
          "a sampled pair is beyond the bars of the float64 golden")
    print(f"  64 sampled pairs vs pairhmm_forward_ref (f64): max abs err "
          f"{ref_err:.3e} (bars rtol {PAIRHMM_FORWARD_RTOL}, atol "
          f"{PAIRHMM_FORWARD_ATOL}; {time.perf_counter() - t0:.2f} s)")
    t0 = time.perf_counter()
    cpu_rows = PairHmmDriver(conf(device="cpu"), bench).run_rows()
    cpu_s = time.perf_counter() - t0
    check([(n, b) for n, _, b in cpu_rows] == [(n, b) for n, _, b in rows],
          "--device cpu scored other pairs or buckets")
    check(all(within_bars(v, c) for (_, v, _), (_, c, _) in
              zip(rows, cpu_rows)), "card and CPU rows beyond the bars")
    cpu_err = max(abs(v - c) for (_, v, _), (_, c, _) in
                  zip(rows, cpu_rows))
    same = sum(v == c for (_, v, _), (_, c, _) in zip(rows, cpu_rows))
    print(f"  every pair vs --device cpu ({cpu_s:.2f} s): max abs err "
          f"{cpu_err:.3e}, {same} of {len(rows)} bit-identical")
    numbers["max_err_f64"], numbers["max_err_cpu"] = ref_err, cpu_err

    r_b, h_b = pairhmm_bucket(100), pairhmm_bucket(116)
    go, ge = np.float32(45.0), np.float32(10.0)

    def forward(tile):
        return pairhmm_forward_batch(*tile, go, ge, device=dev)

    def on_card(b, h_bucket=h_b):
        return [torch.from_numpy(a).to(dev)
                for a in bench_tile(b, r_b, h_bucket, 100, 116)]

    for b in (128, 2048):
        tile = on_card(b)
        forward(tile).cpu()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            forward(tile).cpu()  # the copy back is the barrier
            walls.append(time.perf_counter() - t0)
        numbers[f"tile_ms_b{b}"] = min(walls) * 1e3
        numbers[f"tile_pairs_per_s_b{b}"] = b / min(walls)
        print(f"  resident tile r{r_b}xh{h_b}, B = {b}: best of 3 "
              f"{min(walls) * 1e3:.3f} ms, {b / min(walls):.1f} pairs/s")
    tile = on_card(128)
    base = forward(tile)
    perm = torch.from_numpy(np.random.default_rng(3).permutation(128)).to(dev)
    shuffled = forward([t[perm] for t in tile])
    check(torch.equal(base[perm], shuffled),
          "a shuffled tile is not bit-identical on the card")
    print("  a shuffled B = 128 tile: bit-identical on the card")
    k_128, ms, idle, kernels = profile_tile(torch, forward, tile)
    k_256 = profile_tile(torch, forward, on_card(128, 2 * h_b))[0]
    per_diag = (k_256 - k_128) / h_b
    numbers.update(kernels_per_tile=k_128, kernels_per_diagonal=per_diag,
                   profiled_tile_ms=ms, tile_idle_share=idle)
    print(f"  one profiled B = 128 tile ({r_b + h_b} diagonals): {k_128} "
          f"CUDA kernels, {ms:.3f} ms wall-clock, device idle share "
          f"{idle:.4f}; kernels per diagonal {per_diag:.2f} (h{2 * h_b} "
          f"tile: {k_256})")
    print_device_time(kernels, top=8)

    # -- coverage: 30x over 50 kb --------------------------------------------
    t0 = time.perf_counter()
    coverage = synthetic_reads(COVERAGE_READS, references=COVERAGE_REFS,
                               read_len=100)
    cov_dir = os.path.join(work, "coverage")
    coverage.dump(cov_dir)
    del coverage
    print(f"  coverage: {COVERAGE_READS} reads over {COVERAGE_REFS} "
          f"generated and dumped in {time.perf_counter() - t0:.2f} s",
          flush=True)
    driver = Timed(conf(COVERAGE_REFS, pairhmm_batch=2048),
                   JsonlSource(cov_dir))
    t0 = time.perf_counter()
    cov_rows = driver.run_rows()
    cov_s = time.perf_counter() - t0
    cov_values = np.array([v for _, v, _ in cov_rows])
    check(len(cov_rows) == COVERAGE_READS
          and np.isfinite(cov_values).all() and (cov_values < 0).all(),
          "the coverage run must score every read")
    numbers.update(coverage_s=cov_s, coverage_forward_s=driver.forward_s,
                   coverage_prep_s=driver.prep_s)
    print(f"  pairhmm --pairhmm-batch 2048 over it: {cov_s:.3f} s "
          f"({COVERAGE_READS / cov_s:.1f} pairs/s); {driver.tiles} tiles, "
          f"forward {driver.forward_s:.3f} s on the driver's thread, host "
          f"prep {driver.prep_s:.3f} s summed over "
          f"{driver._prep_workers()} threads", flush=True)
    depth = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        path = per_base_depth_example(
            JsonlSource(cov_dir), FIXTURE_READSET_ID,
            references=COVERAGE_REFS,
            out_path=os.path.join(work, f"example3-{device}"),
            bases_per_shard=READS_BASES, device=device)
        numbers[f"example3_{device}_s"] = time.perf_counter() - t0
        with open(path, "rb") as f:
            depth[device] = f.read()
    check(depth["cuda"] == depth["cpu"],
          "example 3's depth file on the card differs from --device cpu's")
    lines = depth["cuda"].decode().splitlines()
    mean_depth = np.mean([int(line[1:-1].split(",")[1]) for line in lines])
    check(25 < mean_depth < 35, f"mean depth {mean_depth:.2f}, not ~30x")
    print(f"  reads-example 3 (5 shards): {len(lines)} covered bases, mean "
          f"depth {mean_depth:.2f}; the file byte-identical to --device "
          f"cpu's; {numbers['example3_cuda_s']:.3f} s on the card, "
          f"{numbers['example3_cpu_s']:.3f} s on the CPU")

    # -- tumor/normal: 30x in each readset over 100 kb ------------------------
    t0 = time.perf_counter()
    pair = synthetic_tumor_normal(TN_READS, references=TN_REFS)
    print(f"  tumor/normal: {TN_READS} reads a readset over {TN_REFS}, "
          f"generated in {time.perf_counter() - t0:.2f} s", flush=True)
    diff = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        path = tumor_normal_diff(
            pair, references=TN_REFS,
            normal_id="fixture-normal", tumor_id="fixture-tumor",
            out_path=os.path.join(work, f"example4-{device}"),
            device=device)
        numbers[f"example4_{device}_s"] = time.perf_counter() - t0
        with open(path, "rb") as f:
            diff[device] = f.read()
    check(diff["cuda"] == diff["cpu"],
          "example 4's diff file on the card differs from --device cpu's")
    found = {int(line[1:].split(",")[0])
             for line in diff["cuda"].decode().splitlines()}
    check(set(pair.somatic_positions) <= found,
          f"example 4 missed somatic positions "
          f"{sorted(set(pair.somatic_positions) - found)}")
    print(f"  reads-example 4: {len(found)} differing positions, every "
          f"somatic position {pair.somatic_positions} among them; the file "
          f"byte-identical to --device cpu's; "
          f"{numbers['example4_cuda_s']:.3f} s on the card, "
          f"{numbers['example4_cpu_s']:.3f} s on the CPU")

    # -- the transports and the mirror ---------------------------------------
    bench_dir = os.path.join(work, "bench")
    bench.dump(bench_dir)
    served = CountingReads(JsonlSource(bench_dir))
    creds = Credentials(NET_TOKEN, "chip-smoke")
    http = GenomicsServiceServer(served, port=0, token=NET_TOKEN).start()
    url = f"http://127.0.0.1:{http.port}"
    rpc = (GrpcGenomicsServer(served, port=0, token=NET_TOKEN).start()
           if grpc_available() else None)
    clients = []

    def net_leg(name, source):
        before = dict(served.counts)
        t0 = time.perf_counter()
        got = PairHmmDriver(conf(), source).run_rows()
        numbers[f"{name}_s"] = time.perf_counter() - t0
        check(got == rows, f"{name}: rows differ from the local run's")
        asked = {k: served.counts[k] - before[k] for k in served.counts}
        print(f"  pairhmm over {name}: rows bit-identical to the local "
              f"run, {numbers[f'{name}_s']:.3f} s; server requests {asked}")
        return asked

    try:
        net_leg("http", HttpVariantSource(url, credentials=creds,
                                          timeout=120))
        if rpc is not None:
            clients.append(GrpcVariantSource(
                f"grpc://127.0.0.1:{rpc.port}", credentials=creds,
                timeout=120))
            net_leg("grpc", clients[-1])
        else:
            print("  pairhmm over grpc: not run, grpcio is not installed "
                  "on this host")
        cache = os.path.join(work, "cache")
        net_leg("http, mirror download", HttpVariantSource(
            url, credentials=creds, timeout=120, cache_dir=cache,
            cold_stream=False))
        asked = net_leg("http, warm mirror", HttpVariantSource(
            url, credentials=creds, timeout=120, cache_dir=cache))
        check(asked["reads"] == 0 and asked["exports"] == 0,
              "the warm mirror run asked the server for reads")
    finally:
        for client in clients:
            client.close()
        http.stop()
        if rpc is not None:
            rpc.stop()
    launches = sk.SCATTER_KERNEL_LAUNCHES
    check(launches == 0, f"phase 16 launched the scatter kernel "
          f"{launches} times")
    print(f"  scatter kernel launches in phase 16: {launches}")
    print("  phase 16 numbers: " + json.dumps(
        {k: round(float(v), 6) for k, v in numbers.items()}))
    return launches, bench_dir


# -- phase 17: the host ingest core and its resilience -----------------------


def stage_idle(prof, stage="ingest+gramian"):
    """The device's idle share of one stage range of a profile, or None
    where the profile holds no CUDA event."""
    from torch.autograd import DeviceType

    events = prof.events()
    device = [(e.time_range.start, e.time_range.end) for e in events
              if e.device_type == DeviceType.CUDA
              and e.name not in ANNOTATIONS]
    ranges = [(e.time_range.start, e.time_range.end) for e in events
              if e.name == stage and e.device_type == DeviceType.CPU]
    if not device or not ranges:
        return None
    lo, hi = ranges[0]
    return 1 - merged_busy_us(device, lo, hi) / (hi - lo)


def sidecars_equal(a, b) -> bool:
    """Two sidecars' members equal, name for name, dtype for dtype."""
    return sorted(a) == sorted(b) and all(
        np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
        and np.array_equal(np.asarray(a[k]), np.asarray(b[k]),
                           equal_nan=np.asarray(a[k]).dtype.kind == "f")
        for k in a)


def host_ingest_core(torch, root, g_ref, want, windows, phase4_launches):
    """Phase 17: the native host core and ingest resilience over phase 12's
    directory. Returns the scatter launches of each ``sparse`` run."""
    from spark_examples_tpu_torch import obs
    from spark_examples_tpu_torch.arrays.blocks import packed_block_from_csr
    from spark_examples_tpu_torch.genomics.fixtures import (
        DEFAULT_VARIANT_SET_ID,
    )
    from spark_examples_tpu_torch.genomics.sources import (
        SIDECAR_BASENAME,
        JsonlSource,
        _CsrCohort,
    )
    from spark_examples_tpu_torch.resilience import faults
    from spark_examples_tpu_torch.tools.ingest_workers import (
        builder_thread_table,
    )
    from spark_examples_tpu_torch.utils import concurrency
    from spark_examples_tpu_torch.utils.config import PcaConfig

    base = dict(variant_set_ids=[DEFAULT_VARIANT_SET_ID])
    sidecar = os.path.join(root, SIDECAR_BASENAME)
    numbers = {}
    by_leg = {}

    def coords_err(result):
        coords = np.array([[pc1, pc2] for _, pc1, pc2 in result])
        check(np.isfinite(coords).all(), "coordinates must be finite")
        return float(np.abs(coords - want).max())

    print("  (a) the cold sidecar build, native against Python", flush=True)
    open_fn = JsonlSource(root)._open
    builds = {}
    for name, native in (("python", False), ("native", True)):
        if os.path.exists(sidecar):
            os.unlink(sidecar)
        t0 = time.perf_counter()
        builds[name] = _CsrCohort.load_or_build(root, open_fn,
                                                native=native)._d
        numbers[f"cold_build_{name}_s"] = time.perf_counter() - t0
    equal = sidecars_equal(builds["native"], builds["python"])
    size = os.path.getsize(os.path.join(root, "variants.jsonl"))
    print(f"    variants.jsonl {size} bytes: Python parse "
          f"{numbers['cold_build_python_s']:.3f} s, native "
          f"{numbers['cold_build_native_s']:.3f} s "
          f"({numbers['cold_build_python_s'] / numbers['cold_build_native_s']:.2f}x); "
          f"the two sidecars equal member by member: {equal}")
    check(equal, "the native and Python sidecars differ")
    ids = builds["native"]["callset_ids"].tolist()
    parses = {}
    for threads in (1, 0, 4):
        t0 = time.perf_counter()
        parses[threads] = _CsrCohort._parse_native(root, ids, threads)
        numbers[f"parse_threads_{threads}_s"] = time.perf_counter() - t0
        check(parses[threads] is not None,
              f"the native parser refused phase 12's file ({threads})")
    same = all(
        all((x == y) if isinstance(x, list) else
            (x.dtype == y.dtype and np.array_equal(x, y, equal_nan=True))
            for x, y in zip(parses[1], parses[t]))
        for t in (0, 4))
    print(f"    native parse alone: 1 thread "
          f"{numbers['parse_threads_1_s']:.3f} s, auto "
          f"{numbers['parse_threads_0_s']:.3f} s, 4 threads "
          f"{numbers['parse_threads_4_s']:.3f} s; bit-identical: {same}")
    check(same, "the threaded native parse differs from one thread's")

    print("  (b) warm ingest+gramian with the native build", flush=True)
    for mode in ("sparse", "auto"):
        reg = obs.get_registry()
        hist = reg.histogram("ingest_block_build_seconds").labels(
            mode="native")
        n0, s0 = hist.count, hist.sum
        driver, result, g, launches, _, prof = drive_file(
            torch, JsonlSource(root), f"{mode}, warm, native build",
            profiled=True, pca_mode=mode, **base)
        idle = stage_idle(prof)
        err = coords_err(result)
        numbers[f"warm_{mode}_s"] = driver.timer.seconds["ingest+gramian"]
        numbers[f"warm_{mode}_idle"] = idle
        blocks = hist.count - n0
        if blocks:
            numbers["driver_native_ms_per_block"] = (
                (hist.sum - s0) / blocks * 1e3)
        print(f"    G bit-identical to phase 12's: {same_g(g, g_ref)}; "
              f"coordinates {err:.3e}; idle share of ingest+gramian "
              f"{'not measured' if idle is None else f'{idle:.4f}'}; "
              f"native blocks built {blocks}")
        check(same_g(g, g_ref), f"warm {mode}: G is not phase 12's")
        check(err <= COORD_TOL, f"warm {mode}: coordinates beyond the bar")
        if mode == "sparse":
            check(launches == phase4_launches,
                  f"warm sparse: {launches} launches, phase 4 "
                  f"{phase4_launches}")
            by_leg["sparse, warm, native build (phase 17b)"] = launches
        else:
            check(blocks == len(windows),
                  f"auto built {blocks} native blocks for "
                  f"{len(windows)} windows")
    for name, native in (("native", True), ("python", False)):
        times = []
        for idx, lens in windows:
            t0 = time.perf_counter()
            packed_block_from_csr(idx, lens, N_SAMPLES, lens.size, native)
            times.append(time.perf_counter() - t0)
        numbers[f"{name}_ms_per_block"] = float(np.median(times)) * 1e3
    packs_equal = all(
        np.array_equal(packed_block_from_csr(i, l, N_SAMPLES, l.size),
                       packed_block_from_csr(i, l, N_SAMPLES, l.size, False))
        for i, l in windows)
    print(f"    packed block, median of {len(windows)} windows: native "
          f"{numbers['native_ms_per_block']:.3f} ms, Python "
          f"{numbers['python_ms_per_block']:.3f} ms; byte-identical: "
          f"{packs_equal}")
    check(packs_equal, "the native and numpy packed blocks differ")

    print("  (c) sparse and auto under a fault plan with --shard-retries 3",
          flush=True)
    rules = [dict(site="ingest.stream", kind="error", times=2),
             dict(site="ingest.build", kind="error", times=2),
             dict(site="ingest.shard", kind="stall", times=2)]
    for mode in ("sparse", "auto"):
        plan = faults.FaultPlan.from_dict({"seed": 17, "rules": rules})
        with obs.telemetry_session(command="chip_smoke") as session, \
                faults.active_plan(plan):
            driver, result, g, launches, _, _ = drive_file(
                torch, JsonlSource(root), f"{mode}, faulted, 3 attempts",
                pca_mode=mode, shard_retries=3, **base)
            snap = session.registry.snapshot()
        retries = sum(v for k, v in snap["counters"].items()
                      if k.startswith("genomics_rpc_retries_total")
                      and 'transport="ingest"' in k)
        fired = plan.fired_by_site()
        # The sparse route builds no packed block: its dense windows are
        # densified inside the sparse engine, so ingest.build cannot fire.
        expect = sum(r["times"] for r in rules
                     if mode == "auto" or r["site"] != "ingest.build")
        err = coords_err(result)
        print(f"    fired {plan.fired_total} ({json.dumps(fired)}), "
              f"expected {expect}; genomics_rpc_retries_total"
              f"{{transport=\"ingest\"}} {retries:.0f}; G bit-identical: "
              f"{same_g(g, g_ref)}; coordinates {err:.3e}")
        numbers[f"faulted_{mode}_fired"] = plan.fired_total
        numbers[f"faulted_{mode}_retries"] = retries
        numbers[f"faulted_{mode}_s"] = driver.timer.seconds["ingest+gramian"]
        check(plan.fired_total == expect,
              f"faulted {mode}: fired {plan.fired_total}, expected {expect}")
        check(retries > 0, f"faulted {mode}: no ingest retry was counted")
        check(same_g(g, g_ref), f"faulted {mode}: G is not phase 12's")
        check(err <= COORD_TOL, f"faulted {mode}: coordinates beyond bar")
        if mode == "sparse":
            check(launches == phase4_launches,
                  f"faulted sparse: {launches} launches, the fault-free "
                  f"run {phase4_launches}")
            by_leg["sparse, faulted, 3 attempts (phase 17c)"] = launches
    plan = faults.FaultPlan.from_dict({"seed": 17, "rules": rules})
    raised = None
    try:
        with faults.active_plan(plan):
            drive_file(torch, JsonlSource(root), "sparse, faulted, 1 attempt",
                       pca_mode="sparse", shard_retries=1, **base)
    except IOError as e:
        raised = e
    print(f"    --shard-retries 1 under the same plan raised: {raised!r}")
    check(raised is not None, "--shard-retries 1 must raise under the plan")

    print("  (d) --speculative-ingest with one stalled shard", flush=True)
    # 33 shards of about 2,000 variants: small shards keep the straggler
    # threshold (SPECULATION_MULTIPLIER x the median shard time, and the
    # four extraction threads share the GIL) well under the 2 s stall;
    # with shards twice the size it can come near the stall, which then
    # ends before a duplicate is launched.
    shards = PcaConfig(bases_per_partition=2_500).shards()
    late = str(shards[10])
    spec_kw = dict(pca_mode="sparse", bases_per_partition=2_500,
                   ingest_workers=4, **base)
    results = {}
    for name, speculate in (("plain", False), ("speculative", True)):
        plan = faults.FaultPlan.from_dict({"seed": 1, "rules": [dict(
            site="ingest.shard", kind="stall", times=1, stall_s=2.0,
            match=late)]})
        err_out = io.StringIO()
        t0 = time.perf_counter()
        with faults.active_plan(plan), contextlib.redirect_stderr(err_out):
            driver, result, g, launches, _, _ = drive_file(
                torch, JsonlSource(root), f"sparse, {name}, shard {late} "
                "stalled 2 s", speculative_ingest=speculate, **spec_kw)
        wall = time.perf_counter() - t0
        results[name] = (result, g)
        line = (f"Speculating straggler shard {late} (duplicate attempt "
                "launched).")
        seen = line in err_out.getvalue()
        numbers[f"{name}_wall_s"] = wall
        numbers[f"{name}_ingest_s"] = driver.timer.seconds["ingest+gramian"]
        print(f"    {name}: wall-clock {wall:.3f} s, ingest+gramian "
              f"{driver.timer.seconds['ingest+gramian']:.3f} s, "
              f"{len(shards)} shards, speculated "
              f"{driver._speculated_shards}, the line seen: {seen}")
        check(plan.fired_total == 1, f"{name}: the stall did not fire")
        check(launches == phase4_launches,
              f"{name}: {launches} launches, phase 4 {phase4_launches}")
        by_leg[f"sparse, {name}, stalled shard (phase 17d)"] = launches
        check(seen == speculate and driver._speculated_shards == speculate,
              f"{name}: speculation {'missing' if speculate else 'ran'}")
    check(same_g(results["speculative"][1], results["plain"][1])
          and same_g(results["plain"][1], g_ref),
          "speculation changed G")
    coords = {k: np.array([[a, b] for _, a, b in r])
              for k, (r, _) in results.items()}
    check(np.array_equal(coords["plain"], coords["speculative"]),
          "speculation changed the coordinates")
    print(f"    G and coordinates bit-identical with and without "
          f"speculation (SPECULATION_MIN_COMPLETED = "
          f"{concurrency.SPECULATION_MIN_COMPLETED})")

    print("  (e) builder threads, native and numpy (tools/ingest_workers.py,"
          " one rep)", flush=True)
    table = builder_thread_table(root, reps=1)
    numbers["builders"] = {
        f"{'native' if n else 'python'}_x{t}": [
            round(row["s"], 6), round(row["ms_per_block"], 4)]
        for (n, t), row in table.items()}
    print("  phase 17 numbers: " + json.dumps(numbers))
    return by_leg


def host_windows(source, conf, indexes):
    """The driver's CSR windows, rebuilt on the host from the same source."""
    from spark_examples_tpu_torch.arrays.blocks import windows_from_calls

    calls = []
    for shard in conf.shards():
        calls.extend(source.stream_carrying(
            conf.variant_set_ids[0], shard, indexes
        ))
    return list(windows_from_calls(calls, conf.block_variants))


T_START = time.perf_counter()


# -- phase 18: delta and gang serving ----------------------------------------

# The phase's sample sets: A is removed by the removal-only delta and added
# back by the rank-8 one, which drops B instead; each gang cohort holds 256
# samples.
DELTA_K, GANG_N, GANG_B = 8, 256, 4
LEASE_TTL_S, LEASE_HEARTBEAT_S = 1.0, 0.2


def http_json(url, method="GET", doc=None):
    """One bearer-token request to a phase-18 server: (status, JSON body
    or the text of a non-JSON body)."""
    import http.client
    from urllib.parse import urlparse

    u = urlparse(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=300)
    try:
        body = None if doc is None else json.dumps(doc).encode()
        headers = {"Authorization": f"Bearer {NET_TOKEN}"}
        if body is not None:
            headers["Content-Type"] = "application/json"
        conn.request(method, u.path + (f"?{u.query}" if u.query else ""),
                     body=body, headers=headers)
        resp = conn.getresponse()
        raw = resp.read()
        try:
            return resp.status, json.loads(raw)
        except ValueError:
            return resp.status, raw.decode("utf-8", "replace")
    finally:
        conn.close()


def run_job(url, spec, want_state="done", timeout_s=300.0):
    """POST /analyze, then poll GET /jobs/<id> until ``want_state``:
    returns (submit status, the job record, submit-to-state seconds)."""
    t0 = time.perf_counter()
    status, rec = http_json(url + "/analyze", "POST", spec)
    check(status in (200, 202), f"POST /analyze {spec}: {status} {rec}")
    deadline = time.monotonic() + timeout_s
    while rec.get("state") != want_state:
        check(rec.get("state") != "failed",
              f"job {rec.get('id')} failed: {rec.get('error')}")
        check(time.monotonic() < deadline,
              f"job {rec.get('id')} did not reach {want_state}")
        time.sleep(0.005)
        status, rec = http_json(f"{url}/jobs/{rec['id']}")
        check(status == 200, f"GET /jobs/{rec}: {status}")
    return status, rec, time.perf_counter() - t0


def prom_value(text, sample):
    """The value of one exposition sample line (0.0 when absent)."""
    for line in text.splitlines():
        if line.startswith(sample + " "):
            return float(line.split()[-1])
    return 0.0


def rows_of(rec):
    return [tuple(r) for r in rec["result"]]


def rows_err(got, want):
    """Max |Δ| of two row lists' coordinates; the names must agree."""
    check([r[0] for r in got] == [r[0] for r in want],
          "job rows name other samples than the reference's")
    a = np.array([[r[1], r[2]] for r in got], np.float64)
    b = np.array([[r[1], r[2]] for r in want], np.float64)
    check(np.isfinite(a).all(), "job coordinates must be finite")
    return float(np.abs(a - b).max())


def job_idle(torch, fn):
    """Run ``fn`` under ``torch.profiler`` inside one host range: the
    device's idle share of that range (None when the profile holds no CUDA
    event), the range's seconds and ``fn``'s result."""
    from torch.autograd import DeviceType
    from torch.profiler import record_function

    with all_threads_profile(torch) as prof:
        with record_function("chip_smoke.job"):
            out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    events = prof.events()
    host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    device = [(e.time_range.start, e.time_range.end) for e in events
              if e.device_type == DeviceType.CUDA
              and e.name not in host_names]
    ranges = [(e.time_range.start, e.time_range.end) for e in events
              if e.name == "chip_smoke.job"
              and e.device_type == DeviceType.CPU]
    lo, hi = ranges[0]
    idle = (1 - merged_busy_us(device, lo, hi) / (hi - lo)) if device else None
    return idle, (hi - lo) / 1e6, out


def delta_and_gang_serving(torch, root, g_ref, phase4_launches, reads_dir,
                           device="cuda"):
    """Phase 18: ``serve-cohort --analyze`` over phase 12's directory on the
    card — the cold, cached, delta, gang, sketch and pairhmm jobs, a
    crash and replay, and replica failover. Returns the scatter launches
    of each path that launches the kernel. ``device`` is the servers' and
    engines' ``--device`` (``cpu`` only to try the phase at a small size
    without a card)."""
    import contextlib as ctx

    from spark_examples_tpu_torch.cli.main import _analysis_tier, build_parser
    from spark_examples_tpu_torch.genomics.fixtures import FIXTURE_READSET_ID
    from spark_examples_tpu_torch.genomics.service import (
        GenomicsServiceServer,
    )
    from spark_examples_tpu_torch.genomics.sources import JsonlSource
    from spark_examples_tpu_torch.models.pairhmm import PairHmmDriver
    from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
    from spark_examples_tpu_torch.obs.session import TelemetrySession
    from spark_examples_tpu_torch.ops import scatter_kernel as sk
    from spark_examples_tpu_torch.ops.pcoa import (
        mllib_principal_components_reference,
    )
    from spark_examples_tpu_torch.resilience import faults
    from spark_examples_tpu_torch.serving import (
        AnalysisEngine,
        JobSpec,
        gramian_base_key,
        job_config,
    )
    from spark_examples_tpu_torch.store import FencedWriteError

    work = tempfile.mkdtemp(prefix="chip_smoke_serving_")
    atexit.register(shutil.rmtree, work, True)
    by_leg, times, idle = {}, {}, {}
    fallbacks = []
    source = JsonlSource(root)
    source.ensure_serving_index()

    def args_for(*extra, input_path=root):
        return build_parser().parse_args(
            ["serve-cohort", "--input-path", input_path, "--analyze",
             "--token", NET_TOKEN, "--port", "0", "--device", device,
             *extra])

    def serve(tier, src):
        server = GenomicsServiceServer(src, port=0, token=NET_TOKEN,
                                       job_tier=tier).start()
        return server, f"http://127.0.0.1:{server.port}"

    def metrics(url):
        status, text = http_json(url + "/metrics")
        check(status == 200, f"/metrics answered {status}")
        fallbacks.append(prom_value(
            text, 'serving_delta_jobs_total{outcome="fallback"}'))
        return text

    stack = ctx.ExitStack()
    atexit.register(stack.close)
    # The CLI keeps one telemetry session open for the server's life.
    stack.enter_context(TelemetrySession(command="serve-cohort"))
    journal = os.path.join(work, "journal")
    tier = _analysis_tier(args_for("--analyze-journal-dir", journal), source)
    stack.callback(tier.close)
    server, url = serve(tier, source)
    stack.callback(server.stop)
    engine = tier._engine
    print(f"  serve-cohort --analyze set up by the CLI's _analysis_tier on "
          f"{url}: engine device {engine.device}, deltas <= "
          f"{engine._deltas.max_delta_samples} samples, gangs <= "
          f"{tier._gang_max} samples", flush=True)
    base = tier._base
    ids = list(VariantsPcaDriver(job_config(JobSpec(), base), source)
               .index.indexes)
    n = len(ids)
    check(n == g_ref.shape[0], f"phase 12's directory holds {n} samples")
    rng = np.random.default_rng(18)
    perm = rng.permutation(n)
    set_a = sorted(perm[:DELTA_K].tolist())
    set_b = sorted(perm[DELTA_K:2 * DELTA_K].tolist())
    key = gramian_base_key(job_config(JobSpec(), base))

    def cached_g(keep, eng=None):
        """The delta index's G for the cohort ``keep`` (full indices), in
        ``eng``'s index (the journaled tier's engine by default)."""
        frame = tuple(ids[i] for i in keep)
        entry = (eng or engine)._deltas.resolve(key, frame)
        check(entry is not None and entry.samples == frame,
              "the delta index holds no G for a finished cohort")
        check(entry.verify(), "a cached G fails its checksum")
        return entry.g

    def check_sub_g(g, keep, what):
        ok = same_g(g, g_ref[np.ix_(keep, keep)])
        check(ok, f"{what}: G is not phase 4's (sub)matrix bit for bit")
        return ok

    # (a) cold: under the journal the job checkpoints (the dense-block
    # route, no scatter launch); without one it takes the window route.
    sk.SCATTER_KERNEL_LAUNCHES = 0
    _, cold, times["cold_http_s"] = run_job(url, {})
    launches = sk.SCATTER_KERNEL_LAUNCHES
    d = VariantsPcaDriver(job_config(JobSpec(), base), source)
    with contextlib.redirect_stdout(io.StringIO()):
        ref_rows = d.collect_result(d.compute_pca(d.ingest_gramian()))
    err = rows_err(rows_of(cold), ref_rows)
    check(err <= COORD_TOL, f"cold job rows {err:.3e} from the driver's")
    full = list(range(n))
    check_sub_g(cached_g(full), full, "cold job")
    print(f"  (a) cold {{}} job under the journal (checkpointed, "
          f"--checkpoint-every {base.checkpoint_every}): "
          f"{times['cold_http_s']:.3f} s POST to done; {launches} scatter "
          f"launches; rows vs the port driver's run on the directory: max "
          f"abs diff {err:.3e} (bit-identical: {rows_of(cold) == ref_rows});"
          f" G phase 4's bit for bit", flush=True)
    check(launches == 0, f"the checkpointed cold job launched the scatter "
          f"kernel {launches} times")
    plain_tier = _analysis_tier(args_for(), source)
    stack.callback(plain_tier.close)
    plain_server, plain_url = serve(plain_tier, source)
    stack.callback(plain_server.stop)
    sk.SCATTER_KERNEL_LAUNCHES = 0
    _, cold_w, times["cold_no_journal_http_s"] = run_job(plain_url, {})
    launches = sk.SCATTER_KERNEL_LAUNCHES
    by_leg["serve-cohort --analyze cold job, no journal (phase 18a)"] = (
        launches)
    check_sub_g(cached_g(full, plain_tier._engine), full,
                "the journal-less cold job")
    err_w = rows_err(rows_of(cold_w), rows_of(cold))
    check(err_w <= COORD_TOL, f"the two cold jobs' rows {err_w:.3e} apart")
    check(plain_tier._engine._deltas.windows(key) is not None
          and engine._deltas.windows(key) is None,
          "only the window route captures the windows")
    print(f"  (a) cold {{}} job on a tier without a journal (the window "
          f"route): {times['cold_no_journal_http_s']:.3f} s POST to done; "
          f"{launches} scatter launches (phase 4: {phase4_launches}); rows "
          f"{err_w:.3e} from the checkpointed job's (bit-identical: "
          f"{rows_of(cold_w) == rows_of(cold)}); G phase 4's bit for bit; its "
          f"windows captured, the checkpointed job's not", flush=True)
    check(launches == phase4_launches,
          f"the journal-less cold job launched the scatter kernel "
          f"{launches} times")

    # (b) cached ------------------------------------------------------------
    sk.SCATTER_KERNEL_LAUNCHES = 0
    status, hit, times["cached_http_s"] = run_job(url, {"tenant": "other"})
    launches = sk.SCATTER_KERNEL_LAUNCHES
    check(status == 200 and hit["cached"] and rows_of(hit) == rows_of(cold),
          "the resubmitted job must be a cached 200 with the same rows")
    check(launches == 0, f"the cached job launched {launches} times")
    print(f"  (b) resubmitted: cached 200 in {times['cached_http_s']:.4f} s, "
          f"rows identical, 0 launches")

    # (c) delta, removal only -----------------------------------------------
    hits0 = prom_value(metrics(url), 'serving_delta_jobs_total{outcome="hit"}')
    spec_a = {"exclude_samples": [ids[i] for i in set_a]}
    sk.SCATTER_KERNEL_LAUNCHES = 0
    _, rec_a, times["delta_removal_http_s"] = run_job(url, spec_a)
    launches = sk.SCATTER_KERNEL_LAUNCHES
    text = metrics(url)
    hits1 = prom_value(text, 'serving_delta_jobs_total{outcome="hit"}')
    keep_a = [i for i in full if i not in set_a]
    check_sub_g(cached_g(keep_a), keep_a, "removal-only delta")
    check(hits1 == hits0 + 1, f"delta hits {hits0} -> {hits1}")
    check(launches == 0, f"the delta job launched {launches} times")
    print(f"  (c) exclude {DELTA_K} samples: {times['delta_removal_http_s']:.3f}"
          f" s; serving_delta_jobs_total{{outcome=\"hit\"}} {hits0:.0f} -> "
          f"{hits1:.0f}; G phase 4's submatrix bit for bit; 0 launches")

    # (d) delta, additions: over HTTP, then on an in-process engine whose
    # only ancestor is (c)'s cohort, and through both correction routes.
    spec_b = {"exclude_samples": [ids[i] for i in set_b]}
    keep_b = [i for i in full if i not in set_b]
    sk.SCATTER_KERNEL_LAUNCHES = 0
    _, rec_b, times["delta_http_s"] = run_job(url, spec_b)
    check(sk.SCATTER_KERNEL_LAUNCHES == 0, "the (d) job launched the kernel")
    check_sub_g(cached_g(keep_b), keep_b, "(d) delta over HTTP")
    windows = engine._deltas.windows(key)
    conf_a = job_config(JobSpec.from_record(spec_a), base)
    conf_b = job_config(JobSpec.from_record(spec_b), base)
    g_a = g_ref[np.ix_(keep_a, keep_a)].astype(np.float32)
    frame_a = tuple(ids[i] for i in keep_a)
    routes = {}
    for name, threshold in (("int8 product", 0.0), ("±1 scatter", 2.0)):
        drv = VariantsPcaDriver(conf_b, source)
        t0 = time.perf_counter()
        g = drv.ingest_gramian_delta(g_a, frame_a, windows=windows,
                                     density_threshold=threshold)
        routes[name] = time.perf_counter() - t0
        check_sub_g(g, keep_b, f"rank-{DELTA_K} delta by the {name}")
    def rank_engine():
        """An engine whose delta index holds only (c)'s cohort."""
        eng = AnalysisEngine(source, delta_max_samples=16, device=device)
        eng._deltas.put(key, frame_a, g_a)
        if windows is not None:
            eng._deltas.put_windows(key, windows)
        check(eng.delta_resolvable(conf_b),
              "(c)'s cohort must be a rank-8 ancestor of (d)'s")
        return eng

    sk.SCATTER_KERNEL_LAUNCHES = 0
    eng = rank_engine()
    with contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        rows_d = eng.run(conf_b)
        times["delta_rank8_s"] = time.perf_counter() - t0
        profiled = rank_engine()
        idle["delta_rank8"], times["delta_rank8_profiled_s"], again = (
            job_idle(torch, lambda: profiled.run(conf_b)))
    check(again == rows_d, "the profiled rank-8 job's rows differ")
    check(sk.SCATTER_KERNEL_LAUNCHES == 0, "the rank-8 job launched")
    g_d = eng._deltas.resolve(key, tuple(ids[i] for i in keep_b)).g
    check_sub_g(g_d, keep_b, f"rank-{DELTA_K} delta job")
    err = rows_err(rows_d, rows_of(rec_b))
    check(err <= COORD_TOL, f"rank-8 rows {err:.3e} from the HTTP job's")
    t0 = time.perf_counter()
    want_b, _ = mllib_principal_components_reference(
        g_ref[np.ix_(keep_b, keep_b)], 2)
    oracle_s = time.perf_counter() - t0
    names = [d.cohort.names[ids[i]] for i in keep_b]
    by_name = {r[0]: (r[1], r[2]) for r in rows_d}
    got_b = np.array([by_name[nm] for nm in names])
    oracle_err = float(np.abs(got_b - want_b).max())
    check(oracle_err <= COORD_TOL,
          f"rank-8 coordinates {oracle_err:.3e} from the f64 oracle")
    print(f"  (d) add the {DELTA_K} back, drop {DELTA_K} others: over HTTP "
          f"{times['delta_http_s']:.3f} s (ancestor: the nearest, the full "
          f"cohort); an engine holding only (c)'s G serves it as a rank-"
          f"{DELTA_K} correction in {times['delta_rank8_s']:.3f} s "
          f"({times['delta_rank8_profiled_s']:.3f} s profiled), "
          f"G phase 4's submatrix bit for bit, rows {err:.3e} from the HTTP "
          f"job's, coordinates {oracle_err:.3e} from the f64 oracle "
          f"({oracle_s:.1f} s); the correction alone by the int8 product "
          f"{routes['int8 product']:.4f} s and by the ±1 scatter "
          f"{routes['±1 scatter']:.4f} s, both bit-identical; window cache "
          f"{'hit' if windows is not None else 'empty (re-streamed)'}",
          flush=True)

    # (e) gang ----------------------------------------------------------------
    gang_sets = [sorted(perm[2 * DELTA_K + GANG_N * b:
                             2 * DELTA_K + GANG_N * (b + 1)].tolist())
                 for b in range(GANG_B)]
    gang_specs = [{"samples": [ids[i] for i in s]} for s in gang_sets]
    text = metrics(url)
    count0 = prom_value(text, "serving_gang_size_count")
    sum0 = prom_value(text, "serving_gang_size_sum")
    sk.SCATTER_KERNEL_LAUNCHES = 0
    # Hold the worker: it takes a job and waits for the device lock the
    # script holds, while the four cohorts queue behind it.
    with engine._device_lock:
        status, blocker = http_json(url + "/analyze", "POST", {"num_pc": 3})
        check(status == 202, f"the blocker job answered {status}")
        deadline = time.monotonic() + 60
        while http_json(f"{url}/jobs/{blocker['id']}")[1]["state"] != (
                "running"):
            check(time.monotonic() < deadline, "the worker never started")
            time.sleep(0.005)
        gang_ids = []
        for spec in gang_specs:
            status, rec = http_json(url + "/analyze", "POST", spec)
            check(status == 202, f"a gang cohort answered {status}")
            gang_ids.append(rec["id"])
        t0 = time.perf_counter()
    recs = []
    for job_id in gang_ids:
        deadline = time.monotonic() + 300
        while True:
            _, rec = http_json(f"{url}/jobs/{job_id}")
            check(rec["state"] != "failed", f"gang job failed: {rec}")
            if rec["state"] == "done":
                break
            check(time.monotonic() < deadline, "a gang job never finished")
            time.sleep(0.005)
        recs.append(rec)
    times["gang_http_s"] = time.perf_counter() - t0
    check(sk.SCATTER_KERNEL_LAUNCHES == 0, "the gang launched the kernel")
    text = metrics(url)
    count1 = prom_value(text, "serving_gang_size_count")
    sum1 = prom_value(text, "serving_gang_size_sum")
    check(count1 - count0 == 1 and sum1 - sum0 == GANG_B,
          f"gang counters: {count1 - count0:.0f} dispatches of "
          f"{sum1 - sum0:.0f} jobs, want 1 of {GANG_B}")
    for s in gang_sets:
        check_sub_g(cached_g(s), s, "gang member")
    serial_engine = AnalysisEngine(source, device=device)
    gang_confs = [job_config(JobSpec.from_record(s), base)
                  for s in gang_specs]
    with contextlib.redirect_stdout(io.StringIO()):
        serial_engine.run(gang_confs[0])  # warm
        t0 = time.perf_counter()
        serial_rows = [serial_engine.run(c) for c in gang_confs]
        times["gang_serial_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        gang_rows = serial_engine.run_gang(gang_confs)
        times["gang_s"] = time.perf_counter() - t0
    check(gang_rows == serial_rows, "gang rows differ from serial rows")
    for rec, rows in zip(recs, serial_rows):
        err = rows_err(rows_of(rec), rows)
        check(err <= COORD_TOL, f"a gang job's rows {err:.3e} from serial")
    print(f"  (e) {GANG_B} cohorts of {GANG_N} queued behind a held worker: "
          f"one gang dispatch of {sum1 - sum0:.0f} (serving_gang_size), "
          f"{times['gang_http_s']:.3f} s from release to the last done; "
          f"every G phase 4's submatrix bit for bit, 0 launches; in-process "
          f"run_gang {times['gang_s']:.3f} s against {GANG_B} serial runs "
          f"{times['gang_serial_s']:.3f} s, rows bit-identical", flush=True)

    # (f) sketch ----------------------------------------------------------------
    before = http_json(url + "/statusz")[1]["tier"]["delta_cache"]
    sk.SCATTER_KERNEL_LAUNCHES = 0
    _, sketch, times["sketch_http_s"] = run_job(url, {"pca_mode": "sketch"})
    after = http_json(url + "/statusz")[1]["tier"]["delta_cache"]
    check(after == before, f"a sketch job changed the delta index: "
          f"{before} -> {after}")
    check(len(sketch["result"]) == n, "the sketch job's rows")
    print(f"  (f) {{\"pca_mode\": \"sketch\"}}: {times['sketch_http_s']:.3f} s, "
          f"{sk.SCATTER_KERNEL_LAUNCHES} launches, delta index unchanged "
          f"({after['entries']} entries)")

    # (g) pairhmm ---------------------------------------------------------------
    reads = JsonlSource(reads_dir)
    reads_tier = _analysis_tier(args_for(
        "--references", PHMM_REFS, "--bases-per-partition", str(READS_BASES),
        input_path=reads_dir), reads)
    stack.callback(reads_tier.close)
    reads_server, reads_url = serve(reads_tier, reads)
    stack.callback(reads_server.stop)
    spec = {"kind": "pairhmm", "read_group_set_id": FIXTURE_READSET_ID}
    _, phmm, times["pairhmm_http_s"] = run_job(reads_url, spec)
    want_rows = PairHmmDriver(
        job_config(JobSpec.from_record(spec), reads_tier._base), reads
    ).run_rows()
    check(rows_of(phmm) == [tuple(r) for r in want_rows],
          "the pairhmm job's rows differ from PairHmmDriver.run_rows")
    print(f"  (g) pairhmm job over phase 16's reads directory: "
          f"{len(want_rows)} rows in {times['pairhmm_http_s']:.3f} s, equal "
          f"to PairHmmDriver.run_rows")
    metrics(url)

    # profiled cold job on a fresh engine -------------------------------------
    fresh = AnalysisEngine(source, delta_max_samples=16, device=device)
    sk.SCATTER_KERNEL_LAUNCHES = 0
    with contextlib.redirect_stdout(io.StringIO()):
        idle["cold"], times["cold_profiled_s"], _ = job_idle(
            torch, lambda: fresh.run(job_config(JobSpec(), base)))
    check(sk.SCATTER_KERNEL_LAUNCHES == phase4_launches,
          "the profiled cold job's launches")

    # (h) crash and replay through the CLI in subprocesses ----------------------
    token_file = os.path.join(work, "token.json")
    with open(token_file, "w") as f:
        json.dump({"token": NET_TOKEN}, f)
    env = dict(os.environ, GENOMICS_APPLICATION_CREDENTIALS=token_file)
    crash_journal = os.path.join(work, "crash-journal")
    plan = {"rules": [{"site": "serving.job.kill", "after": 1, "times": 1}]}
    t0 = time.perf_counter()
    proc, urls = serve_cli(root, env, "--analyze", "--analyze-journal-dir",
                           crash_journal, "--device", device,
                           "--fault-plan", json.dumps(plan))
    try:
        _, first, _ = run_job(urls["http"], {})
        _, killed, _ = run_job(urls["http"], spec_a, want_state="running")
        time.sleep(0.5)
        check(http_json(f"{urls['http']}/jobs/{killed['id']}")[1]["state"]
              == "running", "the killed job must stay running")
    finally:
        proc.kill()
        proc.wait()
    seen = []
    proc, urls = serve_cli(root, env, "--analyze", "--analyze-journal-dir",
                           crash_journal, "--device", device, seen=seen)
    try:
        replay_lines = [ln for ln in seen if "journal replayed" in ln
                        or "Delta cache re-loaded" in ln]
        check(any("Delta cache re-loaded: 1" in ln for ln in seen),
              "the restart did not re-load the persisted delta G")
        check(any("Analysis journal replayed: 2 job(s), 1 done" in ln
                  for ln in seen), "the restart did not replay the journal")
        status, rec = http_json(f"{urls['http']}/jobs/{first['id']}")
        check(status == 200 and rows_of(rec) == rows_of(cold),
              "the replayed done job's rows are not the cold job's")
        deadline = time.monotonic() + 300
        while True:
            status, rec = http_json(f"{urls['http']}/jobs/{killed['id']}")
            check(status == 200 and rec["state"] != "failed",
                  f"the replayed job: {status} {rec}")
            if rec["state"] == "done":
                break
            check(time.monotonic() < deadline, "the replayed job never ran")
            time.sleep(0.01)
        err = rows_err(rows_of(rec), rows_of(rec_a))
        check(err <= COORD_TOL, f"replayed rows {err:.3e} from (c)'s")
        text = metrics(urls["http"])
        replay_hits = prom_value(
            text, 'serving_delta_jobs_total{outcome="hit"}')
        check(replay_hits == 1, "the replayed job must be a delta hit on "
              "the re-loaded G")
    finally:
        proc.kill()
        proc.wait()
    times["crash_replay_s"] = time.perf_counter() - t0
    print(f"  (h) serving.job.kill on the second job, the server killed and "
          f"restarted on the same journal: {' | '.join(replay_lines)}; the "
          f"replayed job a delta hit on the re-loaded G, rows {err:.3e} from "
          f"(c)'s (bit-identical: {rows_of(rec) == rows_of(rec_a)}); "
          f"{times['crash_replay_s']:.1f} s with two server starts",
          flush=True)

    # (i) replicas --------------------------------------------------------------
    store = os.path.join(work, "store")
    replica = ("--store-dir", store, "--replica-lease-ttl", str(LEASE_TTL_S),
               "--replica-heartbeat", str(LEASE_HEARTBEAT_S))
    tier_a = _analysis_tier(args_for(*replica, "--replica-id", "r-a"), source)
    stack.callback(tier_a.close)
    tier_b = _analysis_tier(args_for(*replica, "--replica-id", "r-b"), source)
    stack.callback(tier_b.close)
    kill = faults.FaultPlan.from_spec(json.dumps(
        {"rules": [{"site": "serving.job.kill", "kind": "error",
                    "times": 1}]}))
    # A full-cohort job (as the blocker of (e)): cold on the survivor, whose
    # delta index is empty; the replicated tier checkpoints it under the
    # store (the dense-block route), so it launches no scatter kernel.
    spec_i = JobSpec(num_pc=3)
    sk.SCATTER_KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    with faults.active_plan(kill):
        job, _ = tier_a.submit(spec_i)
        deadline = time.monotonic() + 60
        while kill.fired_total < 1:
            check(time.monotonic() < deadline, "replica a never ran the job")
            time.sleep(0.005)
    tier_a._replica.pause()
    deadline = time.monotonic() + 120
    while True:
        adopted = tier_b.job(job.id)
        if adopted is not None and adopted.state == "done":
            break
        check(adopted is None or adopted.state != "failed",
              f"the adopted job failed: {adopted and adopted.error}")
        check(time.monotonic() < deadline, "replica b never finished it")
        time.sleep(0.01)
    times["failover_s"] = time.perf_counter() - t0
    failover_launches = sk.SCATTER_KERNEL_LAUNCHES
    check(failover_launches == 0,
          f"the survivor's checkpointed cold job launched "
          f"{failover_launches} times")
    status, blocker = http_json(f"{url}/jobs/{blocker['id']}")
    err = rows_err(adopted.result, rows_of(blocker))
    check(err <= COORD_TOL,
          f"the adopted job's rows {err:.3e} from the (e) blocker's")
    tier_a._replica.resume()
    deadline = time.monotonic() + 30
    while tier_a._replica.state() != "lost":
        check(time.monotonic() < deadline, "replica a never saw its loss")
        time.sleep(0.01)
    try:
        tier_a.submit(JobSpec(num_pc=4))
        fail("the zombie replica's write was accepted")
    except FencedWriteError as e:
        fenced = str(e)
    print(f"  (i) two tiers over one --store-dir (lease {LEASE_TTL_S:g} s): "
          f"replica a's job killed, replica b adopted it and finished in "
          f"{times['failover_s']:.3f} s from the submission "
          f"({failover_launches} scatter launches, a checkpointed cold "
          f"run), rows "
          f"{err:.3e} from the same cohort's in (e); the "
          f"zombie's write refused: FencedWriteError({fenced[:60]!r}...)")

    metrics(url)
    stack.close()
    check(max(fallbacks) == 0, "a phase-18 job recorded a delta fallback")
    print(f"  no job recorded serving_delta_jobs_total{{outcome=\"fallback\"}}")
    print("  phase 18 wall-clock, s: " + json.dumps(
        {k: round(v, 6) for k, v in times.items()}))
    print("  phase 18 device idle share: " + json.dumps(
        {k: (None if v is None else round(v, 6)) for k, v in idle.items()}))
    print(f"  phase 18 card (nvidia-smi name, power.limit): "
          f"{nvidia_smi_line()}")
    return by_leg


# -- phase 19: checkpointed ingest, soft cancel, the bridge, --trace-dir ----

# 9 shards of BRCA1's 81 kb at 10,000 bases a shard, 3 groups of 3.
CKPT_BASES, CKPT_EVERY, CKPT_SHARDS = 10_000, 3, 9
SNAP = "gramian_snapshot.npz"
# Soft cancel of a CLI run: its deadline is this many seconds after its
# launch, and the first shard of group 2 stalls as long, so the deadline
# passes while group 2 runs whenever group 1 is done before it. The run
# starts with phase 18 and sleeps beside it, so the wide margin costs the
# script little.
CANCEL_AFTER_S = 60.0
# The stage ranges and the CSR tier's ingest ranges a --trace-dir run of
# the default command over a directory must hold.
TRACE_RANGES = frozenset({
    "ingest+gramian", "pca", "emit", "ingest.stream", "ingest.fetch",
    "ingest.build", "ingest.put", "gramian.accumulate"})


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def snapshot_done(directory) -> int:
    """``shards_done`` of the snapshot in ``directory``."""
    with np.load(os.path.join(directory, SNAP)) as z:
        return int(z["shards_done"])


def start_soft_cancel(root, device="cuda", after_s=CANCEL_AFTER_S):
    """Start phase 19 (c)'s CLI run: ``pca --checkpoint-dir`` over phase
    12's directory with the port's soft deadline ``after_s`` seconds after
    its launch and the first shard of group 2 stalled as long. A thread
    notes when each snapshot appears and when the process ends; phase 19
    reads them. Returns the run's state as a dict."""
    from spark_examples_tpu_torch.utils import softcancel
    from spark_examples_tpu_torch.utils.config import PcaConfig

    work = tempfile.mkdtemp(prefix="chip_smoke_cancel_")
    atexit.register(shutil.rmtree, work, True)
    shards = PcaConfig(bases_per_partition=CKPT_BASES).shards()
    env = {k: v for k, v in os.environ.items()
           if k != softcancel.SOFT_DEADLINE_ENV}
    stall = {"rules": [{"site": "ingest.shard", "kind": "stall",
                        "stall_s": after_s, "match": str(shards[3])}]}
    t0 = time.time()
    env[softcancel.SOFT_DEADLINE_ENV] = str(t0 + after_s)
    proc = subprocess.Popen(
        [sys.executable, "-m", "spark_examples_tpu_torch.cli.main", "pca",
         "--input-path", root, "--bases-per-partition", str(CKPT_BASES),
         "--checkpoint-dir", work, "--checkpoint-every", str(CKPT_EVERY),
         "--fault-plan", json.dumps(stall), "--device", device],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    atexit.register(proc.kill)
    run = {"proc": proc, "t0": t0, "after_s": after_s, "dir": work,
           "snapshots": {}, "end": None}

    def watch():
        path = os.path.join(work, SNAP)
        while proc.poll() is None:
            if os.path.exists(path):
                done = snapshot_done(work)
                run["snapshots"].setdefault(done, time.time() - t0)
            time.sleep(0.05)
        run["end"] = time.time() - t0

    run["watcher"] = threading.Thread(target=watch, daemon=True)
    run["watcher"].start()
    print(f"  phase 19 (c)'s soft-cancelled CLI run started beside phase 18 "
          f"(deadline launch + {after_s:g} s)", flush=True)
    return run


def bridge_bytes(calls, n, k, batch_size=4096):
    """The bytes a bridge client sends for ``calls``: the newline-JSON
    lines, and the gRPC messages (before the channel's compression)."""
    from spark_examples_tpu_torch.bridge import iter_call_batches

    batches = [json.dumps(b) for b in iter_call_batches(calls, batch_size)]
    tcp = sum(len(json.dumps({"cmd": "calls", "batch": json.loads(b)})) + 1
              for b in batches)
    tcp += len(json.dumps({"cmd": "init", "n_samples": n, "num_pc": k})) + 1
    tcp += len(json.dumps({"cmd": "finish"})) + 1
    grpc = sum(len(b) for b in batches) + len(
        json.dumps({"n_samples": n, "num_pc": k}))
    return tcp, grpc


def checkpointed_ingest(torch, root, g_ref, want, windows, phase4_launches,
                        cancel, device="cuda"):
    """Phase 19: checkpointed ingest, soft cancel, the job tier's
    mid-ingest resume, the PcaBackend bridge and ``--trace-dir`` over phase
    12's directory. The subprocesses run beside the in-process legs: the
    soft-cancelled CLI run (``cancel``, from :func:`start_soft_cancel`)
    since phase 18, the bridge and the first job server from the phase's
    start. Returns the scatter launches of each path that launches the
    kernel. ``device`` is every run's ``--device`` (``cpu`` only to try
    the phase at a small size without a card)."""
    from spark_examples_tpu_torch.bridge import PcaBridgeClient
    from spark_examples_tpu_torch.cli import main as cli
    from spark_examples_tpu_torch.genomics.auth import Credentials
    from spark_examples_tpu_torch.genomics.fixtures import (
        DEFAULT_VARIANT_SET_ID,
    )
    from spark_examples_tpu_torch.genomics.grpc_transport import (
        GrpcVariantSource,
        grpc_available,
    )
    from spark_examples_tpu_torch.genomics.sources import JsonlSource
    from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
    from spark_examples_tpu_torch.ops import scatter_kernel as sk
    from spark_examples_tpu_torch.resilience import faults
    from spark_examples_tpu_torch.serving import JobSpec, job_config
    from spark_examples_tpu_torch.utils import checkpoint, softcancel
    from spark_examples_tpu_torch.utils.config import (
        PcaConfig,
        pca_config_from_args,
    )

    work = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    atexit.register(shutil.rmtree, work, True)
    here = os.path.dirname(os.path.abspath(__file__))
    n = g_ref.shape[0]
    vsid = DEFAULT_VARIANT_SET_ID
    base = dict(variant_set_ids=[vsid], device=device)
    ckpt_kw = dict(pca_mode="auto", bases_per_partition=CKPT_BASES,
                   checkpoint_every=CKPT_EVERY)
    times, by_leg, numbers = {}, {}, {}
    shards = PcaConfig(bases_per_partition=CKPT_BASES).shards()
    check(len(shards) == CKPT_SHARDS, f"{len(shards)} shards, want 9")
    env = {k: v for k, v in os.environ.items()
           if k != softcancel.SOFT_DEADLINE_ENV}
    os.environ.pop(softcancel.SOFT_DEADLINE_ENV, None)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def run(name, **kw):
        """One ``VariantsPcaDriver.run()`` on a fresh source, stdout
        captured: (driver, result, G on the host, launches, stdout, the
        source's shard count)."""
        src = JsonlSource(root)
        conf = PcaConfig(**base, **kw)
        sk.SCATTER_KERNEL_LAUNCHES = 0
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            driver = VariantsPcaDriver(conf, src)
            result = driver.run()
        launches = sk.SCATTER_KERNEL_LAUNCHES
        stage_s = {k: round(v, 6) for k, v in driver.timer.seconds.items()}
        print(f"  {name}: stage seconds {json.dumps(stage_s)}; scatter "
              f"launches {launches}; shards read {src.stats.partitions}",
              flush=True)
        return (driver, result, driver.g.cpu().numpy(), launches,
                out.getvalue(), src.stats.partitions)

    def coords_err(result):
        coords = np.array([[pc1, pc2] for _, pc1, pc2 in result])
        check(np.isfinite(coords).all(), "coordinates must be finite")
        return float(np.abs(coords - want).max())

    def cli_proc(*args):
        proc = subprocess.Popen(
            [sys.executable, "-m", "spark_examples_tpu_torch.cli.main",
             *args, "--device", device],
            cwd=here, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        atexit.register(proc.kill)
        return proc

    # The bridge and (d)'s first job server start now, beside (a) to (c).
    bridge_port = free_port()
    bridge = cli_proc("pca-bridge", "--port", str(bridge_port))
    journal = os.path.join(work, "journal")
    serve_args = ("--analyze", "--analyze-journal-dir", journal, "--device",
                  device, "--bases-per-partition", str(CKPT_BASES),
                  "--checkpoint-every", str(CKPT_EVERY))
    hold = {"rules": [{"site": "ingest.shard", "kind": "stall",
                       "stall_s": 300, "after": CKPT_EVERY}]}
    t_jobs = time.perf_counter()
    first_server = spawn_serve_cli(root, env, *serve_args, "--fault-plan",
                                   json.dumps(hold))

    # (a) a checkpointed auto run between two uncheckpointed ones ----------
    snaps = []
    real_save = checkpoint.save_snapshot

    def timed_save(directory, g, shards_done, digest):
        """The driver's snapshot, its device-to-host copy and its write
        timed apart."""
        sync()
        t0 = time.perf_counter()
        host = g.cpu().numpy() if isinstance(g, torch.Tensor) else g
        t1 = time.perf_counter()
        real_save(directory, host, shards_done, digest)
        snaps.append({"shards_done": shards_done, "copy_s": t1 - t0,
                      "write_s": time.perf_counter() - t1,
                      "bytes": os.path.getsize(os.path.join(directory, SNAP)),
                      "g": host})

    checkpoint.save_snapshot = timed_save
    try:
        ingest = {"plain": [], "checkpointed": []}
        for ckpt in (False, True, False):
            kw = dict(ckpt_kw)
            if ckpt:
                kw["checkpoint_dir"] = os.path.join(work, "ck-a")
            driver, result, g, launches, _, read = run(
                "auto, checkpointed" if ckpt else "auto, uncheckpointed",
                **kw)
            err = coords_err(result)
            check(same_g(g, g_ref), f"(a) G is not phase 4's")
            check(err <= COORD_TOL, f"(a) coordinates {err:.3e} off")
            check(launches == 0, "(a) auto launched the scatter kernel")
            check(read == CKPT_SHARDS, f"(a) read {read} shards")
            stage = driver.timer.seconds["ingest+gramian"]
            ingest["checkpointed" if ckpt else "plain"].append(stage)
    finally:
        checkpoint.save_snapshot = real_save
    check([x["shards_done"] for x in snaps] == [3, 6, 9],
          f"(a) snapshots at {[x['shards_done'] for x in snaps]}")
    # The JAX package's write of the same snapshots (np.savez_compressed),
    # off the driver's path: what the deflate would cost here.
    for x in snaps:
        path = os.path.join(work, f"deflated-{x['shards_done']}.npz")
        t0 = time.perf_counter()
        np.savez_compressed(path, g=x.pop("g"),
                            shards_done=np.int64(x["shards_done"]),
                            run_digest=np.bytes_(b"chip_smoke"))
        x["deflated_write_s"] = time.perf_counter() - t0
        x["deflated_bytes"] = os.path.getsize(path)
    snap_s = [x["copy_s"] + x["write_s"] for x in snaps]
    share = sum(snap_s) / ingest["checkpointed"][0]
    numbers["snapshots"] = snaps
    numbers["snapshot_share_of_ingest_gramian"] = share
    numbers["ingest_gramian_s"] = ingest

    def secs(key):
        return ", ".join(f"{x[key]:.4f}" for x in snaps)

    print(f"  (a) --checkpoint-every {CKPT_EVERY} over {CKPT_SHARDS} shards: "
          f"G phase 4's bit for bit, coordinates {err:.3e} from the f64 "
          f"oracle, 0 launches; a snapshot of the {n} x {n} float32 G: "
          f"device-to-host copy {secs('copy_s')} s, stored np.savez "
          f"{secs('write_s')} s of {snaps[0]['bytes']} bytes; together "
          f"{share:.4f} of the checkpointed ingest+gramian "
          f"({ingest['checkpointed'][0]:.3f} s; uncheckpointed before and "
          f"after: {', '.join(f'{x:.3f}' for x in ingest['plain'])} s); "
          f"the JAX package's np.savez_compressed of the same G, off the "
          f"path: {secs('deflated_write_s')} s, "
          f"{', '.join(str(x['deflated_bytes']) for x in snaps)} bytes",
          flush=True)

    # (b) killed in group 2, resumed by a fresh driver ----------------------
    ck_b = os.path.join(work, "ck-b")
    conf_b = dict(ckpt_kw, checkpoint_dir=ck_b, shard_retries=1)
    plan = faults.FaultPlan(rules=[faults.FaultRule(
        site="ingest.shard", kind="error", match=str(shards[4]))])
    try:
        with faults.active_plan(plan), contextlib.redirect_stdout(
                io.StringIO()):
            VariantsPcaDriver(PcaConfig(**base, **conf_b),
                              JsonlSource(root)).ingest_gramian()
        fail("(b) the ingest.shard fault did not raise")
    except IOError as e:
        raised = f"{type(e).__name__}: {e}"
    check(plan.fired_total == 1, "(b) the fault fired once")
    done = snapshot_done(ck_b)
    check(done == 3, f"(b) the snapshot holds {done} shards, want 3")
    t0 = time.perf_counter()
    driver, result, g, _, out, read = run("(b) resumed", **conf_b)
    times["resume_s"] = time.perf_counter() - t0
    check("Resuming from snapshot: 3/9 shards done." in out,
          "(b) the resume line is missing")
    check(read == 6, f"(b) the resume read {read} shards, want 6")
    check(same_g(g, g_ref), "(b) the resumed G is not phase 4's")
    check(coords_err(result) <= COORD_TOL, "(b) coordinates off")
    print(f"  (b) ingest.shard error on shard 4 ({shards[4]}) with "
          f"--shard-retries 1: raised {raised[:70]!r} after the snapshot of "
          f"{done} shards; a fresh driver printed \"Resuming from snapshot: "
          f"3/9 shards done.\", read {read} shards, G phase 4's bit for "
          f"bit ({times['resume_s']:.3f} s)", flush=True)

    # (c) sparse under a future and a past deadline ------------------------
    try:
        os.environ[softcancel.SOFT_DEADLINE_ENV] = str(time.time() + 3600)
        _, _, g, launches, _, _ = run("sparse, a deadline an hour ahead",
                                      pca_mode="sparse")
        by_leg["sparse under a future soft deadline (phase 19c)"] = launches
        check(launches == phase4_launches,
              f"(c) sparse launched {launches}, phase 4 {phase4_launches}")
        check(same_g(g, g_ref), "(c) sparse G is not phase 4's")
        os.environ[softcancel.SOFT_DEADLINE_ENV] = str(time.time() - 1)
        sk.SCATTER_KERNEL_LAUNCHES = 0
        err_out = io.StringIO()
        try:
            with contextlib.redirect_stdout(io.StringIO()), \
                    contextlib.redirect_stderr(err_out):
                VariantsPcaDriver(PcaConfig(**base, pca_mode="sparse"),
                                  JsonlSource(root)).run()
            fail("(c) a past deadline did not cancel the sparse run")
        except softcancel.SoftCancel as e:
            code, where = e.code, e.where
        past_launches = sk.SCATTER_KERNEL_LAUNCHES
    finally:
        os.environ.pop(softcancel.SOFT_DEADLINE_ENV, None)
    check(code == 75 and where == "sparse gramian window boundary",
          f"(c) exit {code} at {where}")
    check(past_launches == 0, f"(c) {past_launches} launches past the "
          "deadline")
    print(f"  (c) sparse with a deadline an hour ahead: {launches} scatter "
          f"launches, G phase 4's bit for bit; with a past deadline: "
          f"SoftCancel({code}) at the {where}, {past_launches} launches; "
          f"stderr: {err_out.getvalue().strip()[:90]!r}", flush=True)

    # (f) --trace-dir ------------------------------------------------------
    trace_dir = os.path.join(work, "trace")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(["pca", "--input-path", root, "--trace-dir",
                       trace_dir, "--device", device])
    times["trace_run_s"] = time.perf_counter() - t0
    check(rc == 0, f"(f) pca --trace-dir exited {rc}")
    traces = [f for f in os.listdir(trace_dir)
              if f.endswith(".pt.trace.json")]
    check(len(traces) == 1, f"(f) traces written: {traces}")
    path = os.path.join(trace_dir, traces[0])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    missing = TRACE_RANGES - {e.get("name") for e in events}
    check(not missing, f"(f) the trace lacks the ranges {sorted(missing)}")
    check(kernels > 0 or device == "cpu", "(f) no CUDA kernel event")
    numbers["trace_bytes"] = os.path.getsize(path)
    numbers["trace_kernel_events"] = kernels
    print(f"  (f) pca --trace-dir: {numbers['trace_bytes']} bytes of "
          f"{len(events)} events, {kernels} CUDA kernel events; the "
          f"ranges {', '.join(sorted(TRACE_RANGES))} present; the run took "
          f"{times['trace_run_s']:.3f} s", flush=True)

    # (d) the job tier's resume after a SIGKILL ----------------------------
    proc, urls = await_listening(first_server)
    try:
        _, job, _ = run_job(urls["http"], {}, want_state="running")
        snap = os.path.join(journal, "ckpt", job["id"], SNAP)
        deadline = time.monotonic() + 300
        while not os.path.exists(snap):
            check(time.monotonic() < deadline, "(d) no job snapshot")
            time.sleep(0.01)
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait()
    killed_at = snapshot_done(os.path.dirname(snap))
    with_grpc = grpc_available()
    seen = []
    grpc_args = ("--grpc-port", "0") if with_grpc else ()
    proc, urls = serve_cli(root, env, *serve_args, *grpc_args, seen=seen)

    # (e) the bridge and ComputePca (on the restarted job server), fed
    # phase 4's carrier lists, while the resumed job runs -----------------
    calls = []
    for idx, lens in windows:
        calls.extend(np.split(np.asarray(idx), np.cumsum(lens)[:-1]))
    calls = [c.tolist() for c in calls]
    tcp_bytes, grpc_bytes = bridge_bytes(calls, n, 2)
    for line in bridge.stdout:
        print(f"  pca-bridge | {line.rstrip()}", flush=True)
        if "PcaBackend bridge listening" in line:
            break
    else:
        fail(f"(e) pca-bridge exited {bridge.wait()}: "
             f"{bridge.stderr.read()[-1500:]}")
    client = PcaBridgeClient(port=bridge_port)
    try:
        t0 = time.perf_counter()
        coords, _ = client.compute(calls, n, 2)
        times["bridge_call_s"] = time.perf_counter() - t0
    finally:
        client.close()
        bridge.kill()
        bridge.wait()
    err = float(np.abs(coords - want).max())
    check(coords.shape == (n, 2) and err <= COORD_TOL,
          f"(e) bridge coordinates {err:.3e} from the f64 oracle")
    numbers["bridge_bytes"] = tcp_bytes
    print(f"  (e) pca-bridge (a subprocess): {len(calls)} carrier lists, "
          f"{tcp_bytes} bytes sent, {times['bridge_call_s']:.3f} s for the "
          f"call; coordinates {err:.3e} from the f64 oracle", flush=True)
    if with_grpc:
        src = GrpcVariantSource(urls["grpc"],
                                credentials=Credentials(NET_TOKEN, "chip"))
        try:
            t0 = time.perf_counter()
            coords, _ = src.compute_pca(calls, n, 2)
            times["compute_pca_call_s"] = time.perf_counter() - t0
        finally:
            src.close()
        err = float(np.abs(coords - want).max())
        check(coords.shape == (n, 2) and err <= COORD_TOL,
              f"(e) ComputePca coordinates {err:.3e} from the f64 oracle")
        numbers["compute_pca_bytes"] = grpc_bytes
        print(f"  (e) ComputePca over serve-cohort --grpc-port (the "
              f"restarted job server of (d)): {grpc_bytes} bytes of "
              f"messages before compression, "
              f"{times['compute_pca_call_s']:.3f} s for the call; "
              f"coordinates {err:.3e} from the f64 oracle", flush=True)
    else:
        print("  (e) ComputePca: not run, grpcio is not installed on this "
              "host")

    # (d), continued: the resumed job ends and its checkpoint goes ---------
    try:
        deadline = time.monotonic() + 300
        while True:
            status, rec = http_json(f"{urls['http']}/jobs/{job['id']}")
            check(status == 200 and rec["state"] != "failed",
                  f"(d) the resumed job: {status} {rec}")
            if rec["state"] == "done":
                break
            check(time.monotonic() < deadline, "(d) the job never resumed")
            time.sleep(0.01)
        times["job_kill_resume_s"] = time.perf_counter() - t_jobs
        # The worker reclaims the checkpoint dir just after the job is done.
        while os.path.exists(os.path.dirname(snap)):
            check(time.monotonic() < deadline,
                  "(d) the done job's checkpoint dir was not reclaimed")
            time.sleep(0.01)
    finally:
        proc.kill()
        rest = proc.stdout.read()
        proc.wait()
    lines = seen + rest.splitlines()
    resume = [ln for ln in lines if "Resuming from snapshot" in ln]
    check(resume == [f"Resuming from snapshot: {killed_at}/9 shards done."],
          f"(d) resume lines {resume}")
    server_base = pca_config_from_args(
        cli.build_parser().parse_args(["serve-cohort", *serve_args]))
    server_base.variant_set_ids = [vsid]  # as the CLI's _analysis_tier
    d = VariantsPcaDriver(job_config(JobSpec(), server_base),
                          JsonlSource(root))
    with contextlib.redirect_stdout(io.StringIO()):
        ref_rows = d.collect_result(d.compute_pca(d.ingest_gramian()))
    err = rows_err(rows_of(rec), ref_rows)
    check(err <= COORD_TOL, f"(d) the resumed job's rows {err:.3e} off")
    print(f"  (d) serve-cohort --analyze --analyze-journal-dir, SIGKILLed "
          f"once ckpt/<id>/{SNAP} held {killed_at} shards (group 2 held by "
          f"a stall), restarted on the journal: {resume[0]!r}, so "
          f"{CKPT_SHARDS - killed_at} shards ingested after the restart; "
          f"rows {err:.3e} from the driver's (bit-identical: "
          f"{rows_of(rec) == ref_rows}); the checkpoint dir reclaimed; "
          f"{times['job_kill_resume_s']:.1f} s from the first server's "
          f"launch to the resumed job's end", flush=True)

    # (c), continued: the soft-cancelled CLI run, and its resume -----------
    proc, after_s = cancel["proc"], cancel["after_s"]
    try:
        _, cancel_err = proc.communicate(
            timeout=max(1.0, 300 - (time.time() - cancel["t0"])))
    except subprocess.TimeoutExpired:
        fail("(c) the CLI run never ended")
    cancel["watcher"].join(timeout=30)
    times["cancel_run_s"] = cancel["end"]
    check(proc.returncode == softcancel.SOFT_CANCEL_EXIT,
          f"(c) the CLI exited {proc.returncode}: {cancel_err[-1500:]}")
    cancel_line = [ln for ln in cancel_err.splitlines()
                   if "Soft-cancel" in ln]
    check(cancel_line and "checkpoint group boundary" in cancel_line[0],
          "(c) the soft-cancel line is missing")
    done = snapshot_done(cancel["dir"])
    seen_at = cancel["snapshots"]
    check(done == 6, f"(c) the deadline passed while group "
          f"{done // CKPT_EVERY + 1} ran (the snapshot holds {done} shards, "
          f"want 6; snapshots seen at {seen_at} s after the launch)")
    check(CKPT_EVERY in seen_at, "(c) the snapshot of group 1 went unseen")
    margin = after_s - seen_at[CKPT_EVERY]
    numbers["cancel_margin_s"] = margin
    _, result, g, _, out, read = run(
        "(c) rerun without the deadline", checkpoint_dir=cancel["dir"],
        **ckpt_kw)
    check("Resuming from snapshot: 6/9 shards done." in out and read == 3,
          f"(c) the rerun read {read} shards")
    check(same_g(g, g_ref), "(c) the resumed G is not phase 4's")
    print(f"  (c) CLI pca --checkpoint-dir, started with phase 18, with "
          f"{softcancel.SOFT_DEADLINE_ENV} = launch + {after_s:g} s and "
          f"shard 3 stalled {after_s:g} s: group 1's snapshot seen "
          f"{seen_at[CKPT_EVERY]:.1f} s after the launch ({margin:.1f} s "
          f"before the deadline); exit {proc.returncode} after "
          f"{times['cancel_run_s']:.1f} s ({cancel_line[0]!r}), the "
          f"snapshot holds {done} shards; the rerun resumed, read {read} "
          f"shards, G phase 4's bit for bit", flush=True)

    print("  phase 19 wall-clock, s: " + json.dumps(times))
    print("  phase 19 numbers: " + json.dumps(numbers))
    print(f"  phase 19 card (nvidia-smi name, power.limit): "
          f"{nvidia_smi_line()}")
    return by_leg


def mesh_and_process_group(torch, root, g_ref, want, windows, device="cuda"):
    """Phase 20: the mesh layer's single-controller half and the process
    group over phase 12's directory. The CLI run under a one-rank process
    group starts first and runs beside the in-process legs. Returns the
    scatter launches of each meshed run. ``device`` is every run's device
    (``cpu`` only to try the phase at a small size without a card: the
    group is then gloo's and no kernel launches)."""
    from spark_examples_tpu_torch.bridge import TorchPcaBackend
    from spark_examples_tpu_torch.genomics.fixtures import (
        DEFAULT_VARIANT_SET_ID,
    )
    from spark_examples_tpu_torch.genomics.sources import JsonlSource
    from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
    from spark_examples_tpu_torch.ops import scatter_kernel as sk
    from spark_examples_tpu_torch.ops.sparse import (
        _pad_rows_for_scan,
        padded_carrier_matrix,
        window_route,
    )
    from spark_examples_tpu_torch.parallel import (
        ShardedGramian,
        make_mesh,
        sharded_pcoa,
    )
    from spark_examples_tpu_torch.ops.centering import double_center
    from spark_examples_tpu_torch.parallel.sharded import (
        CenteredGramian,
        _tile_operands,
        topk_eig_randomized,
    )
    from spark_examples_tpu_torch.serving import AnalysisEngine
    from spark_examples_tpu_torch.utils.config import PcaConfig
    from spark_examples_tpu_torch.utils.tracing import StageTimer

    here = os.path.dirname(os.path.abspath(__file__))
    n = g_ref.shape[0]
    vsid = DEFAULT_VARIANT_SET_ID
    on_card = device == "cuda"
    times, by_leg = {}, {}
    routes = [window_route(lens, n, PcaConfig.sparse_density_threshold)
              for _, lens in windows]
    n_scatter = routes.count("scatter")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # (e) starts first: the CLI under a one-rank process group ------------
    group_script = (
        "import sys\n"
        "import torch.distributed as dist\n"
        "from spark_examples_tpu_torch.cli import main as cli\n"
        "rc = cli.main(sys.argv[1:])\n"
        "up = dist.is_initialized()\n"
        "print('GROUP', up and dist.get_backend(), "
        "up and dist.get_world_size(), flush=True)\n"
        "if up:\n"
        "    dist.destroy_process_group()\n"
        "sys.exit(rc)\n"
    )
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port()), "WORLD_SIZE": "1", "RANK": "0",
           "LOCAL_RANK": "0"}
    t_group = time.perf_counter()
    group = subprocess.Popen(
        [sys.executable, "-c", group_script, "pca", "--input-path", root,
         "--mesh-shape", "data:1", "--pca-mode", "stream",
         "--no-sample-sharded", "--device", device],
        cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    atexit.register(group.kill)

    # (a) one-card meshes through the driver -------------------------------
    source = JsonlSource(root)
    legs = [(spec, mode, sharded)
            for spec in ("data:1", "data:1,model:1")
            for mode, sharded in (("sparse", True), ("auto", True),
                                  ("stream", False))]
    stream_tsv = stream_coords = stream_g = None
    for spec, mode, sharded in legs:
        flag = "--sample-sharded" if sharded else "--no-sample-sharded"
        name = f"--mesh-shape {spec} --pca-mode {mode} {flag}"
        conf = PcaConfig(variant_set_ids=[vsid], pca_mode=mode,
                         sample_sharded=sharded, device=device)
        mesh = make_mesh(spec, device=device)
        out = io.StringIO()
        sk.SCATTER_KERNEL_LAUNCHES = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            driver = VariantsPcaDriver(conf, source, mesh=mesh)
            result = driver.run()
        run_s = time.perf_counter() - t0
        launches = sk.SCATTER_KERNEL_LAUNCHES
        check(isinstance(driver.g, ShardedGramian),
              f"(a) {name}: G is not a tile grid")
        g = driver.g.full().cpu().numpy()
        check(same_g(g, g_ref), f"(a) {name}: G is not phase 4's")
        coords = np.array([[p1, p2] for _, p1, p2 in result])
        err = float(np.abs(coords - want).max())
        check(np.isfinite(coords).all() and err <= COORD_TOL,
              f"(a) {name}: coordinates {err:.3e} from the f64 oracle")
        sparse = driver._sparse_selected()
        check(sparse == (mode != "stream"),
              f"(a) {name}: routed {'sparse' if sparse else 'dense'}")
        want_launches = n_scatter if sparse and on_card else 0
        check(launches == want_launches,
              f"(a) {name}: {launches} scatter launches, want "
              f"{want_launches}")
        tsv = [ln for ln in out.getvalue().splitlines()
               if ln.count("\t") == 3]
        check(len(tsv) == n, f"(a) {name}: {len(tsv)} result lines")
        by_leg[f"mesh {spec} {mode} (phase 20a)"] = launches
        times[f"{spec} {mode}"] = run_s
        print(f"  (a) {name}: {'sparse' if sparse else 'dense'} route, "
              f"tiles {driver.g.tiles.shape}, {launches} scatter launches, "
              f"G phase 4's bit for bit, coordinates {err:.3e} from the f64 "
              f"oracle, run() {run_s:.3f} s, stage seconds "
              f"{json.dumps({k: round(v, 6) for k, v in driver.timer.seconds.items()})}",
              flush=True)
        if spec == "data:1" and mode == "stream":
            stream_tsv, stream_coords, stream_g = tsv, coords, driver.g

    # (b) the tile path on the card ----------------------------------------
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=device)
    w0 = routes.index("scatter")
    idx0, lens0 = windows[w0]
    tile_path = {}
    for label, (rows, cols) in (("2x2", (2, 2)), ("1x3", (1, 3))):
        n_padded = -(-n // (rows * cols)) * rows * cols
        t_r, t_c = n_padded // rows, n_padded // cols
        idx = torch.from_numpy(padded_carrier_matrix(
            idx0, lens0, sentinel=n_padded,
            n_rows=_pad_rows_for_scan(lens0.size))).to(device)
        full = torch.zeros((n_padded, n_padded), device=device)
        sk.scatter_pairs_chunked(full, idx, idx)
        kernel_ms = plain_ms = bound_ms = 0.0
        total_pairs = 0
        for i in range(rows):
            for j in range(cols):
                r0, c0 = i * t_r, j * t_c
                li, lj = _tile_operands(idx, r0, t_r, c0, t_c)
                tile_k = torch.zeros((t_r, t_c), device=device)
                tile_p = torch.zeros_like(tile_k)
                sk.scatter_pairs(tile_k, li, lj)
                sk.scatter_pairs_chunked(tile_p, li, lj)
                check(torch.equal(tile_k, tile_p),
                      f"(b) {label} tile ({i}, {j}): kernel != plain")
                check(torch.equal(tile_k, full[r0:r0 + t_r, c0:c0 + t_c]),
                      f"(b) {label} tile ({i}, {j}): not the full G's block")
                pairs = valid_pairs(torch, li, lj, t_r, t_c).numel()
                moved = 2 * li.numel() * 4 + 2 * t_r * t_c * 4
                bound = max(moved / PEAK_BYTES_PER_S,
                            pairs / PEAK_F32_PER_S) * 1e3
                if on_card:
                    scratch = torch.zeros_like(tile_k)
                    ms = time_cuda(
                        lambda: sk.scatter_pairs(scratch, li, lj), 20, flush)
                    p_ms = time_cuda(
                        lambda: sk.scatter_pairs_chunked(scratch, li, lj), 3,
                        flush)
                else:
                    ms = p_ms = float("nan")
                kernel_ms += ms
                plain_ms += p_ms
                bound_ms += bound
                total_pairs += pairs
                print(f"  (b) {label} tile ({i}, {j}) of {t_r}x{t_c} at "
                      f"({r0}, {c0}): {pairs} pairs, {moved} bytes; kernel "
                      f"{ms:.4f} ms, plain {p_ms:.4f} ms, bound "
                      f"{bound:.4f} ms; equal to its plain version and to "
                      f"the full G's block", flush=True)
        check(total_pairs == valid_pairs(torch, idx, idx, n, n).numel(),
              f"(b) {label}: the tiles do not partition the window's pairs")
        tile_path[label] = {"tiles": rows * cols, "ms": kernel_ms,
                            "plain_ms": plain_ms, "bound_ms": bound_ms,
                            "pairs": total_pairs}
        print(f"  (b) {label} grid, window {w0} (V_pad={idx.shape[0]}, "
              f"K={idx.shape[1]}): {rows * cols} launches, kernel "
              f"{kernel_ms:.4f} ms in all against a {bound_ms:.4f} ms bound "
              f"(share {bound_ms / kernel_ms:.3f}), plain {plain_ms:.4f} ms",
              flush=True)

    # (c) the randomized eig on the tile grid -------------------------------
    # sharded_pcoa runs it at the JAX package's cap of 30 iterations; this
    # cohort's spectrum is flat past λ2 (the ratios printed below), so the
    # last leg runs the same iteration with a cap of 100, held to the bar.
    mesh1 = stream_g.mesh
    lam = torch.linalg.eigvalsh(
        double_center(stream_g.full()).double()).abs()
    lam = lam.sort(descending=True).values.cpu().numpy()
    print(f"  (c) the centered G's spectrum: |λ3/λ2| = {lam[2] / lam[1]:.4f}, "
          f"|λ11/λ2| = {lam[10] / lam[1]:.4f} (the panel holds k + 8 = 10 "
          f"vectors, so an iteration shrinks the error by about the "
          f"latter)", flush=True)
    eig_legs = (
        ("sharded_pcoa, fixed", lambda timer: sharded_pcoa(
            stream_g, 2, mesh1, dense_eigh_limit=n - 1, timer=timer)[0]),
        ("sharded_pcoa, eig_tol=1e-6", lambda timer: sharded_pcoa(
            stream_g, 2, mesh1, dense_eigh_limit=n - 1, timer=timer,
            eig_tol=1e-6)[0]),
        ("topk_eig_randomized, iters=100, tol=1e-6", lambda timer:
            topk_eig_randomized(CenteredGramian(stream_g), 2, iters=100,
                                tol=1e-6, timer=timer)[0].cpu().numpy()),
    )
    for label, run_eig in eig_legs:
        timer = StageTimer()
        sync()
        t0 = time.perf_counter()
        coords = run_eig(timer)
        sync()
        secs = time.perf_counter() - t0
        notes = [x for xs in timer.notes.values() for x in xs
                 if "randomized eig" in x]
        used = notes[0].split(": ")[1] if notes else "30/30 iterations"
        err = float(np.abs(coords - stream_coords).max())
        oracle = float(np.abs(coords - want).max())
        check(coords.shape == (n, 2) and np.isfinite(coords).all(),
              f"(c) {label}: coordinates not finite")
        if "iters=100" in label:
            check(err <= COORD_TOL,
                  f"(c) {label}: {err:.3e} from dense eigh")
        times[f"randomized eig, {label}"] = secs
        print(f"  (c) {label} (N = {n} above the dense limit): {used}, "
              f"{secs:.3f} s; coordinates {err:.3e} from dense eigh, "
              f"{oracle:.3e} from the f64 oracle", flush=True)

    # (d) a meshed engine job and a meshed bridge call ----------------------
    conf = PcaConfig(variant_set_ids=[vsid], device=device)
    rows_by = {}
    for label, mesh in (("data:1 mesh", mesh1), ("meshless", None)):
        engine = AnalysisEngine(source, mesh=mesh, device=device)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rows_by[label] = engine.run(conf)
        times[f"engine job, {label}"] = time.perf_counter() - t0
    err = rows_err(rows_by["data:1 mesh"], rows_by["meshless"])
    check(err <= COORD_TOL, f"(d) the meshed job's rows {err:.3e} off")
    print(f"  (d) a cold AnalysisEngine job on a data:1 mesh "
          f"({times['engine job, data:1 mesh']:.3f} s) against a meshless "
          f"one ({times['engine job, meshless']:.3f} s): rows {err:.3e} "
          f"apart", flush=True)
    calls = []
    for idx, lens in windows:
        calls.extend(np.split(np.asarray(idx), np.cumsum(lens)[:-1]))
    calls = [c.tolist() for c in calls]
    coords_by = {}
    for label, mesh in (("data:1 mesh", mesh1), ("meshless", None)):
        t0 = time.perf_counter()
        coords_by[label], _ = TorchPcaBackend(
            mesh=mesh, device=device).compute(calls, n, 2)
        times[f"bridge call, {label}"] = time.perf_counter() - t0
    err = float(np.abs(coords_by["data:1 mesh"]
                       - coords_by["meshless"]).max())
    oracle = float(np.abs(coords_by["data:1 mesh"] - want).max())
    check(err <= COORD_TOL and oracle <= COORD_TOL,
          f"(d) the meshed bridge call: {err:.3e} from the meshless one, "
          f"{oracle:.3e} from the oracle")
    print(f"  (d) TorchPcaBackend(mesh=data:1).compute over phase 4's "
          f"{len(calls)} carrier lists "
          f"({times['bridge call, data:1 mesh']:.3f} s; meshless "
          f"{times['bridge call, meshless']:.3f} s): {err:.3e} from the "
          f"meshless call, {oracle:.3e} from the f64 oracle", flush=True)

    # (e), continued: the one-rank process group's CLI run ends ------------
    try:
        out, err_text = group.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        fail("(e) the CLI under a process group never ended")
    times["group CLI run"] = time.perf_counter() - t_group
    check(group.returncode == 0,
          f"(e) the CLI exited {group.returncode}: {err_text[-2000:]}")
    backend = "nccl" if on_card else "gloo"
    check(f"GROUP {backend} 1" in out,
          f"(e) the process group was not up: {out.splitlines()[-1:]}")
    tsv = [ln for ln in out.splitlines() if ln.count("\t") == 3]
    check([ln.split("\t")[:2] for ln in tsv]
          == [ln.split("\t")[:2] for ln in stream_tsv],
          "(e) the group run's rows name other samples")
    got = np.array([[float(x) for x in ln.split("\t")[2:]] for ln in tsv])
    ref = np.array([[float(x) for x in ln.split("\t")[2:]]
                    for ln in stream_tsv])
    err = float(np.abs(got - ref).max())
    check(err <= COORD_TOL, f"(e) the group run's rows {err:.3e} off")
    print(f"  (e) CLI pca --mesh-shape data:1 under a one-rank {backend} "
          f"group (MASTER_ADDR=127.0.0.1, WORLD_SIZE=1): initialize_from_env "
          f"joined it, {len(tsv)} rows, {err:.3e} from (a)'s data:1 stream "
          f"rows (byte-identical: {tsv == stream_tsv}), "
          f"{times['group CLI run']:.1f} s from its launch", flush=True)

    print("  phase 20 wall-clock, s: " + json.dumps(times))
    print("  phase 20 tile path: " + json.dumps(tile_path))
    print(f"  phase 20 card (nvidia-smi name, power.limit): "
          f"{nvidia_smi_line()}")
    return by_leg, tile_path


# -- phase 21: the pod regime's per-rank work on the card --------------------


def pod_tile_paths(torch, g_ref, windows, device="cuda"):
    """Phase 21: what each rank of a pod does on its card, in process on
    one card (NCCL takes one rank a card, so no pod runs here): (a) the
    scatter kernel's mirrored tile path — phase 4's first scatter window
    re-based onto a 2x2 grid with the mirror masks, each masked tile equal
    to its plain version, the four masked launches timed against the four
    unmasked ones of phase 20b in turns, then every window of phase 4
    through the mirrored tile path (scatter windows launch the kernel once
    a tile, dense windows take the pod dense tile step) and the mirror
    fill: G phase 4's bit for bit; (b) the pod dense tile step: phase 4's
    windows packed, each packed block cut into four "rank" column slices
    concatenated as the all-gather concatenates them, a 2x2 grid's tiles
    through the slab products with the mirror on and off, G phase 4's.
    Returns the scatter launches by leg and the timings. ``device``
    ``cpu`` tries the phase without a card (the plain version runs and
    nothing launches)."""
    from spark_examples_tpu_torch.arrays.blocks import packed_block_from_csr
    from spark_examples_tpu_torch.ops import scatter_kernel as sk
    from spark_examples_tpu_torch.ops.gramian import pack_indicator_block
    from spark_examples_tpu_torch.ops.sparse import (
        _pad_rows_for_scan,
        padded_carrier_matrix,
        window_route,
    )
    from spark_examples_tpu_torch.parallel import ShardedGramian, make_mesh
    from spark_examples_tpu_torch.parallel.sharded import (
        _mirror_fill,
        _mirror_operands,
        _tile_dense_pod,
        _tile_operands,
        _tile_scatter,
    )
    from spark_examples_tpu_torch.utils.config import PcaConfig

    t_phase = time.perf_counter()
    n = g_ref.shape[0]
    on_card = device == "cuda"
    g_f32 = torch.from_numpy(g_ref.astype(np.float32)).to(device)
    routes = [window_route(lens, n, PcaConfig.sparse_density_threshold)
              for _, lens in windows]
    n_scatter = routes.count("scatter")
    mesh = make_mesh("data:2,model:2", devices=[torch.device(device)] * 4)
    by_leg, out = {}, {}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def grid_equals_g(g, label):
        for (i, j), tile in g.local_tiles():
            r0, c0 = g.tile_origin(i, j)
            block = g_f32[r0:r0 + g.tile_rows, c0:c0 + g.tile_cols]
            check(torch.equal(tile[: block.shape[0], : block.shape[1]],
                              block),
                  f"{label}: tile ({i}, {j}) is not phase 4's G block")

    # (a) the mirrored tile path -------------------------------------------
    w0 = routes.index("scatter")
    idx0, lens0 = windows[w0]
    n_padded = -(-n // 4) * 4
    t = n_padded // 2
    half = t // 2
    idx = torch.from_numpy(padded_carrier_matrix(
        idx0, lens0, sentinel=n_padded,
        n_rows=_pad_rows_for_scan(lens0.size))).to(device)
    full = torch.zeros((n_padded, n_padded), device=device)
    sk.scatter_pairs_chunked(full, idx, idx)
    plain_ops, masked_ops, tiles = [], [], np.empty((2, 2), dtype=object)
    sk.SCATTER_KERNEL_LAUNCHES = 0
    for i in range(2):
        for j in range(2):
            li, lj = _tile_operands(idx, i * t, t, j * t, t)
            mi, mj = _mirror_operands(li, lj, i, j, t, t)
            tile_k = torch.zeros((t, t), device=device)
            tile_p = torch.zeros_like(tile_k)
            sk.scatter_pairs(tile_k, mi, mj)
            sk.scatter_pairs_chunked(tile_p, mi, mj)
            check(torch.equal(tile_k, tile_p),
                  f"(a) masked tile ({i}, {j}): kernel != plain")
            want = full[i * t:(i + 1) * t, j * t:(j + 1) * t].clone()
            if i < j:
                want[half:, :] = 0
            elif i > j:
                want[:, :half] = 0
            check(torch.equal(tile_k, want),
                  f"(a) masked tile ({i}, {j}): not the window's slab")
            tiles[i, j] = tile_k
            plain_ops.append((li, lj))
            masked_ops.append((mi, mj))
    sync()
    by_leg["mirrored 2x2 window, kernel vs plain (phase 21a)"] = (
        sk.SCATTER_KERNEL_LAUNCHES)
    window_grid = ShardedGramian(tiles, n_padded, mesh)
    _mirror_fill(window_grid)
    for (i, j), tile in window_grid.local_tiles():
        check(torch.equal(tile, full[i * t:(i + 1) * t, j * t:(j + 1) * t]),
              f"(a) filled tile ({i}, {j}): not the unmasked tile")
    pairs = {name: sum(valid_pairs(torch, a, b, t, t).numel()
                       for a, b in ops)
             for name, ops in (("unmasked", plain_ops),
                               ("masked", masked_ops))}
    moved = 4 * (2 * idx.numel() * 4 + 2 * t * t * 4)
    bound = {name: max(moved / PEAK_BYTES_PER_S,
                       p / PEAK_F32_PER_S) * 1e3
             for name, p in pairs.items()}
    if on_card:
        flush = torch.empty(128 << 20, dtype=torch.uint8, device=device)
        scratch = [torch.zeros((t, t), device=device) for _ in range(4)]

        def launches(ops):
            def run():
                for tile, (a, b) in zip(scratch, ops):
                    sk.scatter_pairs(tile, a, b)
            return run

        def plain(ops):
            def run():
                for tile, (a, b) in zip(scratch, ops):
                    sk.scatter_pairs_chunked(tile, a, b)
            return run

        turns = {"unmasked": [], "masked": []}
        for name in ("unmasked", "masked", "masked", "unmasked"):
            ops = plain_ops if name == "unmasked" else masked_ops
            turns[name].append(time_cuda(launches(ops), 20, flush))
        ms = {k: float(np.mean(v)) for k, v in turns.items()}
        plain_ms = time_cuda(plain(masked_ops), 3, flush)
    else:
        ms = {"unmasked": float("nan"), "masked": float("nan")}
        plain_ms = float("nan")
    out["window"] = {"ms": ms["masked"], "unmasked_ms": ms["unmasked"],
                     "plain_ms": plain_ms, "bound_ms": bound["masked"],
                     "unmasked_bound_ms": bound["unmasked"],
                     "pairs": pairs}
    print(f"  (a) window {w0} (V_pad={idx.shape[0]}, K={idx.shape[1]}) on a "
          f"2x2 grid of {t}x{t} tiles: 4 mirror-masked launches, each tile "
          f"equal to its plain version and to the window's slab, the fill "
          f"gives the unmasked tiles; {pairs['masked']} pairs against "
          f"{pairs['unmasked']} unmasked; masked {ms['masked']:.4f} ms, "
          f"unmasked {ms['unmasked']:.4f} ms (in turns), plain "
          f"{plain_ms:.4f} ms, bound {bound['masked']:.4f} ms",
          flush=True)

    # Every window of phase 4 through the mirrored tile path.
    g = ShardedGramian.zeros(n, mesh)
    sk.SCATTER_KERNEL_LAUNCHES = 0
    sync()
    t0 = time.perf_counter()
    for (widx, lens), route in zip(windows, routes):
        if route == "scatter":
            _tile_scatter(g, padded_carrier_matrix(
                widx, lens, sentinel=g.n_padded,
                n_rows=_pad_rows_for_scan(lens.size)), mirror=True)
        else:
            xb = packed_block_from_csr(widx, lens, n, lens.size)
            xb = np.pad(xb, ((0, g.n_padded - n), (0, 0)))
            _tile_dense_pod(g, torch.from_numpy(xb).to(device), torch.int8,
                            mirror=True)
    _mirror_fill(g)
    sync()
    out["cohort_s"] = time.perf_counter() - t0
    launches_a = sk.SCATTER_KERNEL_LAUNCHES
    want_launches = 4 * n_scatter if on_card else 0
    check(launches_a == want_launches,
          f"(a) {launches_a} scatter launches, want {want_launches}")
    by_leg["mirrored 2x2 tile path, every window (phase 21a)"] = launches_a
    grid_equals_g(g, "(a) mirrored tile path")
    print(f"  (a) phase 4's {len(windows)} windows through the mirrored tile "
          f"path on one card ({n_scatter} scatter windows, {launches_a} "
          f"launches; {len(windows) - n_scatter} dense windows through the "
          f"pod dense tile step) and the mirror fill: G phase 4's bit for "
          f"bit, {out['cohort_s']:.3f} s", flush=True)

    # (b) the pod dense tile step ------------------------------------------
    packed = [packed_block_from_csr(widx, lens, n, lens.size)
              for widx, lens in windows]
    panels = []
    for xb in packed:
        xb = np.pad(xb, ((0, n_padded - n), (0, 0)))
        # Four ranks' column slices, concatenated in rank order as the
        # all-gather concatenates them.
        gathered = np.concatenate(np.array_split(xb, 4, axis=1), axis=1)
        panels.append(torch.from_numpy(gathered).to(device))
    dense_s = {}
    for mirror in (True, False):
        gd = ShardedGramian.zeros(n, mesh)
        sync()
        t0 = time.perf_counter()
        for xp in panels:
            _tile_dense_pod(gd, xp, torch.int8, mirror=mirror)
        if mirror:
            _mirror_fill(gd)
        sync()
        dense_s["mirror" if mirror else "full"] = time.perf_counter() - t0
        grid_equals_g(gd, f"(b) dense tile step, mirror {mirror}")
    out["dense_s"] = dense_s
    print(f"  (b) the pod dense tile step over phase 4's {len(panels)} packed "
          f"blocks, each cut into four rank slices and gathered: every tile "
          f"of the 2x2 grid phase 4's G block, mirror on "
          f"{dense_s['mirror']:.3f} s (fill included), off "
          f"{dense_s['full']:.3f} s", flush=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print("  phase 21 numbers: " + json.dumps(out))
    print(f"  phase 21 card (nvidia-smi name, power.limit): "
          f"{nvidia_smi_line()}")
    return by_leg, out


# -- phase 22: the sketch on a mesh -------------------------------------------


def sketch_on_a_mesh(torch, csr, panel10, coords10, common, coords11,
                     common_windows, device="cuda"):
    """Phase 22: the sketch's mesh half on one card at the biobank width
    (phase 10's CSR ``csr``, its panel and coordinates) and at phase 11's
    flip width (its common cohort, rows and windows). Returns the scatter
    launches of each leg (0: the sketch launches no kernel) and the
    numbers printed. ``device`` ``cpu`` tries the phase at a small size
    without a card, given the same inputs of small cohorts."""
    import dataclasses
    import warnings

    from spark_examples_tpu_torch.arrays.blocks import (
        _densify_window,
        csr_windows,
    )
    from spark_examples_tpu_torch.genomics.fixtures import (
        DEFAULT_VARIANT_SET_ID,
    )
    from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
    from spark_examples_tpu_torch.ops import scatter_kernel as sk
    from spark_examples_tpu_torch.ops import sketch
    from spark_examples_tpu_torch.ops.gramian import pack_indicator_block
    from spark_examples_tpu_torch.ops.pcoa import normalize_eigvec_signs
    from spark_examples_tpu_torch.ops.sparse import (
        _carrier_bucket,
        _pad_rows_for_scan,
        padded_carrier_matrix,
    )
    from spark_examples_tpu_torch.parallel import make_mesh
    from spark_examples_tpu_torch.parallel.sharded import (
        _sketch_pod_dense_contrib,
        _sketch_pod_scatter,
        sharded_sketch_finish,
        sharded_sketch_panel,
        sketch_tsqr,
    )
    from spark_examples_tpu_torch.utils.config import PcaConfig

    t_phase = time.perf_counter()
    on_card = device == "cuda"
    n, k = panel10.n, panel10.k
    l = panel10.l
    idx, offsets = csr
    by_leg, out = {}, {}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def peak_stats():
        if not on_card:
            return 0, 0
        return torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()

    def quiet_eig(panel):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the cohort has no structure
            return sketch.sketch_eig(panel, k)

    def windows():
        return csr_windows(iter([(idx, offsets)]), SKETCH_BLOCK_V)

    # (a) the panel on a one-card data:1 mesh -------------------------------
    mesh1 = make_mesh("data:1", device=device)

    def run():
        sync()
        t0 = time.perf_counter()
        panel = sharded_sketch_panel(
            windows, n, k, mesh1, power_iters=0, seed=0,
            block_variants=SKETCH_BLOCK_V,
        )
        sync()
        t1 = time.perf_counter()
        coords, vals = quiet_eig(panel)
        sync()
        return {"total_s": time.perf_counter() - t0, "pass_s": t1 - t0,
                "finish_s": time.perf_counter() - t1, "panel": panel,
                "coords": coords}

    sk.SCATTER_KERNEL_LAUNCHES = 0
    before = dict(sketch.SKETCH_WINDOWS)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    _, held = peak_stats()
    runs = [run() for _ in range(3)]  # a warm run, then the best of 2
    peak, _ = peak_stats()
    launches = sk.SCATTER_KERNEL_LAUNCHES
    routes = {r: sketch.SKETCH_WINDOWS[r] - before[r] for r in before}
    by_leg["sketch on a data:1 mesh (phase 22a)"] = launches
    best = min(runs[1:], key=lambda r: r["total_s"])
    panel, coords = runs[0]["panel"], runs[0]["coords"]
    err = rel_frobenius(panel.y, panel10.y)
    coord_err = float(np.abs(coords - coords10).max())
    same_y = np.array_equal(panel.y, panel10.y)
    out["a"] = {"pass_s": [round(r["pass_s"], 6) for r in runs],
                "finish_s": [round(r["finish_s"], 6) for r in runs],
                "best_total_s": best["total_s"],
                "samples_per_sec": n / best["total_s"],
                "peak_bytes": peak, "held_bytes": held,
                "y_rel_err": err, "y_bit_identical": same_y,
                "coord_err": coord_err}
    print(f"  (a) sharded_sketch_panel on a data:1 mesh + sketch_eig (TSQR "
          f"of one block): pass seconds {out['a']['pass_s']}, finish "
          f"seconds {out['a']['finish_s']} (warm, then 2); best "
          f"{best['total_s']:.4f} s, {n / best['total_s']:.2f} samples/s; "
          f"windows by route {routes}; scatter launches {launches}; peak "
          f"card memory {peak} bytes ({peak / 2**20:.1f} MiB), {held} held "
          f"by earlier phases; Y vs phase 10's panel: relative Frobenius "
          f"{err:.3e} (bit-identical {same_y}); coordinates vs phase 10's "
          f"max abs {coord_err:.3e}", flush=True)
    check(launches == 0, "(a) the sketch must not launch the scatter kernel")
    check(routes == {"scatter": 3, "dense": 0},
          f"(a) each run must scatter its one window, got {routes}")
    check(panel.mesh is mesh1 and panel.y.shape == (n, l),
          "(a) the panel must carry its mesh and n_padded rows")
    check(panel.host_peak_bytes == sketch.sketch_host_bytes(n, l),
          "(a) host_peak_bytes must be the formula")
    check(err <= PANEL_RTOL, "(a) Y beyond phase 10's panel")
    check(np.array_equal(panel.row_sums, panel10.row_sums),
          "(a) row sums must equal phase 10's")
    check(coord_err <= COORD_TOL, "(a) coordinates beyond phase 10's")
    if on_card:
        check(peak < SKETCH_PEAK_BYTES, "(a) peak card memory over 2 GiB")

    # (b) the TSQR over a grid of row blocks on one card --------------------
    grid = make_mesh("data:2,model:2", devices=[torch.device(device)] * 4)
    norm = float(np.linalg.norm(panel.y))
    nu = float(np.sqrt(n) * np.finfo(np.float32).eps * norm)
    y_nu = panel.y + nu * panel.omega
    y_dev = torch.from_numpy(y_nu.astype(np.float32)).to(device)
    tsqr_s = []
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        q_blocks, r = sketch_tsqr(y_dev, grid)
        sync()
        tsqr_s.append(time.perf_counter() - t0)
    q = torch.cat(q_blocks).double()
    qr_err = float(torch.linalg.norm(q @ r.double() - y_dev.double())
                   / torch.linalg.norm(y_dev.double()))
    orth_err = float((q.T @ q - torch.eye(l, dtype=torch.float64,
                                          device=device)).abs().max())
    del q
    t0 = time.perf_counter()
    _, r_host = np.linalg.qr(y_nu)
    host_qr_s = time.perf_counter() - t0
    r_np = r.cpu().numpy().astype(np.float64)
    signs = np.sign(np.diag(r_np)) * np.sign(np.diag(r_host))
    r_err = float(np.abs(r_np * signs[:, None] - r_host).max()
                  / np.abs(r_host).max())
    finish_s = []
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        c4, vals4 = sharded_sketch_finish(
            dataclasses.replace(panel, mesh=grid), k)
        sync()
        finish_s.append(time.perf_counter() - t0)
    c4 = normalize_eigvec_signs(c4[:n, :k])
    coord_err4 = float(np.abs(c4 - coords10).max())
    out["b"] = {"tsqr_s": tsqr_s, "finish_s": finish_s,
                "host_qr_s": host_qr_s, "qr_rel_err": qr_err,
                "orth_err": orth_err, "r_rel_err": r_err,
                "coord_err": coord_err4}
    print(f"  (b) sketch_tsqr of the ({n}, {l}) shifted panel over a 2x2 grid "
          f"of row blocks on one card: {[round(x, 6) for x in tsqr_s]} s "
          f"(host float64 QR {host_qr_s:.4f} s); |Q·R − Y|/|Y| {qr_err:.3e}, "
          f"max |QᵀQ − I| {orth_err:.3e}, R vs the host R up to row signs "
          f"{r_err:.3e} (bars 1e-5); sharded_sketch_finish through it "
          f"{[round(x, 6) for x in finish_s]} s, coordinates vs phase 10's "
          f"max abs {coord_err4:.3e}", flush=True)
    check(qr_err <= 1e-5, "(b) Q·R beyond 1e-5 of the panel")
    check(orth_err <= 1e-5, "(b) QᵀQ beyond 1e-5 of I")
    check(r_err <= 1e-5, "(b) R beyond 1e-5 of the host R")
    check(coord_err4 <= COORD_TOL, "(b) TSQR coordinates beyond phase 10's")
    del y_dev, q_blocks

    # (c) auto's flip on a data:1 mesh at phase 11's width ------------------
    conf = PcaConfig(variant_set_ids=[DEFAULT_VARIANT_SET_ID],
                     pca_mode="auto", num_pc=2, sketch_power_iters=2,
                     device=device)
    sk.SCATTER_KERNEL_LAUNCHES = 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    _, held = peak_stats()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        driver = VariantsPcaDriver(conf, common,
                                   mesh=make_mesh("data:1", device=device))
        selected = driver.sketch_selected()
        result = driver.run()
    run_s = time.perf_counter() - t0
    peak, _ = peak_stats()
    launches = sk.SCATTER_KERNEL_LAUNCHES
    by_leg["auto's flip on a data:1 mesh (phase 22c)"] = launches
    coords_c = np.array([[pc1, pc2] for _, pc1, pc2 in result])
    flip_err = float(np.abs(coords_c - coords11).max())
    stage_s = {kk: round(v, 6) for kk, v in driver.timer.seconds.items()}
    out["c"] = {"run_s": run_s, "stage_s": stage_s, "peak_bytes": peak,
                "coord_err": flip_err}
    print(f"  (c) auto --sketch-power-iters 2 on a data:1 mesh, N = "
          f"{driver.cohort.size}: driver.run() "
          f"{run_s:.3f} s, stage seconds {json.dumps(stage_s)}; scatter "
          f"launches {launches}; peak card memory {peak} bytes; rows vs "
          f"phase 11's meshless run max abs {flip_err:.3e}", flush=True)
    check(selected and isinstance(driver.g, sketch.SketchPanel)
          and driver.g.mesh is not None,
          "(c) auto on a mesh past 4 GiB must return a mesh SketchPanel")
    check(launches == 0, "(c) no scatter kernel launch")
    check(flip_err <= COORD_TOL, "(c) rows beyond phase 11's")
    if on_card:
        check(peak < SKETCH_PEAK_BYTES, "(c) peak card memory over 2 GiB")

    # (d) a pod rank's card work ---------------------------------------------
    n_pad = -(-n // 2) * 2
    omega0 = sketch.gaussian_test_matrix(n, l, 0)
    om = torch.zeros((n_pad + 1, l + 1), dtype=torch.float32, device=device)
    om[:n_pad] = torch.from_numpy(sketch._augmented_omega(
        np.pad(omega0, ((0, n_pad - n), (0, 0))), n, True))
    halves = list(csr_windows(iter([(idx, offsets)]),
                              -(-(offsets.size - 1) // 2)))
    rows = _pad_rows_for_scan(max(lens.size for _, lens in halves))
    bucket = _carrier_bucket(max(int(lens.max()) for _, lens in halves))
    gathered = np.concatenate([
        padded_carrier_matrix(w, lens, sentinel=n_pad, n_rows=rows,
                              k_bucket=bucket) for w, lens in halves])
    full_lens = np.diff(offsets)
    y_pod = torch.zeros((n_pad, l + 1), device=device)
    y_one = torch.zeros_like(y_pod)
    scatter_s = {"pod": [], "one": []}
    for _ in range(3):
        y_pod.zero_()
        y_one.zero_()
        sync()
        t0 = time.perf_counter()
        _sketch_pod_scatter(y_pod, om, gathered)
        sync()
        scatter_s["pod"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        sketch._sketch_scatter_update(y_one, om, idx, full_lens)
        sync()
        scatter_s["one"].append(time.perf_counter() - t0)
    scatter_err = rel_frobenius(y_pod.cpu().numpy().astype(np.float64),
                                y_one.cpu().numpy().astype(np.float64))
    # The dense step over phase 11's common window(s), two ranks' columns.
    nc = driver.cohort.size
    nc_pad = -(-nc // 2) * 2
    l2 = driver.g.l
    om2 = torch.from_numpy(sketch._augmented_omega(np.pad(
        sketch.gaussian_test_matrix(nc, l2, 0), ((0, nc_pad - nc), (0, 0))),
        nc, True)).to(device)
    contrib = torch.zeros((nc_pad, l2 + 1), device=device)
    ref = torch.zeros_like(contrib)
    dense_s = []
    for widx, lens in common_windows:
        cut = lens.size // 2
        split = [(widx[:int(lens[:cut].sum())], lens[:cut]),
                 (widx[int(lens[:cut].sum()):], lens[cut:])]
        packed = []
        for w, ln in split:
            xb = _densify_window(w, ln, nc, ln.size)
            packed.append(torch.from_numpy(pack_indicator_block(
                np.pad(xb, ((0, nc_pad - nc), (0, 0))))).to(device))
        full = torch.from_numpy(pack_indicator_block(np.pad(
            _densify_window(widx, lens, nc, lens.size),
            ((0, nc_pad - nc), (0, 0))))).to(device)
        sync()
        t0 = time.perf_counter()
        for xp in packed:
            contrib += _sketch_pod_dense_contrib(xp, om2)
        sync()
        dense_s.append(time.perf_counter() - t0)
        sketch._sketch_dense_update(ref, om2, full)
    dense_err = rel_frobenius(contrib.cpu().numpy().astype(np.float64),
                              ref.cpu().numpy().astype(np.float64))
    out["d"] = {"scatter_s": scatter_s, "scatter_rel_err": scatter_err,
                "dense_s": dense_s, "dense_rel_err": dense_err}
    print(f"  (d) a pod rank's card work: phase 10's window as two ranks' "
          f"windows, the global carrier matrix {gathered.shape} through the "
          f"pod scatter step {[round(x, 6) for x in scatter_s['pod']]} s "
          f"(one device {[round(x, 6) for x in scatter_s['one']]} s), "
          f"relative Frobenius {scatter_err:.3e}; phase 11's "
          f"{len(common_windows)} dense window(s) as two ranks' packed "
          f"columns, contributions summed {[round(x, 6) for x in dense_s]} "
          f"s, relative Frobenius {dense_err:.3e} (bars {PANEL_RTOL})",
          flush=True)
    check(scatter_err <= PANEL_RTOL, "(d) the pod scatter step disagrees")
    check(dense_err <= PANEL_RTOL, "(d) the pod dense step disagrees")
    out["phase_s"] = time.perf_counter() - t_phase
    print("  phase 22 numbers: " + json.dumps(out))
    print(f"  phase 22 card (nvidia-smi name, power.limit): "
          f"{nvidia_smi_line()}")
    return by_leg, out


# -- phase 23: checkpoints on the card ----------------------------------------


def lane_files(directory):
    d = os.path.join(directory, "elastic")
    if not os.path.isdir(d):
        return []
    return sorted(f for f in os.listdir(d)
                  if f.startswith("lane-") and f.endswith(".npz"))


def start_checkpoint_runs(root, device="cuda"):
    """Start phase 23's subprocesses beside phase 22: (a) a CLI ``pca
    --elastic-checkpoint`` over phase 12's directory whose fourth shard
    (the first of unit 2) stalls, and (b) a CLI ``pca --checkpoint-dir``
    under a one-rank process group (NCCL on the card). Returns their
    state."""
    here = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    atexit.register(shutil.rmtree, work, True)
    stall = {"rules": [{"site": "ingest.shard", "kind": "stall",
                        "stall_s": 300, "after": CKPT_EVERY}]}
    common = ["--input-path", root, "--bases-per-partition", str(CKPT_BASES),
              "--checkpoint-every", str(CKPT_EVERY), "--device", device]
    t0 = time.perf_counter()
    elastic_run = subprocess.Popen(
        [sys.executable, "-m", "spark_examples_tpu_torch.cli.main", "pca",
         *common, "--checkpoint-dir", os.path.join(work, "elastic-run"),
         "--elastic-checkpoint", "--fault-plan", json.dumps(stall)],
        cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    atexit.register(elastic_run.kill)
    group_script = (
        "import sys\n"
        "import torch.distributed as dist\n"
        "from spark_examples_tpu_torch.cli import main as cli\n"
        "rc = cli.main(sys.argv[1:])\n"
        "up = dist.is_initialized()\n"
        "print('GROUP', up and dist.get_backend(), "
        "up and dist.get_world_size(), flush=True)\n"
        "if up:\n"
        "    dist.destroy_process_group()\n"
        "sys.exit(rc)\n"
    )
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port()), "WORLD_SIZE": "1", "RANK": "0",
           "LOCAL_RANK": "0"}
    group = subprocess.Popen(
        [sys.executable, "-c", group_script, "pca", *common,
         "--checkpoint-dir", os.path.join(work, "group-run")],
        cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    atexit.register(group.kill)
    run = {"work": work, "t0": t0, "elastic": elastic_run, "group": group,
           "lane_s": None}

    def watch():
        # When the stalled run's first lane appears.
        ck = os.path.join(work, "elastic-run")
        while elastic_run.poll() is None and run["lane_s"] is None:
            if lane_files(ck):
                run["lane_s"] = time.perf_counter() - t0
            time.sleep(0.05)

    run["watcher"] = threading.Thread(target=watch, daemon=True)
    run["watcher"].start()
    print("  phase 23's elastic CLI run and its one-rank-group checkpointed "
          "CLI run started beside phase 22", flush=True)
    return run


def checkpoints_on_the_card(torch, root, g_ref, want, runs, device="cuda"):
    """Phase 23: elastic, process-group and pod checkpoints on the card over
    phase 12's directory. ``runs`` is :func:`start_checkpoint_runs`'s.
    Returns the scatter launches of each leg (0: every checkpointed route
    is dense)."""
    from spark_examples_tpu_torch.genomics.fixtures import (
        DEFAULT_VARIANT_SET_ID,
    )
    from spark_examples_tpu_torch.genomics.sources import JsonlSource
    from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
    from spark_examples_tpu_torch.ops import scatter_kernel as sk
    from spark_examples_tpu_torch.parallel import ShardedGramian, make_mesh
    from spark_examples_tpu_torch.utils import checkpoint, elastic
    from spark_examples_tpu_torch.utils.config import PcaConfig

    t_phase = time.perf_counter()
    on_card = device == "cuda"
    work = runs["work"]
    by_leg, out = {}, {}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # (a) the elastic run, killed once its first lane appears --------------
    ck = os.path.join(work, "elastic-run")
    proc = runs["elastic"]
    deadline = time.perf_counter() + 120
    runs["watcher"].join(timeout=max(0.0, deadline - time.perf_counter()))
    check(runs["lane_s"] is not None,
          "(a) the elastic CLI run wrote no lane: "
          + (proc.stderr.read()[-2000:] if proc.poll() is not None else ""))
    check(proc.poll() is None, "(a) the elastic CLI run ended before its kill")
    proc.send_signal(signal.SIGKILL)
    proc.wait(timeout=60)
    check(proc.returncode == -signal.SIGKILL,
          f"(a) the elastic CLI run exited {proc.returncode}")
    check(len(lane_files(ck)) == 1, "(a) one lane must survive the kill")
    conf = PcaConfig(variant_set_ids=[DEFAULT_VARIANT_SET_ID],
                     bases_per_partition=CKPT_BASES,
                     checkpoint_every=CKPT_EVERY, checkpoint_dir=ck,
                     elastic_checkpoint=True, device=device)
    saves = []
    real_save = elastic.save_lane

    def timed_save(directory, g, units, digest):
        sync()
        t0 = time.perf_counter()
        host = g.cpu().numpy() if isinstance(g, torch.Tensor) else g
        t1 = time.perf_counter()
        path = real_save(directory, host, units, digest)
        saves.append({"units": sorted(units), "copy_s": t1 - t0,
                      "write_s": time.perf_counter() - t1,
                      "bytes": os.path.getsize(path)})
        return path

    resumes = []
    elastic.save_lane = timed_save
    try:
        for name in ("resume after the kill", "resume with every unit done"):
            src = JsonlSource(root)
            sk.SCATTER_KERNEL_LAUNCHES = 0
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                g = VariantsPcaDriver(conf, src).ingest_gramian()
                sync()
            secs = time.perf_counter() - t0
            by_leg[f"elastic {name} (phase 23a)"] = sk.SCATTER_KERNEL_LAUNCHES
            check(sk.SCATTER_KERNEL_LAUNCHES == 0,
                  f"(a) {name}: the dense route launched the kernel")
            resume_line = [ln for ln in buf.getvalue().splitlines()
                           if ln.startswith("Elastic resume:")]
            resumes.append({"name": name, "s": secs,
                            "shards_read": src.stats.partitions,
                            "line": resume_line})
            check(same_g(g.cpu().numpy(), g_ref),
                  f"(a) {name}: G is not phase 4's")
    finally:
        elastic.save_lane = real_save
    check(resumes[0]["shards_read"] == CKPT_SHARDS - CKPT_EVERY,
          f"(a) the resume read {resumes[0]['shards_read']} shards")
    check(resumes[0]["line"] == [
        f"Elastic resume: 1/3 units already covered by 1 lane(s); this "
        f"process claims 1 lane(s) + 2 new unit(s)."],
        f"(a) resume line {resumes[0]['line']}")
    check(resumes[1]["shards_read"] == 0, "(a) a full resume read shards")
    out["a"] = {"first_lane_s": runs["lane_s"], "resumes": resumes,
                "lane_saves": saves}
    print(f"  (a) the elastic CLI run's first lane after "
          f"{runs['lane_s']:.2f} s, then SIGKILL; resumes: "
          + "; ".join(f"{r['name']} {r['s']:.3f} s, {r['shards_read']} "
                      f"shards read" for r in resumes)
          + f"; G phase 4's bit for bit; lane writes (copy, write, bytes): "
          + ", ".join(f"{x['copy_s']:.4f}+{x['write_s']:.4f} s "
                      f"{x['bytes']}" for x in saves), flush=True)

    # (b) the one-rank NCCL group with --checkpoint-dir ----------------------
    group = runs["group"]
    stdout, stderr = group.communicate(timeout=300)
    check(group.returncode == 0,
          f"(b) the group CLI run exited {group.returncode}: "
          f"{stderr[-2000:]}")
    backend = "nccl" if on_card else "gloo"
    check(f"GROUP {backend} 1" in stdout, "(b) the process group was not up")
    rows = [ln.split("\t") for ln in stdout.splitlines()
            if ln.count("\t") == 3]
    by_name = {r[0]: (float(r[2]), float(r[3])) for r in rows}
    src = JsonlSource(root)
    names = VariantsPcaDriver(PcaConfig(
        variant_set_ids=[DEFAULT_VARIANT_SET_ID], device=device),
        src).cohort
    coords = np.array([by_name[names.names[cid]]
                       for cid in names.callset_of_index()])
    group_err = float(np.abs(coords - want).max())
    snap_dir = os.path.join(work, "group-run")
    check(snapshot_done(snap_dir) == CKPT_SHARDS,
          "(b) the snapshot must hold every shard")
    out["b"] = {"s_since_start": time.perf_counter() - runs["t0"],
                "coord_err": group_err}
    print(f"  (b) pca --checkpoint-dir under a one-rank {backend} group: "
          f"{len(rows)} rows, coordinates vs the f64 oracle max abs "
          f"{group_err:.3e}; snapshot of {CKPT_SHARDS} shards", flush=True)
    check(group_err <= COORD_TOL, "(b) coordinates beyond the oracle")

    # (c) lane, snapshot and tile snapshot writes ----------------------------
    g_dev = torch.from_numpy(g_ref.astype(np.float32)).to(device)
    writes = {"lane": [], "snapshot": [], "tiles": []}
    grid = ShardedGramian.from_full(
        g_dev, make_mesh("data:2,model:2",
                         devices=[torch.device(device)] * 4))
    n = g_ref.shape[0]
    for _ in range(3):
        t0 = time.perf_counter()
        elastic.save_lane(os.path.join(work, "lanes"), g_dev, [0], "c")
        writes["lane"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        checkpoint.save_snapshot(os.path.join(work, "snap"), g_dev, 1, "c")
        writes["snapshot"].append(time.perf_counter() - t0)
        tiles = []
        for (i, j), tile in grid.local_tiles():
            r0, c0 = grid.tile_origin(i, j)
            rs = slice(min(r0, n), min(r0 + grid.tile_rows, n))
            cs = slice(min(c0, n), min(c0 + grid.tile_cols, n))
            tiles.append(((rs, cs), tile[: rs.stop - rs.start,
                                         : cs.stop - cs.start]))
        t0 = time.perf_counter()
        checkpoint.save_sharded_snapshot(os.path.join(work, "tiles"), tiles,
                                         n, 1, "c")
        writes["tiles"].append(time.perf_counter() - t0)
    loaded = checkpoint.load_sharded_snapshot(os.path.join(work, "tiles"),
                                              "c", n)
    check(loaded is not None and sum(t.size for t in loaded[1].values())
          == n * n, "(c) the tile snapshot must cover G")
    out["c"] = {k: [round(x, 6) for x in v] for k, v in writes.items()}
    print(f"  (c) writes of the {n} x {n} G from the card, seconds: "
          f"{json.dumps(out['c'])}", flush=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print("  phase 23 numbers: " + json.dumps(out))
    print(f"  phase 23 card (nvidia-smi name, power.limit): "
          f"{nvidia_smi_line()}")
    return by_leg, out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    from spark_examples_tpu_torch import cuda_build
    from spark_examples_tpu_torch.arrays.blocks import (
        _densify_window,
        round_up_multiple,
    )
    from spark_examples_tpu_torch.genomics.fixtures import (
        DEFAULT_VARIANT_SET_ID,
        synthetic_cohort,
    )
    from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
    from spark_examples_tpu_torch.ops import scatter_kernel as sk
    from spark_examples_tpu_torch.ops.pcoa import (
        mllib_principal_components_reference,
    )
    from spark_examples_tpu_torch.ops.sparse import (
        padded_carrier_matrix,
        window_route,
    )
    from spark_examples_tpu_torch.utils.config import PcaConfig

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    print("== 1. device")
    print(f"  torch.cuda.get_device_name: {torch.cuda.get_device_name(0)}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"  nvidia-smi name, power.limit: {smi}")

    print("== 2. build", flush=True)
    t0 = time.perf_counter()
    cuda_build.build(["scatter_pairs", "genomics_native"])
    print(f"  scatter_pairs.cu (nvcc) and genomics_native.cpp (g++) built "
          f"together in {time.perf_counter() - t0:.2f} s")
    report = ptxas_report(cuda_build.build_log("scatter_pairs"))
    check(report, "the compiler reported no kernel resources")
    for line in report:
        print(f"  {line}")

    print("== 3. kernel vs plain version", flush=True)
    max_abs_err, cases = kernel_cases(torch, sk, dev)

    print("== 4. main path", flush=True)
    t0 = time.perf_counter()
    source = synthetic_cohort(
        N_SAMPLES, N_VARIANTS, seed=0, population_structure=3,
        rare_variant_af=0.01, sparse_calls=True,
    )
    print(f"  cohort generated in {time.perf_counter() - t0:.2f} s")
    conf = PcaConfig(
        variant_set_ids=[DEFAULT_VARIANT_SET_ID], pca_mode="sparse",
        device="cuda",
    )
    sk.SCATTER_KERNEL_LAUNCHES = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        driver = VariantsPcaDriver(conf, source)
        result = driver.run()
    run_s = time.perf_counter() - t0
    launches = sk.SCATTER_KERNEL_LAUNCHES
    lines = out.getvalue().splitlines()
    tsv = [line for line in lines if line.count("\t") == 3]
    for line in lines:
        if line not in tsv:
            print(f"  | {line}")
    print(f"  driver.run(): {run_s:.3f} s, {len(tsv)} result lines")
    check(len(tsv) == N_SAMPLES, f"expected {N_SAMPLES} result lines")

    windows = host_windows(source, conf, driver.index.indexes)
    routes = [window_route(lens, N_SAMPLES, conf.sparse_density_threshold)
              for _, lens in windows]
    n_scatter, n_dense = routes.count("scatter"), routes.count("dense")
    print(f"  windows: {n_scatter} scatter, {n_dense} dense; "
          f"scatter kernel launches in the run: {launches}")
    check(launches > 0 and launches == n_scatter,
          "the run must launch the kernel once per scatter window")
    check(n_dense > 0, "the cohort must exercise the dense route too")

    t0 = time.perf_counter()
    g_ref = np.zeros((N_SAMPLES, N_SAMPLES), np.float64)
    for idx, lens in windows:
        x = _densify_window(idx, lens, N_SAMPLES, lens.size).astype(
            np.float64)
        g_ref += x @ x.T  # 0/1 products: exact integers below 2^53
    g_ref = g_ref.astype(np.int64)
    g_dev = driver.g.cpu().numpy()
    check(g_dev.shape == (N_SAMPLES, N_SAMPLES), "G has the wrong shape")
    check(np.array_equal(g_dev.astype(np.int64), g_ref)
          and np.array_equal(g_dev, g_ref.astype(np.float32)),
          "G is not bit-identical to the host int64 product")
    print(f"  G bit-identical to the host product "
          f"(max entry {g_ref.max()}), checked in "
          f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    want, _ = mllib_principal_components_reference(g_ref, 2)
    coords = np.array([[pc1, pc2] for _, pc1, pc2 in result])
    check(coords.shape == (N_SAMPLES, 2) and np.isfinite(coords).all(),
          "coordinates must be finite, one pair per sample")
    coord_err = float(np.abs(coords - want).max())
    print(f"  coordinates vs host f64 oracle: max abs err {coord_err:.3e} "
          f"(bar {COORD_TOL}), oracle {time.perf_counter() - t0:.2f} s")
    check(coord_err <= COORD_TOL, "coordinates beyond the oracle bar")
    stage_s = {k: round(v, 6) for k, v in driver.timer.seconds.items()}
    print(f"  stage seconds: {json.dumps(stage_s)}")

    print("  a second run under torch.profiler (CPU and CUDA activity):",
          flush=True)
    from torch.profiler import ProfilerActivity, profile

    with contextlib.redirect_stdout(io.StringIO()), profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        profiled = VariantsPcaDriver(conf, source)
        profiled.run()
    stage_s = {k: round(v, 6) for k, v in profiled.timer.seconds.items()}
    print(f"  stage seconds under the profiler: {json.dumps(stage_s)}")
    profile_split(prof)

    print("== 5. kernel timing at the main path's shapes", flush=True)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    # Half a second of device work first: the card has idled through the
    # host-side checks, and its clocks rise only under load.
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.5:
        for _ in range(50):
            flush.add_(1)
        torch.cuda.synchronize()
    timings = []
    for w, ((idx, lens), route) in enumerate(zip(windows, routes)):
        if route != "scatter":
            continue
        mat = padded_carrier_matrix(
            idx, lens, sentinel=N_SAMPLES,
            n_rows=round_up_multiple(lens.size, sk.SCATTER_CHUNK_VARIANTS),
        )
        r = torch.from_numpy(mat).to(dev)
        timings.append(time_shape(
            torch, sk, dev, flush, f"main-path window {w}",
            (N_SAMPLES, N_SAMPLES), r, r,
        ))
    for name in ("square N=2504 K=8", "square N=2504 K=512"):
        g0, row, _ = cases[name]
        r = torch.from_numpy(row).to(dev)
        time_shape(torch, sk, dev, flush, f"phase-3 {name}", g0.shape, r, r)
    first = timings[0]

    print("== 6. CLI", flush=True)
    t_phase = time.perf_counter()
    cohort_dir = tempfile.mkdtemp(prefix="chip_smoke_cohort_")
    atexit.register(shutil.rmtree, cohort_dir, True)
    t0 = time.perf_counter()
    source.dump(cohort_dir)
    print(f"  phase 4's cohort dumped with FixtureSource.dump in "
          f"{time.perf_counter() - t0:.2f} s (phase 12's directory)",
          flush=True)
    # The three CLI runs start together and run beside phases 7 and 8;
    # they are collected before phase 9's timings (and phase 12 reads
    # their sidecar).
    cli_out = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    atexit.register(shutil.rmtree, cli_out, True)
    clis = [
        ("pca --pca-mode sparse on a fixture", 256, start_cli(
            root, cli_out, "sparse", "pca", "--fixture-samples", "256",
            "--fixture-variants", "2048", "--fixture-rare-af", "0.005",
            "--fixture-sparse-calls", "--pca-mode", "sparse",
            "--sparse-density-threshold", "0.05")),
        ("the default command (no --pca-mode)", 256, start_cli(
            root, cli_out, "default", "pca", "--fixture-samples", "256",
            "--fixture-variants", "2048")),
        ("pca --input-path <phase 12's directory> (sidecar built)",
         N_SAMPLES, start_cli(root, cli_out, "input-path", "pca",
                              "--input-path", cohort_dir)),
    ]
    print("  three CLI runs started, collected after phase 8", flush=True)
    print(f"  phase 6 in-process part took "
          f"{time.perf_counter() - t_phase:.2f} s; the script so far "
          f"{time.perf_counter() - T_START:.2f} s")

    print("== 7. odd sample counts", flush=True)
    t_phase = time.perf_counter()
    odd_sample_counts(torch, dev)
    phase_took(7, t_phase)

    print("== 8. dense main path (--pca-mode auto)", flush=True)
    t_phase = time.perf_counter()
    dense_main_path(torch, dev)
    phase_took(8, t_phase)

    print("== 6, collected: the CLI runs", flush=True)
    t_phase = time.perf_counter()
    for label, rows, started in clis:
        code, lines, tail, cli_s = collect_cli(started, 600)
        print(f"  {label} ({cli_s:.2f} s, beside phases 7 and 8):")
        for line in lines:
            if line.count("\t") != 3:
                print(f"  | {line}")
        check(code == 0, f"{label} exited {code}: {tail}")
        check(sum(line.count("\t") == 3 for line in lines) == rows,
              f"{label} must emit one result line per sample")
    print(f"  waited {time.perf_counter() - t_phase:.2f} s for them; the "
          f"script so far {time.perf_counter() - T_START:.2f} s")

    print("== 9. bench shape through pcoa_fused_blocks", flush=True)
    t_phase = time.perf_counter()
    bench_shape(torch, dev)
    phase_took(9, t_phase)

    print("== 10. sketch engine at the biobank width (N = 2^20)", flush=True)
    t_phase = time.perf_counter()
    panel10, coords10, rate10, csr10 = biobank_sketch(torch, dev)
    phase_took(10, t_phase)

    print("== 11. --pca-mode auto past the 4 GiB G bound (N = 40000)",
          flush=True)
    t_phase = time.perf_counter()
    common11, coords11, windows11 = auto_flip(torch, dev)
    phase_took(11, t_phase)

    print("== 12. pca --input-path at the 1000 Genomes width (N = 2504, "
          "V = 65536)", flush=True)
    t_phase = time.perf_counter()
    launches = on_disk_cohort(torch, cohort_dir, source, g_ref, want,
                              len(windows), launches)
    phase_took(12, t_phase)

    print("== 13. the biobank width through the driver (N = 2^20, "
          "--input-path)", flush=True)
    t_phase = time.perf_counter()
    biobank_driver(torch, panel10, coords10, rate10)
    phase_took(13, t_phase)

    print("== 14. the network tier: serve-cohort and pca --api-url "
          "http:// (N = 2504, V = 65536)", flush=True)
    t0 = time.perf_counter()
    launches = network_tier(torch, cohort_dir, g_ref, want, len(windows),
                            launches)
    print(f"  phase 14 took {time.perf_counter() - t0:.2f} s; the script "
          f"so far {time.perf_counter() - T_START:.2f} s")

    print("== 15. gRPC and the cohort mirror: pca --api-url grpc://, "
          "serve-cohort --grpc-port, --cache-dir/--mirror-mode and the cold "
          "stream (N = 2504, V = 65536)", flush=True)
    t0 = time.perf_counter()
    by_leg = grpc_and_mirror(torch, cohort_dir, g_ref, want, len(windows),
                             launches)
    by_leg = {"http sparse, frame tier (phase 14)": launches, **by_leg}
    print(f"  scatter launches by sparse run: {json.dumps(by_leg)}")
    print(f"  phase 15 took {time.perf_counter() - t0:.2f} s; the script "
          f"so far {time.perf_counter() - T_START:.2f} s")

    print("== 16. reads and PairHMM: pairhmm, reads-example 3 and 4, and "
          "/reads and StreamReads over HTTP, gRPC and the mirror",
          flush=True)
    t0 = time.perf_counter()
    by_leg["pairhmm and reads examples (phase 16)"], reads_dir = (
        pairhmm_and_reads(torch, dev))
    print(f"  phase 16 took {time.perf_counter() - t0:.2f} s; the script "
          f"so far {time.perf_counter() - T_START:.2f} s")

    print("== 17. the host ingest core and its resilience: the native "
          "parse/pack/hash, --shard-retries, the ingest.* faults and "
          "--speculative-ingest (N = 2504, V = 65536)", flush=True)
    t0 = time.perf_counter()
    by_leg.update(host_ingest_core(torch, cohort_dir, g_ref, want, windows,
                                   launches))
    print(f"  phase 17 took {time.perf_counter() - t0:.2f} s; the script "
          f"so far {time.perf_counter() - T_START:.2f} s")

    print("== 18. delta and gang serving: serve-cohort --analyze with the job "
          "tier, the delta and gang Gramians, the journal, the store and "
          "replicas (N = 2504, V = 65536)", flush=True)
    t0 = time.perf_counter()
    cancel = start_soft_cancel(cohort_dir)
    by_leg.update(delta_and_gang_serving(torch, cohort_dir, g_ref, launches,
                                         reads_dir))
    print(f"  phase 18 took {time.perf_counter() - t0:.2f} s; the script "
          f"so far {time.perf_counter() - T_START:.2f} s")

    print("== 19. checkpointed ingest, soft cancel, the job's mid-ingest "
          "resume, the PcaBackend bridge and --trace-dir (N = 2504, "
          "V = 65536)", flush=True)
    t0 = time.perf_counter()
    by_leg.update(checkpointed_ingest(torch, cohort_dir, g_ref, want,
                                      windows, launches, cancel))
    print(f"  phase 19 took {time.perf_counter() - t0:.2f} s; the script "
          f"so far {time.perf_counter() - T_START:.2f} s")

    print("== 20. the mesh layer's single-controller half and the process "
          "group: --mesh-shape, the tile scatter, the randomized eig, a "
          "meshed job and bridge call, pca under a one-rank NCCL group "
          "(N = 2504, V = 65536)", flush=True)
    t0 = time.perf_counter()
    mesh_legs, tile_path = mesh_and_process_group(
        torch, cohort_dir, g_ref, want, windows)
    by_leg.update(mesh_legs)
    print(f"  phase 20 took {time.perf_counter() - t0:.2f} s; the script "
          f"so far {time.perf_counter() - T_START:.2f} s")

    print("== 21. the pod regime's per-rank work on one card: the scatter "
          "kernel's mirrored tile path, the mirror fill and the pod dense "
          "tile step (N = 2504, V = 65536)", flush=True)
    t0 = time.perf_counter()
    pod_legs, pod_path = pod_tile_paths(torch, g_ref, windows)
    by_leg.update(pod_legs)
    print(f"  phase 21 took {time.perf_counter() - t0:.2f} s; the script "
          f"so far {time.perf_counter() - T_START:.2f} s")

    print("== 22. the sketch on a mesh: sharded_sketch_panel on a data:1 "
          "mesh, the TSQR finish over a grid of row blocks, auto's flip on "
          "a mesh and a pod rank's card work (N = 2^20 and 40000)",
          flush=True)
    t0 = time.perf_counter()
    ckpt_runs = start_checkpoint_runs(cohort_dir)
    sketch_legs, _ = sketch_on_a_mesh(torch, csr10, panel10, coords10,
                                      common11, coords11, windows11)
    by_leg.update(sketch_legs)
    print(f"  phase 22 took {time.perf_counter() - t0:.2f} s; the script "
          f"so far {time.perf_counter() - T_START:.2f} s")

    print("== 23. checkpoints on the card: --elastic-checkpoint killed and "
          "resumed, --checkpoint-dir under a one-rank NCCL group, lane and "
          "snapshot writes (N = 2504, V = 65536)", flush=True)
    t0 = time.perf_counter()
    ckpt_legs, _ = checkpoints_on_the_card(torch, cohort_dir, g_ref, want,
                                           ckpt_runs)
    by_leg.update(ckpt_legs)
    print(f"  phase 23 took {time.perf_counter() - t0:.2f} s; the script "
          f"so far {time.perf_counter() - T_START:.2f} s")

    print(json.dumps({"kernels": [{
        "name": "scatter_pairs",
        "route": "cuda",
        "source": "spark_examples_tpu_torch/csrc/scatter_pairs.cu",
        "replaces": "spark_examples_tpu/ops/scatter_kernel.py:205",
        "launches": sum(by_leg.values()),
        "launches_by_path": by_leg,
        "tile_path": tile_path,
        "mirrored_tile_path": pod_path["window"],
        "max_abs_err": max_abs_err,
        "equal_to_plain": True,
        **first,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
