#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, on a GPU host

Drives the port's main path — meshless ``pca --pca-mode sparse`` through
``VariantsPcaDriver.run()`` at the 1000 Genomes phase-3 cohort width
(N = 2504 samples, V = 65536 rare variants) — and holds every hand-written
kernel of that path against its plain PyTorch version on the card. Phases,
each of which exits non-zero on failure:

1. device: the card's name, CUDA version, name and power limit;
2. build: every kernel of the path compiled from ``csrc/`` (timed);
3. kernel vs plain version on the card, bit-identical (``torch.equal``),
   across square, rectangular, K ∈ {8, 64, 512}, duplicate-carrier and
   all-sentinel cases;
4. main path: kernel launch counts reset, one driver run, counts read;
   G bit-identical to a host float64 product of the same carrier lists
   (exact below 2^53, compared as int64); coordinates within 1e-4 of the
   host float64 MLlib-literal oracle after sign normalization;
5. kernel timings at the main path's own shapes (a scatter window of the
   cohort): kernel, plain version, one-call library yardstick, and the
   bound the card's memory and f32 rates set;
6. the CLI in a subprocess on the card.

The last lines are one ``{"kernels": [...]}`` JSON line, the card's name
and power limit as ``nvidia-smi`` reports them, and the result line
``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout of
the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth and
# float32 rate outside the tensor cores (the kernel does f32 adds).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

N_SAMPLES = 2504  # 1000 Genomes phase 3
N_VARIANTS = 65536
COORD_TOL = 1e-4  # the MLlib-oracle parity bar


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


def kernel_cases(torch, sk, dev):
    """Phase 3: the scatter kernel against its plain version, on the card."""
    rng = np.random.default_rng(0)

    def random_case(t_r, t_c, v_pad, k, same):
        row = rng.integers(0, t_r, size=(v_pad, k)).astype(np.int32)
        row[rng.random((v_pad, k)) < 0.2] = t_r  # pad sentinels
        if same:
            col = row
        else:
            col = rng.integers(0, t_c, size=(v_pad, k)).astype(np.int32)
            col[rng.random((v_pad, k)) < 0.2] = t_c + 7
        g0 = rng.integers(0, 9, size=(t_r, t_c)).astype(np.float32)
        return g0, row, col

    cases = {}
    for k in (8, 64, 512):
        cases[f"square N={N_SAMPLES} K={k}"] = random_case(
            N_SAMPLES, N_SAMPLES, 256 if k == 512 else 1024, k, True
        )
    cases["rectangular 256x384 K=16"] = random_case(256, 384, 512, 16, False)
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
        if name.startswith("duplicates"):
            check(float(got[5, 5]) == 64.0 * 64.0 and
                  float(got.sum()) == 64.0 * 64.0,
                  "duplicate carriers must count with multiplicity")
        if name.startswith("all-sentinel"):
            check(torch.equal(got.cpu(), torch.from_numpy(g0)),
                  "an all-sentinel index matrix must leave G unchanged")
    return max_err


def host_windows(source, conf, indexes):
    """The driver's CSR windows, rebuilt on the host from the same source."""
    from spark_examples_tpu_torch.arrays.blocks import windows_from_calls

    calls = []
    for shard in conf.shards():
        calls.extend(source.stream_carrying(
            conf.variant_set_ids[0], shard, indexes
        ))
    return list(windows_from_calls(calls, conf.block_variants))


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
    cuda_build.build(["scatter_pairs"])
    print(f"  scatter_pairs.cu built in {time.perf_counter() - t0:.2f} s")

    print("== 3. kernel vs plain version", flush=True)
    max_abs_err = kernel_cases(torch, sk, dev)

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

    print("== 5. kernel timing at the main path's shapes", flush=True)
    idx, lens = windows[routes.index("scatter")]
    mat = padded_carrier_matrix(
        idx, lens, sentinel=N_SAMPLES,
        n_rows=round_up_multiple(lens.size, sk.SCATTER_CHUNK_VARIANTS),
    )
    r = torch.from_numpy(mat).to(dev)
    v_pad, k = mat.shape
    pairs = int((lens.astype(np.int64) ** 2).sum())
    ri = r.long()[:, :, None]
    ci = r.long()[:, None, :]
    flat_idx = (ri * N_SAMPLES + ci)[(ri < N_SAMPLES) & (ci < N_SAMPLES)]
    ones = torch.ones(flat_idx.numel(), device=dev)
    g_k, g_p, g_l = (
        torch.zeros((N_SAMPLES, N_SAMPLES), device=dev) for _ in range(3)
    )

    def kernel():
        sk.scatter_pairs(g_k, r, r)

    def plain():
        sk.scatter_pairs_chunked(g_p, r, r)

    def library():
        g_l.view(-1).index_put_((flat_idx,), ones, accumulate=True)

    for fn in (kernel, plain, library):
        fn()
    check(torch.equal(g_k, g_p) and torch.equal(g_k, g_l),
          "kernel, plain version and library call disagree on the window")
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    ms = time_cuda(kernel, 20, flush)
    plain_ms = time_cuda(plain, 5, flush)
    library_ms = time_cuda(library, 10, flush)
    moved = mat.nbytes + 2 * N_SAMPLES * N_SAMPLES * 4
    bytes_ms = moved / PEAK_BYTES_PER_S * 1e3
    ops_ms = pairs / PEAK_F32_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"  window: V_pad={v_pad} K={k} pairs={pairs} bytes={moved}")
    print(f"  kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
          f"share {bound_ms / ms:.3f}")

    print("== 6. CLI", flush=True)
    cli = subprocess.run(
        [sys.executable, "-m", "spark_examples_tpu_torch.cli.main", "pca",
         "--fixture-samples", "256", "--fixture-variants", "2048",
         "--fixture-rare-af", "0.005", "--fixture-sparse-calls",
         "--pca-mode", "sparse", "--sparse-density-threshold", "0.05"],
        cwd=root, capture_output=True, text=True, timeout=300,
    )
    cli_lines = cli.stdout.splitlines()
    for line in cli_lines:
        if line.count("\t") != 3:
            print(f"  | {line}")
    check(cli.returncode == 0,
          f"CLI exited {cli.returncode}: {cli.stderr[-2000:]}")
    check(sum(line.count("\t") == 3 for line in cli_lines) == 256,
          "CLI must emit one result line per sample")

    print(json.dumps({"kernels": [{
        "name": "scatter_pairs",
        "route": "cuda",
        "source": "spark_examples_tpu_torch/csrc/scatter_pairs.cu",
        "replaces": "spark_examples_tpu/ops/scatter_kernel.py:205",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "equal_to_plain": True,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
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
