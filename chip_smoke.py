#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, on a GPU host

Drives the port's main path — meshless ``pca --pca-mode sparse`` through
``VariantsPcaDriver.run()`` at the 1000 Genomes phase-3 cohort width
(N = 2504 samples, V = 65536 rare variants) — and holds every hand-written
kernel of that path against its plain PyTorch version on the card. Phases,
each of which exits non-zero on failure:

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
              and e.name not in STAGES]
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
        return
    by_name = {}
    for e in device:
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + e.time_range.elapsed_us(), count + 1)
    total_us = sum(t for t, _ in by_name.values())
    print(f"  device busy {total_us / 1e3:.3f} ms over {len(device)} "
          "kernels and copies; the largest by total time:")
    for name, (t, count) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][0])[:14]:
        print(f"    {t / 1e3:9.3f} ms  x{count:<5d} {name[:90]}")
    spans = [(e.time_range.start, e.time_range.end) for e in device]
    for name in STAGES:
        lo, hi = stages[name]
        busy = merged_busy_us(spans, lo, hi)
        print(f"  {name}: {(hi - lo) / 1e3:.3f} ms wall-clock, device busy "
              f"{busy / 1e3:.3f} ms, idle share {1 - busy / (hi - lo):.4f}")


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
