"""Where the scatter kernel's time goes, phase by phase, on one GPU.

    python3 -m spark_examples_tpu_torch.tools.scatter_phases [--seed S]

Builds ``csrc/scatter_pairs.cu`` with ``-DSCATTER_PHASE_STAMPS`` (thread 0
of every band kernel block then records the card's global timer at the
block's start, set-up done, variants listed, variant loop done and
epilogue done) into ``_build/``, and runs it on one window of the slice
cell's shape: N = 2504 samples, V_pad = 8192 variants, K = 64, carriers
per variant Poisson with mean 25 and sorted, as the main path pads them.
Each of 20 calls finds L2 overwritten first, as ``chip_smoke.py`` times
them. Prints the median time of a call by CUDA events and the two
kernels' mean device times from ``torch.profiler``; then, for the last
call, each boundary's median and latest time over the blocks, in
microseconds from the first block's start; and the median number of
variants a band lists. Needs a CUDA device; the result is checked
bit-identical to the plain version before it is timed.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess

import numpy as np
import torch

from spark_examples_tpu_torch import cuda_build
from spark_examples_tpu_torch.ops import scatter_kernel as sk

N, V_PAD, K, MEAN_CARRIERS = 2504, 8192, 64, 25
STAMPS = ("start", "set-up", "listed", "loop", "epilogue")
STAMP_BLOCKS = 4096  # kStampBlocks in the source


def build_stamped() -> ctypes.CDLL:
    src = os.path.join(cuda_build.CSRC_DIR, "scatter_pairs.cu")
    out = os.path.join(cuda_build.BUILD_DIR, "libscatter_pairs-stamps.so")
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    subprocess.run(
        [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
         "-DSCATTER_PHASE_STAMPS", "-o", out, src],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(out)
    lib.scatter_pairs_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 9 + [ctypes.c_void_p] * 3
    )
    lib.scatter_pairs_launch.restype = ctypes.c_int
    lib.scatter_phase_stamps.argtypes = [ctypes.c_void_p]
    lib.scatter_phase_stamps.restype = ctypes.c_int
    return lib


def slice_window(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    lens = rng.poisson(MEAN_CARRIERS, size=V_PAD).clip(0, K)
    mat = np.full((V_PAD, K), N, np.int32)
    for v, n in enumerate(lens):
        mat[v, :n] = np.sort(rng.choice(N, n, replace=False))
    return mat


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("scatter_phases: needs a CUDA device")
    dev = torch.device("cuda")
    lib = build_stamped()
    r = torch.from_numpy(slice_window(args.seed)).to(dev)
    plan = sk.scatter_plan(
        N, N, torch.cuda.get_device_properties(dev).multi_processor_count
    )
    scratch = torch.empty(9 * V_PAD, dtype=torch.int32, device=dev)
    g = torch.zeros((N, N), device=dev)

    def call():
        err = lib.scatter_pairs_launch(
            g.data_ptr(), r.data_ptr(), r.data_ptr(), V_PAD, K, N, N,
            *plan, scratch.data_ptr(), scratch[V_PAD:].data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if err:
            raise RuntimeError(f"scatter_phases: launch failed ({err})")

    call()
    want = sk.scatter_pairs_chunked(torch.zeros_like(g), r, r)
    torch.cuda.synchronize()
    if not torch.equal(g, want):
        raise SystemExit("scatter_phases: stamped kernel != plain version")
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    for _ in range(200):  # raise the clocks
        flush.add_(1)
    call_ms = []
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        for _ in range(20):
            flush.add_(1)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            torch.cuda.synchronize()
            call_ms.append(start.elapsed_time(end))
    print(f"plan {plan}")
    print(f"one call (both kernels): median {np.median(call_ms):.4f} ms "
          "by CUDA events")
    for row in prof.key_averages():
        for name in ("variant_extent_kernel", "scatter_band_kernel"):
            if name in row.key:
                print(f"{name}: {row.device_time_total / row.count:.2f} "
                      f"us mean device time over {row.count} calls")
    stamps = np.zeros(STAMP_BLOCKS * len(STAMPS), np.uint64)
    if lib.scatter_phase_stamps(stamps.ctypes.data):
        raise RuntimeError("scatter_phases: reading the stamps failed")
    t = stamps.reshape(STAMP_BLOCKS, len(STAMPS))[:plan.n_bands]
    t = (t.astype(np.int64) - int(t[:, 0].min())) / 1e3
    for i, name in enumerate(STAMPS):
        print(f"{name:9s} median {np.median(t[:, i]):7.2f} us, "
              f"latest {t[:, i].max():7.2f} us")
    mat = r.cpu().numpy()
    v_of, a_of = np.nonzero(mat < N)
    touches = np.unique(v_of.astype(np.int64) * plan.n_bands
                        + mat[v_of, a_of] // plan.band_rows)
    per_band = np.bincount(touches % plan.n_bands, minlength=plan.n_bands)
    print(f"variants listed per band: median {np.median(per_band):.0f} "
          f"of {V_PAD}; seed {args.seed}")
    print(torch.cuda.get_device_name(dev))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
