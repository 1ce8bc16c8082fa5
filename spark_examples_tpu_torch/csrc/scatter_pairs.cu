// Pair scatter-accumulate for the sparse Gramian engine, hand-written for
// Hopper (sm_90a).
//
// Replaces spark_examples_tpu/ops/scatter_kernel.py::scatter_pairs_kernel
// (the Pallas one-hot-count kernel of the JAX package). Same function:
//
//     g[row_idx[v, a], col_idx[v, b]] += 1   for every (v, a, b),
//
// with any index outside [0, n_rows) / [0, n_cols) dropped (the carrier
// pad sentinel, out-of-tile carriers) and duplicate carriers counted with
// their multiplicity.
//
// What bounds it on the card. Per sparse window it must read the
// (V_pad, K) int32 index matrix once and read and write G once: at the
// 1000 Genomes cohort width (N = 2504) G is 25.08 MB, so about 52 MB per
// window, about 16 us at 3.35 TB/s. The work is one f32 add per valid
// pair, sum_v k_v^2 (about 5.3 M pairs per window at 1% allele
// frequency), far below the card's f32 rate: the kernel is bound by
// bytes.
//
// What this design does about it: nothing yet. It is the simple first
// port. One thread block per variant row; the block walks the row's K
// row indices in order (one broadcast load each, a uniform branch drops
// a sentinel for the whole block), and its threads stride over the K
// column indices, paying one atomicAdd in L2 per valid pair. G fits the
// 50 MB L2, so the atomics mostly hit L2 rather than device memory.
// Each block loads its own indices, so K bounds neither shared memory
// nor registers: any K >= 1 launches.
//
// Exactness. Every update adds exactly 1.0f and every count stays below
// 2^24, where f32 represents all integers exactly, so the sum does not
// depend on the order the atomics land in. The result is bit-identical
// to the plain version (an index_put_ accumulation) and to the JAX
// package's scan and Pallas paths: the same argument as the
// precision=HIGHEST comment in the Pallas kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void scatter_pairs_kernel(float* __restrict__ g,
                                     const int32_t* __restrict__ row_idx,
                                     const int32_t* __restrict__ col_idx,
                                     int64_t k, int64_t n_rows,
                                     int64_t n_cols) {
  const int64_t v = blockIdx.x;
  const int32_t* rows = row_idx + v * k;
  const int32_t* cols = col_idx + v * k;
  for (int64_t a = 0; a < k; ++a) {
    const int64_t r = rows[a];
    if (r < 0 || r >= n_rows) continue;  // uniform across the block
    float* g_row = g + r * n_cols;
    for (int64_t b = threadIdx.x; b < k; b += blockDim.x) {
      const int64_t c = cols[b];
      if (c >= 0 && c < n_cols) atomicAdd(g_row + c, 1.0f);
    }
  }
}

}  // namespace

// Plain C entry point for ctypes. g is a contiguous (n_rows, n_cols) f32
// matrix; row_idx and col_idx are contiguous (v_pad, k) int32 matrices,
// possibly the same buffer. Launches on `stream` and returns the launch's
// cudaError_t (0 = success); it does not synchronise.
extern "C" int scatter_pairs_launch(void* g, const void* row_idx,
                                    const void* col_idx, int64_t v_pad,
                                    int64_t k, int64_t n_rows,
                                    int64_t n_cols, void* stream) {
  if (v_pad == 0 || k == 0) return static_cast<int>(cudaSuccess);
  int threads = static_cast<int>(((k + 31) / 32) * 32);
  if (threads > 256) threads = 256;
  scatter_pairs_kernel<<<static_cast<unsigned int>(v_pad), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(g), static_cast<const int32_t*>(row_idx),
      static_cast<const int32_t*>(col_idx), k, n_rows, n_cols);
  return static_cast<int>(cudaGetLastError());
}
