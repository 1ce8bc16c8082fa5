// Pair scatter-accumulate for the sparse Gramian engine, hand-written for
// Hopper (sm_90a).
//
// Replaces spark_examples_tpu/ops/scatter_kernel.py::scatter_pairs_kernel
// (the Pallas one-hot-count kernel of the JAX package). Same function:
//
//     g[row_idx[v, a], col_idx[v, b]] += 1   for every (v, a, b),
//
// with any index outside [0, n_rows) / [0, n_cols) dropped (the carrier
// pad sentinel, out-of-tile carriers, the negative indices of rebased tile
// operands) and duplicate carriers counted with their multiplicity.
//
// What bounds it on the card. Per sparse window it must read the
// (V_pad, K) int32 index matrix once and read and write G once: at the
// 1000 Genomes cohort width (N = 2504) G is 25.08 MB, so about 52 MB per
// window, about 16 us at 3.35 TB/s. The work is one add per valid pair,
// sum_v k_v^2 (about 5.5 M pairs per window at 1% allele frequency), far
// below the card's rate: the kernel is bound by bytes, and every byte of
// G beyond one read and one write is waste.
//
// What this design does about it: it is output-stationary, as the Pallas
// kernel is. That kernel keeps a row block of G in VMEM across the
// sequential grid axis over variant chunks; here the sequential axis is a
// loop inside a thread block, and the resident block is a band of
// `band_rows` rows x `tile_cols` columns of int32 counters in dynamic
// shared memory (up to 227 KB). Two kernels per call:
//
//   1. variant_extent_kernel, one warp per variant: the variant's extent
//      (one past its last slot holding an in-range row or column index;
//      right-padded rows stop early) and a 256-bit mask of the row bands
//      its in-range rows fall in (bit = band * 256 / n_bands, so with up
//      to 256 bands each band has its own bit). Both go to scratch that
//      the wrapper allocates; the mask is stored word-major so a band
//      reads its bit of every variant as one contiguous stream.
//   2. scatter_band_kernel, one 1024-thread block per (row band, column
//      tile): it zeroes its counters, asks L2 for its part of G, then
//      walks the variants in chunks of 8192. Each chunk is filtered by the
//      band's mask bit and compacted into a shared list of packed
//      (variant, extent) words (warp ballot and one shared atomic per
//      warp), so a band reads only the index rows of the variants that
//      touch it, and only up to their extents. A warp takes four listed
//      variants at once, each lane holding slots lane and lane + 32 of
//      each in registers (all eight loads in flight before any is used),
//      finds the slots whose row lies in the band by ballot, and for each
//      such row adds 1 to the counter of every in-tile column the warp
//      holds with a shared-memory atomicAdd; a variant longer than 64
//      slots is walked 32 slots at a time. There are no global atomics.
//      The epilogue adds the counts into G once, four 16-byte loads in
//      flight per thread where the widths allow 16-byte access: each
//      element of G is read once and written once.
//
// A full row that does not fit in shared memory (n_cols above about 50 K)
// splits the band into column tiles: a 2-D grid. The geometry (band
// height, tile width, grid, shared bytes) is chosen by
// ops/scatter_kernel.py::scatter_plan and checked here; any shape and any
// K launches. The known cost of the design is that every band re-reads
// the mask column of every variant (4 bytes each) and the index rows of
// the variants it touches: a variant is visited once per band holding one
// of its carriers, so the variant loop does work in proportion to the
// carriers, and it does not overlap the epilogue's traffic to G. PERF.md
// has the measured split.
//
// Exactness and determinism. Counters are integers; a count and a G entry
// below 2^24 are exact in float32, so `g + (float)count` is exact and the
// result is bit-identical to the plain version (an index_put_
// accumulation of +1s) and to the JAX package's scan and Pallas paths.
// Shared atomics change only the order in which integer counters are
// incremented, and each element of G is written by exactly one thread
// with one add, so the result and the memory traffic to G are the same
// on every run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;                 // band kernel block size
constexpr int kWarps = kThreads / 32;
constexpr int kListVariants = 8192;            // variants per filtered chunk
constexpr int kPerThread = kListVariants / kThreads;
// A list entry packs a variant's place in its chunk (13 bits) and its
// extent (19 bits; an extent that does not fit is read again from global).
constexpr int kExtentBits = 19;
constexpr unsigned kExtentMask = (1u << kExtentBits) - 1u;
constexpr int kListBytes = kListVariants * 4;
constexpr int kMaskWords = 8;                  // 256 band bits per variant
constexpr int kMaskBits = 32 * kMaskWords;
constexpr int kUnroll = 4;                     // listed variants per warp step
constexpr int kEpilogueUnroll = 4;             // G loads in flight per thread
constexpr int kExtentThreads = 256;            // extent kernel block size
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int band_bit(int64_t band, int64_t n_bands) {
  return static_cast<int>(band * kMaskBits / n_bands);
}

// Phase stamps for tools/scatter_phases.py. Built with
// -DSCATTER_PHASE_STAMPS, thread 0 of each band kernel block (first column
// tile) records the card's global timer at the block's start, set-up done,
// variants listed, variant loop done and epilogue done; otherwise the
// stamps compile to nothing.
constexpr int kStamps = 5;
#ifdef SCATTER_PHASE_STAMPS
constexpr int kStampBlocks = 4096;
__device__ unsigned long long g_phase_stamps[kStampBlocks * kStamps];
__device__ __forceinline__ void phase_stamp(int i) {
  if (threadIdx.x == 0 && blockIdx.y == 0 && blockIdx.x < kStampBlocks) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_phase_stamps[blockIdx.x * kStamps + i] = t;
  }
}
#else
__device__ __forceinline__ void phase_stamp(int) {}
#endif

// x - base as unsigned: below `extent` exactly when base <= x < base +
// extent, with no signed overflow for any int32 x (negatives wrap high).
__device__ __forceinline__ unsigned offset(int x, int base) {
  return static_cast<unsigned>(x) - static_cast<unsigned>(base);
}

__global__ void __launch_bounds__(kExtentThreads) variant_extent_kernel(
    const int32_t* __restrict__ row_idx, const int32_t* __restrict__ col_idx,
    int64_t v_pad, int64_t k, int64_t n_rows, int64_t n_cols, int band_rows,
    int64_t n_bands, int32_t* __restrict__ extent,
    uint32_t* __restrict__ mask) {
  const int lane = threadIdx.x & 31;
  const int64_t v = static_cast<int64_t>(blockIdx.x) * (kExtentThreads / 32) +
                    threadIdx.x / 32;
  if (v >= v_pad) return;  // uniform across the warp
  const int32_t* rows = row_idx + v * k;
  const int32_t* cols = col_idx + v * k;
  uint32_t words[kMaskWords] = {};  // uniform across the warp
  int last = 0;
#pragma unroll 2
  for (int64_t a0 = 0; a0 < k; a0 += 32) {
    const int64_t a = a0 + lane;
    const int32_t r = a < k ? rows[a] : -1;
    const int32_t c = a < k ? cols[a] : -1;
    const bool row_in = r >= 0 && r < n_rows;
    if (row_in || (c >= 0 && c < n_cols)) last = static_cast<int>(a + 1);
    const int bit = row_in ? band_bit(r / band_rows, n_bands) : -1;
#pragma unroll
    for (int w = 0; w < kMaskWords; ++w) {
      words[w] |=
          __reduce_or_sync(kFull, (bit >> 5) == w ? 1u << (bit & 31) : 0u);
    }
  }
  last = __reduce_max_sync(kFull, last);
  uint32_t mine = 0;
#pragma unroll
  for (int w = 0; w < kMaskWords; ++w) mine = lane == w ? words[w] : mine;
  if (lane < kMaskWords) mask[lane * v_pad + v] = mine;
  if (lane == 0) extent[v] = last;
}

// For each band row marked in `hits` (lane src holds its offset in `rl`),
// add 1 to the counters of the in-tile columns the warp holds: `cl0` and,
// when `two`, `cl1`, the column offsets of slots lane and lane + 32.
__device__ __forceinline__ void add_row_hits(int* cnt, int tile_cols,
                                             unsigned cols_here,
                                             unsigned hits, unsigned rl,
                                             unsigned cl0, unsigned cl1,
                                             bool two) {
  while (hits) {
    const int src = __ffs(hits) - 1;
    hits &= hits - 1;
    int* row = cnt + __shfl_sync(kFull, rl, src) * tile_cols;
    if (cl0 < cols_here) atomicAdd(row + cl0, 1);
    if (two && cl1 < cols_here) atomicAdd(row + cl1, 1);
  }
}

// kSame: row_idx and col_idx are one buffer, so the columns of a slot are
// its rows and are not loaded twice.
template <bool kSame>
__global__ void __launch_bounds__(kThreads, 1) scatter_band_kernel(
    float* __restrict__ g, const int32_t* __restrict__ row_idx,
    const int32_t* __restrict__ col_idx,
    const int32_t* __restrict__ extent, const uint32_t* __restrict__ mask,
    int64_t v_pad, int k, int64_t n_rows, int64_t n_cols, int band_rows,
    int tile_cols, int64_t n_bands) {
  extern __shared__ __align__(16) int smem[];
  unsigned* list = reinterpret_cast<unsigned*>(smem);  // packed entries
  int* cnt = smem + kListVariants;  // band_rows x tile_cols counters
  __shared__ int list_n;

  const int64_t band = blockIdx.x;
  const int64_t r0 = band * band_rows;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * tile_cols;
  const int rows_here =
      static_cast<int>(n_rows - r0 < band_rows ? n_rows - r0 : band_rows);
  const int cols_here =
      static_cast<int>(n_cols - c0 < tile_cols ? n_cols - c0 : tile_cols);
  const unsigned band_h = static_cast<unsigned>(rows_here);
  const unsigned tile_w = static_cast<unsigned>(cols_here);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ir0 = static_cast<int>(r0);
  const int ic0 = static_cast<int>(c0);
  phase_stamp(0);

  // Filter inputs of a chunk: this band's mask bit and the extent of
  // each variant. The first chunk's are in flight during the set-up.
  const int bit = band_bit(band, n_bands);
  const uint32_t* band_mask = mask + static_cast<int64_t>(bit >> 5) * v_pad;
  const uint32_t band_flag = 1u << (bit & 31);
  uint32_t m[kPerThread];
  int len[kPerThread];
  auto load_chunk = [&](int64_t v0) {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int64_t v = v0 + j * kThreads + tid;
      const bool in = v < v_pad;
      m[j] = in ? __ldg(band_mask + v) : 0u;
      len[j] = in ? __ldg(extent + v) : 0;
    }
  };
  load_chunk(0);

  // Bring this block's part of G toward L2 now, so the epilogue's reads
  // overlap the variant loop instead of following it.
  for (int rl = warp; rl < rows_here; rl += kWarps) {
    const char* p = reinterpret_cast<const char*>(g + (r0 + rl) * n_cols + c0);
    const char* end = p + static_cast<int64_t>(cols_here) * 4;
    p = reinterpret_cast<const char*>(reinterpret_cast<uintptr_t>(p) &
                                      ~static_cast<uintptr_t>(127));
    for (p += lane * 128; p < end; p += 32 * 128) {
      asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
    }
  }
  const int n_cnt = rows_here * tile_cols;
  for (int i = tid; i < n_cnt / 4; i += kThreads) {
    reinterpret_cast<int4*>(cnt)[i] = make_int4(0, 0, 0, 0);
  }
  for (int i = n_cnt / 4 * 4 + tid; i < n_cnt; i += kThreads) cnt[i] = 0;
  if (tid == 0) list_n = 0;
  __syncthreads();
  phase_stamp(1);

  for (int64_t v0 = 0; v0 < v_pad; v0 += kListVariants) {
    if (v0 > 0) load_chunk(v0);
    // Compact the chunk's variants that touch this band into the list.
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const bool keep = (m[j] & band_flag) && len[j] > 0;
      const unsigned ballot = __ballot_sync(kFull, keep);
      if (ballot) {
        int base = 0;
        if (lane == 0) base = atomicAdd(&list_n, __popc(ballot));
        base = __shfl_sync(kFull, base, 0);
        if (keep) {
          const int pos = base + __popc(ballot & ((1u << lane) - 1u));
          list[pos] = static_cast<unsigned>(j * kThreads + tid)
                          << kExtentBits |
                      min(static_cast<unsigned>(len[j]), kExtentMask);
        }
      }
    }
    __syncthreads();
    phase_stamp(2);
    const int n = list_n;

    for (int base = warp * kUnroll; base < n; base += kWarps * kUnroll) {
      // kUnroll listed variants at once; lane holds slots lane and
      // lane + 32 of each, all loads issued before any is used.
      const int32_t* rows[kUnroll];
      const int32_t* cols[kUnroll];
      int ll[kUnroll], rr[kUnroll][2], cc[kUnroll][2];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u;
        const unsigned e = i < n ? list[i] : 0u;
        const int64_t v = v0 + (e >> kExtentBits);
        ll[u] = (e & kExtentMask) == kExtentMask ? __ldg(extent + v)
                                                 : (e & kExtentMask);
        rows[u] = row_idx + v * k;
        cols[u] = kSame ? rows[u] : col_idx + v * k;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool ok = lane < ll[u];
        rr[u][0] = ok ? __ldg(rows[u] + lane) : -1;
        cc[u][0] = kSame ? rr[u][0] : (ok ? __ldg(cols[u] + lane) : -1);
        const bool ok1 = lane + 32 < ll[u];
        rr[u][1] = ok1 ? __ldg(rows[u] + lane + 32) : -1;
        cc[u][1] =
            kSame ? rr[u][1] : (ok1 ? __ldg(cols[u] + lane + 32) : -1);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (ll[u] <= 64) {
          // Every row of the variant in the band meets every column.
          const unsigned cl0 = offset(cc[u][0], ic0);
          const unsigned cl1 = offset(cc[u][1], ic0);
          const bool two = ll[u] > 32;
          const unsigned rl0 = offset(rr[u][0], ir0);
          add_row_hits(cnt, tile_cols, tile_w,
                       __ballot_sync(kFull, rl0 < band_h), rl0, cl0, cl1,
                       two);
          if (two) {
            const unsigned rl1 = offset(rr[u][1], ir0);
            add_row_hits(cnt, tile_cols, tile_w,
                         __ballot_sync(kFull, rl1 < band_h), rl1, cl0,
                         cl1, true);
          }
        } else {
          // A variant longer than 64 slots: walk its rows 32 at a time
          // and, for each row in the band, its columns 32 at a time.
          for (int a0 = 0; a0 < ll[u]; a0 += 32) {
            const int a = a0 + lane;
            const unsigned rl =
                offset(a < ll[u] ? __ldg(rows[u] + a) : -1, ir0);
            unsigned hits = __ballot_sync(kFull, rl < band_h);
            while (hits) {
              const int src = __ffs(hits) - 1;
              hits &= hits - 1;
              int* row = cnt + __shfl_sync(kFull, rl, src) * tile_cols;
              for (int b0 = 0; b0 < ll[u]; b0 += 32) {
                const int b = b0 + lane;
                const unsigned cl =
                    offset(b < ll[u] ? __ldg(cols[u] + b) : -1, ic0);
                if (cl < tile_w) atomicAdd(row + cl, 1);
              }
            }
          }
        }
      }
    }
    __syncthreads();
    if (tid == 0) list_n = 0;
    __syncthreads();
  }
  phase_stamp(3);

  // Epilogue: G += counts, each element read once and written once;
  // kEpilogueUnroll 16-byte loads in flight per thread where the widths
  // allow 16-byte access.
  if (n_cols % 4 == 0 && tile_cols % 4 == 0 &&
      reinterpret_cast<uintptr_t>(g) % 16 == 0) {
    const int quads = cols_here / 4;
    const int total = rows_here * quads;
    auto g_quad = [&](int i) {
      const int rl = i / quads;
      return reinterpret_cast<float4*>(g + (r0 + rl) * n_cols + c0) +
             (i - rl * quads);
    };
    auto cnt_quad = [&](int i) {
      const int rl = i / quads;
      return reinterpret_cast<const int4*>(cnt + rl * tile_cols) +
             (i - rl * quads);
    };
    for (int i0 = tid; i0 < total; i0 += kEpilogueUnroll * kThreads) {
      float4 x[kEpilogueUnroll];
#pragma unroll
      for (int u = 0; u < kEpilogueUnroll; ++u) {
        const int i = i0 + u * kThreads;
        if (i < total) x[u] = *g_quad(i);
      }
#pragma unroll
      for (int u = 0; u < kEpilogueUnroll; ++u) {
        const int i = i0 + u * kThreads;
        if (i < total) {
          const int4 q = *cnt_quad(i);
          x[u].x += static_cast<float>(q.x);
          x[u].y += static_cast<float>(q.y);
          x[u].z += static_cast<float>(q.z);
          x[u].w += static_cast<float>(q.w);
          *g_quad(i) = x[u];
        }
      }
    }
  } else {
    for (int i = tid; i < rows_here * cols_here; i += kThreads) {
      const int rl = i / cols_here;
      const int j = i - rl * cols_here;
      g[(r0 + rl) * n_cols + c0 + j] +=
          static_cast<float>(cnt[rl * tile_cols + j]);
    }
  }
#ifdef SCATTER_PHASE_STAMPS
  __syncthreads();
#endif
  phase_stamp(4);
}

}  // namespace

#ifdef SCATTER_PHASE_STAMPS
// Copies the phase stamps (kStampBlocks x kStamps nanosecond readings of
// the global timer) to `host`; returns the cudaError_t.
extern "C" int scatter_phase_stamps(void* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_phase_stamps,
                                               sizeof(g_phase_stamps)));
}
#endif

// Plain C entry point for ctypes. g is a contiguous (n_rows, n_cols) f32
// matrix; row_idx and col_idx are contiguous (v_pad, k) int32 matrices,
// possibly the same buffer. The geometry (band_rows, tile_cols, n_bands,
// n_tiles, smem_bytes) is ops/scatter_kernel.py::scatter_plan's, checked
// here against the shape. extent is int32 scratch of v_pad entries and
// mask uint32 scratch of 8 * v_pad, both device memory the caller owns.
// Launches both kernels on `stream` without synchronising; returns the
// first cudaError_t that is not cudaSuccess, of the attribute call and of
// each launch (0 = all succeeded).
extern "C" int scatter_pairs_launch(void* g, const void* row_idx,
                                    const void* col_idx, int64_t v_pad,
                                    int64_t k, int64_t n_rows, int64_t n_cols,
                                    int64_t band_rows, int64_t tile_cols,
                                    int64_t n_bands, int64_t n_tiles,
                                    int64_t smem_bytes, void* extent,
                                    void* mask, void* stream) {
  if (v_pad == 0 || k == 0 || n_rows == 0 || n_cols == 0) {
    return static_cast<int>(cudaSuccess);
  }
  if (band_rows < 1 || tile_cols < 1 ||
      n_bands != (n_rows + band_rows - 1) / band_rows ||
      n_tiles != (n_cols + tile_cols - 1) / tile_cols || n_tiles > 65535 ||
      n_bands > 0x7fffffff || k > 0x7fffffff || v_pad > 0x7fffffff ||
      smem_bytes != kListBytes + band_rows * tile_cols * 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool same = row_idx == col_idx;
  const auto kernel =
      same ? scatter_band_kernel<true> : scatter_band_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t per_block = kExtentThreads / 32;
  variant_extent_kernel<<<static_cast<unsigned int>(
                              (v_pad + per_block - 1) / per_block),
                          kExtentThreads, 0, s>>>(
      static_cast<const int32_t*>(row_idx),
      static_cast<const int32_t*>(col_idx), v_pad, k, n_rows, n_cols,
      static_cast<int>(band_rows), n_bands, static_cast<int32_t*>(extent),
      static_cast<uint32_t*>(mask));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(static_cast<unsigned int>(n_bands),
                static_cast<unsigned int>(n_tiles)),
           kThreads, static_cast<size_t>(smem_bytes), s>>>(
      static_cast<float*>(g), static_cast<const int32_t*>(row_idx),
      static_cast<const int32_t*>(col_idx),
      static_cast<const int32_t*>(extent),
      static_cast<const uint32_t*>(mask), v_pad, static_cast<int>(k),
      n_rows, n_cols, static_cast<int>(band_rows),
      static_cast<int>(tile_cols), n_bands);
  return static_cast<int>(cudaGetLastError());
}
