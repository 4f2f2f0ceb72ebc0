// Per-column histogram counts, added into a caller-owned table:
// hist[c, b] += #{t : level(vals[t, c]) == b}.
//
// Replaces: iqwaveform_tpu/ops/pallas/colhist_pallas.py
//   columnwise_histogram_packed_raw (+ unpack_packed_counts), and
//   columnwise_histogram_pallas / columnwise_histogram_packed (through
//   columnwise_histogram_fast). One kernel meets both contracts: int32
//   levels in [0, n_bins) are counted as they are (kFloat = false); float32
//   values are first quantized with the uniform rule the JAX package uses,
//   clip(floor((v - e0) * scale), 0, n_bins - 1) (kFloat = true).
//
// The TPU kernels count as one-hot matrix products into float32 raw tiles,
// a workaround for exact counting on the MXU; here counting is integer, so
// any order of atomic adds gives the same, exact counts.
//
// Design: shared-memory privatized counts. A block owns `cols` adjacent
// columns (cols * n_bins int32 counters in shared memory) and a run of
// `rows` rows. Its threads walk the run with `cols` neighbouring threads on
// neighbouring columns of one row (coalesced reads), add 1 to the column's
// counter with a shared-memory atomic, and at the end add the block's
// nonzero counters into the global table with one atomic each. Enough row
// runs are cut that the grid fills the card; each is long enough that the
// global adds stay a small share of the reads.
//
// What bounds it on an H100: at the persistence design (16384 frames x
// 1024 bins x 1024 levels) it reads 64 MiB of levels and reads and writes
// the 4 MiB table, about 0.022 ms at 3.35 TB/s. Wherever 32 columns of
// 16-bit counters fit a block, colhist_reg_kernel below takes its place.
#include <math.h>

#include "fft.cuh"

namespace {

constexpr int kThreads = 512;

// the level of value j: an int32 level as it is, or a float32 value by the
// uniform rule
template <bool kFloat>
__device__ __forceinline__ int level_at(const void* vals, long long j, int n_bins, float e0,
                                        float scale) {
  if (kFloat) {
    const float v = static_cast<const float*>(vals)[j];
    float q = floorf(__fmul_rn(__fsub_rn(v, e0), scale));
    q = fminf(fmaxf(q, 0.f), static_cast<float>(n_bins - 1));
    return static_cast<int>(q);
  }
  return static_cast<const int*>(vals)[j];
}

template <bool kFloat>
__global__ void __launch_bounds__(kThreads)
colhist_kernel(const void* __restrict__ vals, int* __restrict__ hist,
               int n_rows, int n_cols, int n_bins, int cols, int rows,
               float e0, float scale) {
  extern __shared__ int cnt[];
  const int c0 = blockIdx.x * cols;
  const int nc = min(cols, n_cols - c0);
  const int t0 = blockIdx.y * rows;
  const int t1 = min(t0 + rows, n_rows);

  for (int i = threadIdx.x; i < cols * n_bins; i += blockDim.x) cnt[i] = 0;
  __syncthreads();

  const int col = threadIdx.x % cols;
  const int row_step = blockDim.x / cols;
  if (col < nc) {
    int* c = cnt + col * n_bins;
    for (int t = t0 + threadIdx.x / cols; t < t1; t += row_step) {
      const int b = level_at<kFloat>(vals, static_cast<long long>(t) * n_cols + c0 + col,
                                     n_bins, e0, scale);
      // out-of-range levels break the caller's contract; skip them
      // rather than write outside the column's counters
      if (static_cast<unsigned>(b) >= static_cast<unsigned>(n_bins)) continue;
      atomicAdd(&c[b], 1);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < nc * n_bins; i += blockDim.x) {
    const int v = cnt[i];
    if (v) {
      const int cc = i / n_bins;
      atomicAdd(&hist[static_cast<long long>(c0 + cc) * n_bins + (i - cc * n_bins)], v);
    }
  }
}

// ---- the column-pair counter ----------------------------------------------
//
// Replaces the same TPU kernels as colhist_kernel above, with the same
// contract (int32 levels, or float32 values under the uniform rule), for
// any table whose 32 columns of 16-bit counters fit one block's shared
// memory (n_bins up to 3632 on an H100; ops/kernels/colhist.py
// colhist_route picks before the launch).
//
// A block owns 32 adjacent columns, one a lane, and a run of at most 65535
// rows. Its counters are 16-bit halves of 32-bit words: word (b mod H) *
// 32 + lane holds column lane's count of level b in its low half (b < H)
// or of level b + H in its high half, H = ceil(n_bins / 2). Warp w walks
// rows t0 + w, t0 + w + 32, ...: each step loads one row's 32 columns
// (128 consecutive bytes) for each of kRegUnroll rows before it counts
// them, and adds 1 or 1 << 16 to the level's word with a shared-memory
// atomic. A half never carries into the other, since no count of a run
// exceeds its rows. At the end the block adds each nonzero half into the
// global table with one atomic.
//
// What held colhist_kernel back, and what this one does about it:
// - its counters were column-major (column * n_bins + level), so the bank
//   of an atomic was the level's, random over the hundred or so levels
//   that noise takes: a warp's 32 atomics meet bank conflicts (32 random
//   banks: about 3.5 on the busiest, expected), and lanes on the same
//   column can hit the same counter; here the bank is the lane's own
//   column, so a warp's 32 atomics fall on 32 banks and never on one
//   address;
// - 16 columns of 32-bit counters (64 KiB) a block, so a row was two
//   64-byte pieces a warp; here 32 columns of 16-bit counters in the same
//   64 KiB, one 128-byte row a warp;
// - one int32 load in flight a thread between atomics; here kRegUnroll
//   (16) and 32 warps a block.
// Each block still zeroes and flushes all its counters; the host sizes the
// row runs (ops/kernels/colhist.py _reg_layout): few and long, one block of
// 1024 threads an SM, since every run adds its nonzero counters into the
// table with global atomics.
constexpr int kRegCols = 32;
constexpr int kRegThreads = 1024;
constexpr int kRegWarps = kRegThreads / 32;
constexpr int kRegUnroll = 16;

template <bool kFloat>
__global__ void __launch_bounds__(kRegThreads)
colhist_reg_kernel(const void* __restrict__ vals, int* __restrict__ hist, int n_rows,
                   int n_cols, int n_bins, int rows, float e0, float scale) {
  extern __shared__ unsigned pairs[];
  const int half = (n_bins + 1) >> 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * kRegCols;
  const int col = c0 + lane;
  const int t0 = blockIdx.y * rows;
  const int t1 = min(t0 + rows, n_rows);

  for (int i = threadIdx.x; i < half * kRegCols; i += kRegThreads) pairs[i] = 0u;
  __syncthreads();

  if (col < n_cols) {
    // out-of-range int levels break the caller's contract; skip them
    // rather than write outside the column's counters
    const auto count = [&](int b) {
      if (static_cast<unsigned>(b) < static_cast<unsigned>(n_bins)) {
        const bool hi = b >= half;
        atomicAdd(&pairs[(hi ? b - half : b) * kRegCols + lane], hi ? 0x10000u : 1u);
      }
    };
    int t = t0 + warp;
    for (; t + (kRegUnroll - 1) * kRegWarps < t1; t += kRegUnroll * kRegWarps) {
      int b[kRegUnroll];
#pragma unroll
      for (int u = 0; u < kRegUnroll; ++u)
        b[u] = level_at<kFloat>(vals, static_cast<long long>(t + u * kRegWarps) * n_cols + col,
                                n_bins, e0, scale);
#pragma unroll
      for (int u = 0; u < kRegUnroll; ++u) count(b[u]);
    }
    for (; t < t1; t += kRegWarps)
      count(level_at<kFloat>(vals, static_cast<long long>(t) * n_cols + col, n_bins, e0, scale));
  }
  __syncthreads();

  for (int i = threadIdx.x; i < half * kRegCols; i += kRegThreads) {
    const unsigned v = pairs[i];
    const int c = c0 + (i & (kRegCols - 1));
    if (v == 0u || c >= n_cols) continue;
    int* h = hist + static_cast<long long>(c) * n_bins + i / kRegCols;
    if (v & 0xffffu) atomicAdd(h, static_cast<int>(v & 0xffffu));
    if (v >> 16) atomicAdd(h + half, static_cast<int>(v >> 16));
  }
}

}  // namespace

// once per device, before the first launch: allow up to `max_smem` bytes
// of dynamic shared memory (cols * n_bins counters)
extern "C" int iqt_colhist_prepare(int max_smem) {
  cudaError_t err;
  if ((err = iqt::allow_smem(colhist_kernel<false>, max_smem))) return err;
  if ((err = iqt::allow_smem(colhist_kernel<true>, max_smem))) return err;
  if ((err = iqt::allow_smem(colhist_reg_kernel<false>, max_smem))) return err;
  return iqt::allow_smem(colhist_reg_kernel<true>, max_smem);
}

// vals: (n_rows, n_cols) int32 levels (is_float = 0) or float32 values
// (is_float = 1); hist: (n_cols, n_bins) int32, added into. cols is a power
// of two that divides the block's 512 threads; the grid is
// (ceil(n_cols / cols), ceil(n_rows / rows)).
extern "C" int iqt_colhist(const void* vals, void* hist, int n_rows,
                           int n_cols, int n_bins, int is_float, int cols,
                           int rows, int n_row_blocks, float e0, float scale,
                           void* stream) {
  const dim3 grid((n_cols + cols - 1) / cols, n_row_blocks);
  const size_t smem = static_cast<size_t>(cols) * n_bins * sizeof(int);
  auto s = static_cast<cudaStream_t>(stream);
  auto h = static_cast<int*>(hist);
  if (is_float) {
    colhist_kernel<true><<<grid, kThreads, smem, s>>>(
        vals, h, n_rows, n_cols, n_bins, cols, rows, e0, scale);
  } else {
    colhist_kernel<false><<<grid, kThreads, smem, s>>>(
        vals, h, n_rows, n_cols, n_bins, cols, rows, e0, scale);
  }
  return cudaGetLastError();
}

// the same by colhist_reg_kernel: vals and hist as for iqt_colhist; the
// grid is (ceil(n_cols / 32), n_row_blocks), each block `rows` rows, at
// most 65535 (more: cudaErrorInvalidValue).
extern "C" int iqt_colhist_reg(const void* vals, void* hist, int n_rows, int n_cols,
                               int n_bins, int is_float, int rows, int n_row_blocks, float e0,
                               float scale, void* stream) {
  if (rows > 65535) return cudaErrorInvalidValue;
  const dim3 grid((n_cols + kRegCols - 1) / kRegCols, n_row_blocks);
  const size_t smem = static_cast<size_t>((n_bins + 1) / 2) * kRegCols * sizeof(unsigned);
  auto s = static_cast<cudaStream_t>(stream);
  auto h = static_cast<int*>(hist);
  if (is_float) {
    colhist_reg_kernel<true><<<grid, kRegThreads, smem, s>>>(vals, h, n_rows, n_cols, n_bins,
                                                             rows, e0, scale);
  } else {
    colhist_reg_kernel<false><<<grid, kRegThreads, smem, s>>>(vals, h, n_rows, n_cols, n_bins,
                                                              rows, e0, scale);
  }
  return cudaGetLastError();
}
