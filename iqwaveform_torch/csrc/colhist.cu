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
// the 4 MiB table, about 0.022 ms at 3.35 TB/s.
#include <math.h>

#include "fft.cuh"

namespace {

constexpr int kThreads = 512;

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
      const long long j = static_cast<long long>(t) * n_cols + c0 + col;
      int b;
      if (kFloat) {
        const float v = static_cast<const float*>(vals)[j];
        float q = floorf(__fmul_rn(__fsub_rn(v, e0), scale));
        q = fminf(fmaxf(q, 0.f), static_cast<float>(n_bins - 1));
        b = static_cast<int>(q);
      } else {
        b = static_cast<const int*>(vals)[j];
        // out-of-range levels break the caller's contract; skip them
        // rather than write outside the column's counters
        if (static_cast<unsigned>(b) >= static_cast<unsigned>(n_bins)) continue;
      }
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

}  // namespace

// once per device, before the first launch: allow up to `max_smem` bytes
// of dynamic shared memory (cols * n_bins counters)
extern "C" int iqt_colhist_prepare(int max_smem) {
  const cudaError_t err = iqt::allow_smem(colhist_kernel<false>, max_smem);
  if (err != cudaSuccess) return err;
  return iqt::allow_smem(colhist_kernel<true>, max_smem);
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
