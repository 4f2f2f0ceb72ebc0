// Cyclic-prefix correlation of a capture at a set of CP start indices.
//
// Replaces: iqwaveform_tpu/ops/pallas/corr_pallas.py
//   corr_at_indices_pallas (_movsum_norm_kernel).
//
// With z[t] = x[t] conj(x[t + nfft]) and CP rows s + [0, ncp):
//
//   out[j] = sum_s sum_{c < ncp} z[s + c + j] = movsum_ncp(acc)[j],
//   acc[l] = sum_s z[s + l],  l in [0, span), span = n_lags + ncp - 1,
//
// for the lags j in [0, n_lags = nfft + ncp), and the same sums of |a|^2
// and |b|^2 (a = x[t], b = x[t + nfft]) for the normalization. A pair with
// t + nfft >= n contributes zero, as the JAX kernel's zero pad does. The TPU
// kernel takes the moving sum as a matrix product against a banded 0/1
// operator, for its matrix unit; here it is a plain loop over shared
// memory.
//
// Pass 1 (corr_accumulate_kernel): the grid is (tiles of acc positions,
// groups of starts). A thread owns one position l and walks the starts of
// its group, loading x[s + l] and x[s + l + nfft]: neighbouring threads read
// neighbouring words. It keeps the four sums (Re z, Im z, |a|^2, |b|^2) in
// registers and writes them to the partials (n_groups, 4, span). The host
// sorts the starts, so one group covers one stretch of the capture, and the
// tiles of a group (blockIdx.x, launched together) read it while it sits in
// L2.
// Pass 2 (corr_finish_kernel): a block owns a tile of lags. It folds the
// groups' partials of its tile plus the ncp - 1 halo in a fixed order into
// shared memory, takes the ncp-wide moving sum there, and normalizes:
// (re, im) / sqrt(sum|a|^2 sum|b|^2), which is 0/0 = NaN at a lag whose
// pairs all fall past the end, or (re, im) / (n_starts ncp). No float
// atomics: the result is the same on every run. Offsets into the capture
// are 64-bit.
//
// What bounds it on an H100: bytes. The index set of a whole capture
// touches every sample once as a and once as b, and reading it once is 8 B
// a sample: 246 MB for 1 s at 30.72 MS/s, 0.073 ms at 3.35 TB/s. The
// arithmetic, about 12 flop per start and lag, is some 0.4 GFLOP there,
// below that. The design reads each sample from device memory about once:
// the b of one symbol's CP is the a of a later symbol's lags, a group's
// tiles share its stretch of capture through L2, and the partials (a few
// MB) are the only other traffic.
#include "fft.cuh"

namespace {

constexpr int kTileAcc = 256;   // pass 1: acc positions per block
constexpr int kTileLags = 128;  // pass 2: lags per block

__global__ void __launch_bounds__(kTileAcc)
corr_accumulate_kernel(const float2* __restrict__ x,
                       const long long* __restrict__ starts,
                       float* __restrict__ part, long long n, int nfft,
                       int n_starts, int group_size, int span, bool norm) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= span) return;
  const int g = blockIdx.y;
  const int s0 = g * group_size;
  const int s1 = min(s0 + group_size, n_starts);
  const long long limit = n - nfft;  // pairs at t >= limit fall past the end

  float re = 0.f, im = 0.f, pa = 0.f, pb = 0.f;
  for (int i = s0; i < s1; ++i) {
    const long long t = starts[i] + l;
    if (t < limit) {
      const float2 a = x[t];
      const float2 b = x[t + nfft];
      re += a.x * b.x + a.y * b.y;
      im += a.y * b.x - a.x * b.y;
      if (norm) {
        pa += a.x * a.x + a.y * a.y;
        pb += b.x * b.x + b.y * b.y;
      }
    }
  }
  float* p = part + static_cast<long long>(g) * 4 * span;
  p[l] = re;
  p[span + l] = im;
  if (norm) {
    p[2 * span + l] = pa;
    p[3 * span + l] = pb;
  }
}

__global__ void __launch_bounds__(kTileLags)
corr_finish_kernel(const float* __restrict__ part, float2* __restrict__ out,
                   int n_groups, int span, int n_lags, int ncp, bool norm,
                   float scale) {
  extern __shared__ float acc[];
  const int j0 = blockIdx.x * blockDim.x;
  const int width = blockDim.x + ncp - 1;
  const int rows = norm ? 4 : 2;
  for (int k = 0; k < rows; ++k) {
    for (int q = threadIdx.x; q < width; q += blockDim.x) {
      const int l = j0 + q;
      float s = 0.f;
      if (l < span) {
        for (int g = 0; g < n_groups; ++g) {
          s += part[(static_cast<long long>(g) * 4 + k) * span + l];
        }
      }
      acc[k * width + q] = s;
    }
  }
  __syncthreads();

  const int j = j0 + threadIdx.x;
  if (j >= n_lags) return;
  float m[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < rows; ++k) {
    const float* row = acc + k * width + threadIdx.x;
    float s = 0.f;
    for (int c = 0; c < ncp; ++c) s += row[c];
    m[k] = s;
  }
  if (norm) {
    const float d = sqrtf(m[2] * m[3]);
    out[j] = make_float2(m[0] / d, m[1] / d);
  } else {
    out[j] = make_float2(m[0] / scale, m[1] / scale);
  }
}

}  // namespace

// once per device, before the first launch: allow up to `max_smem` bytes
// of dynamic shared memory for pass 2 (4 rows of kTileLags + ncp - 1)
extern "C" int iqt_corr_prepare(int max_smem) {
  return iqt::allow_smem(corr_finish_kernel, max_smem);
}

// x: (n,) complex64; starts: (n_starts,) int64, sorted, non-negative; part:
// (n_groups, 4, span) float32 scratch with n_groups * group_size >=
// n_starts; out: (n_lags,) complex64 with n_lags = nfft + ncp and span =
// n_lags + ncp - 1. scale = n_starts * ncp (the divisor when norm is 0).
extern "C" int iqt_corr(const void* x, const void* starts, void* part,
                        void* out, long long n, int nfft, int ncp,
                        int n_starts, int group_size, int n_groups, int span,
                        int n_lags, int norm, float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto pp = static_cast<float*>(part);
  const dim3 grid1((span + kTileAcc - 1) / kTileAcc, n_groups);
  corr_accumulate_kernel<<<grid1, kTileAcc, 0, s>>>(
      static_cast<const float2*>(x), static_cast<const long long*>(starts),
      pp, n, nfft, n_starts, group_size, span, norm != 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem =
      static_cast<size_t>(norm ? 4 : 2) * (kTileLags + ncp - 1) * sizeof(float);
  corr_finish_kernel<<<(n_lags + kTileLags - 1) / kTileLags, kTileLags, smem,
                       s>>>(pp, static_cast<float2*>(out), n_groups, span,
                            n_lags, ncp, norm != 0, scale);
  return cudaGetLastError();
}
