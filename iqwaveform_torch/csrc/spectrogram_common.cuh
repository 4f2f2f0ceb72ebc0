// What the persistence spectrogram's kernels share (csrc/spectrogram.cu,
// spectrogram_group.cuh, spectrogram_block.cu): the modes, the dB and level
// rounding, the arguments of a launch, and the fixed-order fold of the
// blocks' statistics partials.
#pragma once

#include <math.h>

#include <cuda_runtime.h>

namespace iqt {
namespace spg {

constexpr float kEps = 1e-25f;
constexpr float kDbPerLn = 4.342944819032518f;  // 10 / ln 10

enum Mode { kDb = 0, kLevels = 1, kStats = 2 };

// dB = 10 / ln 10 * ln(|Y|^2 + 1e-25), rounded as the plain version rounds
// it (__fmul_rn / __fadd_rn keep nvcc from contracting into an FMA)
__device__ __forceinline__ float to_dB(float2 v) {
  const float p = __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y));
  return __fmul_rn(kDbPerLn, logf(p + kEps));
}

// the uniform histogram level clip(floor((dB - e0) scale), 0, n_bins - 1)
__device__ __forceinline__ int to_level(float d, float e0, float scale, int n_bins) {
  float q = floorf(__fmul_rn(__fsub_rn(d, e0), scale));
  q = fminf(fmaxf(q, 0.f), static_cast<float>(n_bins - 1));
  return static_cast<int>(q);
}

// sample i of the frames: complex64 (stride 2: xr the interleaved pairs)
// or (2, n) float32 planes (stride 1)
__device__ __forceinline__ float2 sample(const float* __restrict__ xr,
                                         const float* __restrict__ xi, int stride, long long i) {
  if (stride == 2) return reinterpret_cast<const float2*>(xr)[i];
  return make_float2(xr[i], xi[i]);
}

// One launch: the frames' samples (xr, xi, stride), the window w (nfft,)
// and the pass tables tw; the dB frames (kDb), the levels (kLevels) and the
// statistics partials part (3, n_blocks, nfft) of the other modes; pbin
// the binned power (navg > 0); e0, scale, n_bins the histogram rule.
struct Args {
  const float* xr;
  const float* xi;
  int stride;
  const float2* w;
  const float2* tw;
  float* db;
  int* levels;
  float* part;
  float* pbin;
  int n_frames;
  int n_bins;
  int navg;
  int frames_per_block;
  int n_blocks;
  float e0;
  float scale;
  cudaStream_t stream;
};

}  // namespace spg
}  // namespace iqt

// the fold of the blocks' partials, in the translation unit's own
// anonymous namespace (a kernel defined in a header and launched from
// several sources; an anonymous namespace nested in iqt::spg would make
// nvcc's launch stubs ambiguous where a source uses iqt::spg)
namespace {

// per bin: fold the blocks' partials in a fixed order. A block of 32 warps
// owns 32 bins (one per lane); warp w folds partials w, w + 32, w + 64, ...
// and warp 0 then folds the 32 warps' results in warp order.
constexpr int kReduceWarps = 32;

__global__ void __launch_bounds__(kReduceWarps * 32)
spectrogram_reduce_kernel(const float* __restrict__ part, float* __restrict__ psum,
                          float* __restrict__ pmax, float* __restrict__ pmin, int n_blocks,
                          int nfft) {
  __shared__ float ws[kReduceWarps][32], wx[kReduceWarps][32], wn[kReduceWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = blockIdx.x * 32 + lane;  // nfft is a multiple of 32
  const long long plane = static_cast<long long>(n_blocks) * nfft;
  float s = 0.f;
  float mx = -INFINITY;
  float mn = INFINITY;
  for (int b = warp; b < n_blocks; b += kReduceWarps) {
    const long long i = static_cast<long long>(b) * nfft + k;
    s += part[i];
    mx = fmaxf(mx, part[plane + i]);
    mn = fminf(mn, part[2 * plane + i]);
  }
  ws[warp][lane] = s;
  wx[warp][lane] = mx;
  wn[warp][lane] = mn;
  __syncthreads();
  if (warp != 0) return;
  s = 0.f;
  mx = -INFINITY;
  mn = INFINITY;
  for (int w = 0; w < kReduceWarps; ++w) {
    s += ws[w][lane];
    mx = fmaxf(mx, wx[w][lane]);
    mn = fminf(mn, wn[w][lane]);
  }
  psum[k] = s;
  pmax[k] = mx;
  pmin[k] = mn;
}

inline cudaError_t launch_reduce(const float* part, void* psum, void* pmax, void* pmin,
                                 int n_blocks, int nfft, cudaStream_t s) {
  spectrogram_reduce_kernel<<<nfft / 32, kReduceWarps * 32, 0, s>>>(
      part, static_cast<float*>(psum), static_cast<float*>(pmax), static_cast<float*>(pmin),
      n_blocks, nfft);
  return cudaGetLastError();
}

}  // namespace
