// Spectrogram of non-overlapping frames in dB, and the fused persistence
// fold: dB -> histogram levels, per-bin sum / max / min of dB, and the
// detector-binned power of the raw samples.
//
// Replaces: iqwaveform_tpu/ops/pallas/spectrogram_pallas.py
//   spectrogram_dB_pallas (mode kDb) and spectrogram_levels_pallas
//   (modes kLevels and kStats, its edges_dB=None variant).
//
// Each block walks a run of `frames_per_block` frames of nfft samples. For
// each frame it
//   - with navg > 0, writes the mean of |x|^2 over each navg consecutive
//     samples, in time order;
//   - multiplies the frame by the window (the design window / nfft with
//     the fftshift delay baked in) and runs the nfft-point FFT in shared
//     memory; bins come out in natural (centred) order, not in the TPU
//     kernel's factored (k1, k2) order;
//   - forms dB = 10 / ln 10 * ln(|Y|^2 + 1e-25);
//   - kDb: writes dB; kLevels: writes the level clip(floor((dB - e0) *
//     scale), 0, n_bins - 1) and keeps per-bin running sum, max and min of
//     dB in registers; kStats: keeps the running statistics only.
// The block writes its statistics to partials (3, n_blocks, nfft), and
// spectrogram_reduce_kernel folds them over blocks in a fixed order, so the
// sums are the same on every run (no float atomics).
//
// The sample (re, im) of frame position j is xr[j * stride], xi[j * stride]:
// complex64 input is (p, p + 1, stride 2), (2, n) float32 planes are
// (plane 0, plane 1, stride 1).
//
// The dB value and the level are rounded as the plain version rounds them
// (__fmul_rn / __fsub_rn keep nvcc from contracting them into an FMA), so a
// level differs from the plain version's only where the two FFTs put dB on
// different sides of a bin edge.
//
// What bounds it on an H100: one read of the frames (8 bytes a sample) and
// the write of dB or the levels (4 bytes a sample); at 2^24 samples 0.060
// ms at 3.35 TB/s; the FFT work (5 log2 nfft flop a sample) is below that.
// spectrogram_kernel is bound by neither: it pays one block barrier and a
// shared-memory round trip per radix-2 stage, and reads each frame twice
// when navg > 0 (the second read is served by L1 / L2). It is the route
// only at an apd_navg above 128 (a power of two up to nfft, which the JAX
// levels kernel does not take) and a yardstick (ops/kernels/spectrogram.py
// _spectrogram_dB_generic, _spectrogram_levels_generic): at nfft 64-1024
// the frame-group kernels of csrc/spectrogram_group.cuh run every mode
// (spectrogram_levels_reg_kernel, spectrogram_db_reg_kernel; 64-256
// compiled in csrc/spectrogram_small.cu), at 2048-16384 the block kernel
// of csrc/spectrogram_block.cu (ops/kernels/spectrogram.py levels_route
// and db_route pick before the launch).
#include <math.h>

#include "fft.cuh"
#include "spectrogram_group.cuh"

namespace iqt {
namespace spg {
IQT_SPG_GROUP_INSTANCES(extern, 64)
IQT_SPG_GROUP_INSTANCES(extern, 128)
IQT_SPG_GROUP_INSTANCES(extern, 256)
IQT_SPG_GROUP_INSTANCES(, 512)
IQT_SPG_GROUP_INSTANCES(, 1024)
}  // namespace spg
}  // namespace iqt

namespace {

using namespace iqt::spg;

constexpr int kMaxThreads = 512;

// PT = bins per thread (nfft / blockDim.x)
template <int PT, int MODE>
__global__ void __launch_bounds__(kMaxThreads)
spectrogram_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                   int stride, const float2* __restrict__ w,
                   const float2* __restrict__ tw, float* __restrict__ db,
                   int* __restrict__ levels, float* __restrict__ part,
                   float* __restrict__ pbin, int n_frames, int log2_nfft,
                   int n_bins, int navg, int frames_per_block, float e0,
                   float scale) {
  extern __shared__ float2 buf[];
  const int nfft = 1 << log2_nfft;

  float sm[PT], mx[PT], mn[PT];
#pragma unroll
  for (int r = 0; r < PT; ++r) {
    sm[r] = 0.f;
    mx[r] = -INFINITY;
    mn[r] = INFINITY;
  }

  const int f0 = blockIdx.x * frames_per_block;
  const int f1 = min(f0 + frames_per_block, n_frames);
  for (int f = f0; f < f1; ++f) {
    const long long base = static_cast<long long>(f) * nfft;
    if (navg > 0) {
      const int per_frame = nfft / navg;
      for (int t = threadIdx.x; t < per_frame; t += blockDim.x) {
        float s = 0.f;
        for (int i = 0; i < navg; ++i) {
          const long long j = (base + t * navg + i) * stride;
          const float a = xr[j];
          const float b = xi[j];
          s += a * a + b * b;
        }
        pbin[static_cast<long long>(f) * per_frame + t] = s / navg;
      }
    }
    for (int n = threadIdx.x; n < nfft; n += blockDim.x) {
      const long long j = (base + n) * stride;
      buf[iqt::bitrev(n, log2_nfft)] =
          iqt::cmul(make_float2(xr[j], xi[j]), w[n]);
    }
    iqt::fft_radix2(buf, tw, log2_nfft, false);

#pragma unroll
    for (int r = 0; r < PT; ++r) {
      const int k = threadIdx.x + r * blockDim.x;
      const float2 v = buf[k];
      const float p = __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y));
      const float d = __fmul_rn(kDbPerLn, logf(p + kEps));
      if (MODE == kDb) {
        db[base + k] = d;
      } else {
        if (MODE == kLevels) {
          float q = floorf(__fmul_rn(__fsub_rn(d, e0), scale));
          q = fminf(fmaxf(q, 0.f), static_cast<float>(n_bins - 1));
          levels[base + k] = static_cast<int>(q);
        }
        sm[r] += d;
        mx[r] = fmaxf(mx[r], d);
        mn[r] = fminf(mn[r], d);
      }
    }
    __syncthreads();  // the next frame overwrites buf
  }

  if (MODE != kDb) {
    const long long plane = static_cast<long long>(gridDim.x) * nfft;
    const long long o = static_cast<long long>(blockIdx.x) * nfft;
#pragma unroll
    for (int r = 0; r < PT; ++r) {
      const int k = threadIdx.x + r * blockDim.x;
      part[o + k] = sm[r];
      part[plane + o + k] = mx[r];
      part[2 * plane + o + k] = mn[r];
    }
  }
}

template <int PT, int MODE>
cudaError_t launch(int n_blocks, int threads, size_t smem, cudaStream_t s,
                   const float* xr, const float* xi, int stride,
                   const float2* w, const float2* tw, float* db, int* levels,
                   float* part, float* pbin, int n_frames, int log2_nfft,
                   int n_bins, int navg, int frames_per_block, float e0,
                   float scale) {
  spectrogram_kernel<PT, MODE><<<n_blocks, threads, smem, s>>>(
      xr, xi, stride, w, tw, db, levels, part, pbin, n_frames, log2_nfft,
      n_bins, navg, frames_per_block, e0, scale);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t allow_mode(int max_smem) {
  cudaError_t err;
  if ((err = iqt::allow_smem(spectrogram_kernel<2, MODE>, max_smem))) return err;
  if ((err = iqt::allow_smem(spectrogram_kernel<4, MODE>, max_smem))) return err;
  if ((err = iqt::allow_smem(spectrogram_kernel<8, MODE>, max_smem))) return err;
  if ((err = iqt::allow_smem(spectrogram_kernel<16, MODE>, max_smem))) return err;
  return iqt::allow_smem(spectrogram_kernel<32, MODE>, max_smem);
}

}  // namespace

// once per device, before the first launch: allow up to `max_smem` bytes
// of dynamic shared memory to the radix-2 body (one frame, nfft * 8
// bytes), and each frame-group instance its own
extern "C" int iqt_spectrogram_prepare(int max_smem) {
  cudaError_t err;
  if ((err = allow_mode<kDb>(max_smem))) return err;
  if ((err = allow_mode<kLevels>(max_smem))) return err;
  if ((err = allow_mode<kStats>(max_smem))) return err;
#define IQT_PREPARE(N) \
  if ((err = group_prepare<N>())) return err;
  IQT_SPG_GROUP_SIZES(IQT_PREPARE)
#undef IQT_PREPARE
  return cudaSuccess;
}

// xr / xi: the frames' samples at element stride `stride`, n_frames * nfft
// of them; w: (nfft,) complex64 window / nfft; tw: the FFT's twiddles.
// kDb writes db (n_frames, nfft). kLevels writes levels (n_frames, nfft)
// int32 and, like kStats, psum / pmax / pmin (nfft,) through the scratch
// part (3, n_blocks, nfft). navg > 0 (not in kDb) writes pbin (n_frames *
// nfft / navg). nfft = 2^log2_nfft in [64, 16384]; navg divides nfft;
// n_blocks = ceil(n_frames / frames_per_block).
extern "C" int iqt_spectrogram(const void* xr, const void* xi, const void* w,
                               const void* tw, void* db, void* levels,
                               void* part, void* psum, void* pmax, void* pmin,
                               void* pbin, int stride, int n_frames,
                               int log2_nfft, int mode, int n_bins, int navg,
                               int frames_per_block, int n_blocks, float e0,
                               float scale, void* stream) {
  const int nfft = 1 << log2_nfft;
  const int threads = nfft / 2 < kMaxThreads ? nfft / 2 : kMaxThreads;
  const int pt = nfft / threads;
  const size_t smem = static_cast<size_t>(nfft) * sizeof(float2);
  auto s = static_cast<cudaStream_t>(stream);
  auto xrp = static_cast<const float*>(xr);
  auto xip = static_cast<const float*>(xi);
  auto wp = static_cast<const float2*>(w);
  auto tp = static_cast<const float2*>(tw);
  auto dp = static_cast<float*>(db);
  auto lp = static_cast<int*>(levels);
  auto pp = static_cast<float*>(part);
  auto bp = static_cast<float*>(pbin);
  cudaError_t err;
#define IQT_SPG(P, M)                                                        \
  case P:                                                                    \
    err = launch<P, M>(n_blocks, threads, smem, s, xrp, xip, stride, wp, tp, \
                       dp, lp, pp, bp, n_frames, log2_nfft, n_bins, navg,    \
                       frames_per_block, e0, scale);                         \
    break;
#define IQT_SPG_MODE(M)     \
  switch (pt) {             \
    IQT_SPG(2, M)           \
    IQT_SPG(4, M)           \
    IQT_SPG(8, M)           \
    IQT_SPG(16, M)          \
    IQT_SPG(32, M)          \
    default:                \
      return cudaErrorInvalidValue; \
  }
  switch (mode) {
    case kDb:
      IQT_SPG_MODE(kDb)
      break;
    case kLevels:
      IQT_SPG_MODE(kLevels)
      break;
    case kStats:
      IQT_SPG_MODE(kStats)
      break;
    default:
      return cudaErrorInvalidValue;
  }
#undef IQT_SPG_MODE
#undef IQT_SPG
  if (err != cudaSuccess || mode == kDb) return err;
  return launch_reduce(pp, psum, pmax, pmin, n_blocks, nfft, s);
}

namespace {

// the arguments of a frame-group launch; false where nfft is no size of
// the group kernels or tw is not its table
bool group_args(Args& a, const void* xr, const void* xi, const void* w, const void* tw,
                void* db, void* levels, void* part, void* pbin, int n_tw, int stride,
                int n_frames, int nfft, int n_bins, int navg, int frames_per_block, int n_blocks,
                float e0, float scale, void* stream) {
  bool known = false;
#define IQT_KNOWN(N) known = known || (nfft == N && n_tw == iqt::reg::table_total<N>());
  IQT_SPG_GROUP_SIZES(IQT_KNOWN)
#undef IQT_KNOWN
  a = Args{static_cast<const float*>(xr), static_cast<const float*>(xi), stride,
           static_cast<const float2*>(w), static_cast<const float2*>(tw),
           static_cast<float*>(db), static_cast<int*>(levels), static_cast<float*>(part),
           static_cast<float*>(pbin), n_frames, n_bins, navg, frames_per_block, n_blocks, e0,
           scale, static_cast<cudaStream_t>(stream)};
  return known;
}

}  // namespace

// the levels (mode 1) or stats (mode 2) mode at nfft 64-1024 by
// spectrogram_levels_reg_kernel<nfft, navg> and spectrogram_reduce_kernel:
// arguments as for iqt_spectrogram, with tw the n_tw entries of nfft's
// forward pass tables (ops/kernels/fused_ola.py _reg_pass_tables) and navg
// 0 or a power of two up to 128 that divides nfft. Another nfft, mode,
// navg or table length: cudaErrorInvalidValue.
extern "C" int iqt_spectrogram_levels_reg(const void* xr, const void* xi, const void* w,
                                          const void* tw, void* levels, void* part, void* psum,
                                          void* pmax, void* pmin, void* pbin, int n_tw,
                                          int stride, int n_frames, int nfft, int mode,
                                          int n_bins, int navg, int frames_per_block,
                                          int n_blocks, float e0, float scale, void* stream) {
  Args a;
  if (!group_args(a, xr, xi, w, tw, nullptr, mode == kLevels ? levels : nullptr, part, pbin,
                  n_tw, stride, n_frames, nfft, n_bins, navg, frames_per_block, n_blocks, e0,
                  scale, stream) ||
      (mode != kLevels && mode != kStats))
    return cudaErrorInvalidValue;
#define IQT_LEVELS(N) \
  if (nfft == N) return group_levels<N>(a, psum, pmax, pmin);
  IQT_SPG_GROUP_SIZES(IQT_LEVELS)
#undef IQT_LEVELS
  return cudaErrorInvalidValue;
}

// the dB mode at nfft 64-1024 by spectrogram_db_reg_kernel<nfft>:
// arguments as for iqt_spectrogram_levels_reg. Another nfft or table
// length: cudaErrorInvalidValue.
extern "C" int iqt_spectrogram_db_reg(const void* xr, const void* xi, const void* w,
                                      const void* tw, void* db, int n_tw, int stride,
                                      int n_frames, int nfft, int frames_per_block,
                                      int n_blocks, void* stream) {
  Args a;
  if (!group_args(a, xr, xi, w, tw, db, nullptr, nullptr, nullptr, n_tw, stride, n_frames, nfft,
                  1, 0, frames_per_block, n_blocks, 0.f, 1.f, stream))
    return cudaErrorInvalidValue;
#define IQT_DB(N) \
  if (nfft == N) return group_db<N>(a);
  IQT_SPG_GROUP_SIZES(IQT_DB)
#undef IQT_DB
  return cudaErrorInvalidValue;
}
