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
// What bounds it on an H100: at the persistence design (nfft 1024, 2^24
// samples a chunk) it reads 128 MiB of planes and writes 64 MiB of levels
// and 4 MiB of binned power, about 0.061 ms at 3.35 TB/s; the FFT work
// (0.9 GFLOP) would take 0.014 ms at the fp32 peak. spectrogram_kernel is
// bound by neither: it pays one block barrier and a shared-memory round
// trip per radix-2 stage, and reads each frame twice when navg > 0 (the
// second read is served by L1 / L2). At nfft 1024 with navg in {0, 1, 2,
// 4, 8, 16}, the levels and stats modes run spectrogram_levels_reg_kernel
// instead, and at nfft 1024 kDb runs spectrogram_db_reg_kernel (below;
// ops/kernels/spectrogram.py levels_route and db_route pick before the
// launch); every other size keeps spectrogram_kernel.
#include <math.h>

#include "fft.cuh"
#include "fft_reg.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr float kEps = 1e-25f;
constexpr float kDbPerLn = 4.342944819032518f;  // 10 / ln 10

enum Mode { kDb = 0, kLevels = 1, kStats = 2 };

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

// per bin: fold the blocks' partials in a fixed order. A block of 32 warps
// owns 32 bins (one per lane); warp w folds partials w, w + 32, w + 64, ...
// and warp 0 then folds the 32 warps' results in warp order.
constexpr int kReduceWarps = 32;

__global__ void __launch_bounds__(kReduceWarps * 32)
spectrogram_reduce_kernel(const float* __restrict__ part,
                          float* __restrict__ psum, float* __restrict__ pmax,
                          float* __restrict__ pmin, int n_blocks, int nfft) {
  __shared__ float ws[kReduceWarps][32], wx[kReduceWarps][32],
      wn[kReduceWarps][32];
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

// ---- the levels and stats modes at nfft 1024 ---------------------------
//
// Replaces the same TPU kernel as spectrogram_kernel<PT, kLevels / kStats>
// above, with the same contract and rounding, at nfft = 1024 (BASELINE
// config #3) and navg in {0, 1, 2, 4, 8, 16}.
//
// A block of kLvGroups groups of 64 threads walks a run of frames; group g
// takes frames f0 + g, f0 + g + kLvGroups, ... and syncs on its own named
// barrier (bar.sync 1 + g, 64). Per frame the three register-resident
// passes of csrc/fft_reg.cuh's 16.16.4 plan run through the group's padded
// exchange buffer (Stockham passes, twiddles from the 336-entry forward
// table of ops/kernels/fused_ola.py reg_forward_twiddles, copied into
// shared memory once per block), with four group barriers a frame:
// - pass 0 loads x[t + 64 r] (r < 16) times the window, coalesced, and
//   keeps |x|^2 of those 16 samples; the navg samples of one detector bin
//   sit in navg adjacent lanes at one r, so a transposing shuffle
//   reduction (lanes exchange half their sums per step, 16 - 16 / navg
//   shuffles a lane) leaves each lane the sums of 16 / navg bins, which it
//   writes as means: no second read of the frame;
// - the last pass (radix 4) leaves lane t bins t + 64 i + 256 r (i, r <
//   4), the same 16 bins every frame, so dB, the level store (a warp's
//   stores are 32 consecutive int32) and the bins' statistics stay with
//   the lane across the run: the sums in registers, the max and min in
//   the group's slice of shared memory (slot-major, conflict-free), which
//   keeps the kernel within 128 registers without spilling; the group's
//   barrier after the pass frees the exchange buffer for the next frame.
// At the end the groups' statistics fold in group order into the block's
// partials, and spectrogram_reduce_kernel folds the blocks as before: the
// same fixed order in kLevels and kStats, so their statistics are
// bit-equal.
//
// What held spectrogram_kernel<2, kLevels> back at this size, and what
// this one does about it: ten radix-2 stages, each a block-wide barrier
// and a shared-memory round trip (here three radix-16 / 16 / 4 passes in
// registers and four 64-thread barriers); a bit-reversed scatter of the
// windowed frame (here pass 0 reads it in natural order); a second,
// serial read of the frame for the binned power (here shuffles of the
// samples pass 0 holds); 512 threads holding 2 bins each.
constexpr int kLvN = 1024;
constexpr int kLvT = 64;         // threads of a frame group
constexpr int kLvGroups = 4;     // frame groups of a block
constexpr int kLvThreads = kLvT * kLvGroups;
constexpr int kLvBins = 16;      // bins of one lane
// float2 units: the groups' exchange buffers, the table, then per group
// the max and min of its lanes' bins (2 x 16 x 64 floats)
constexpr int kLvTable = kLvGroups * iqt::reg::padded_size(kLvN);
constexpr int kLvExtremes = kLvTable + iqt::reg::table_total<kLvN>();
constexpr size_t kLvSmem =
    static_cast<size_t>(kLvExtremes + kLvGroups * kLvBins * kLvT) * sizeof(float2);
static_assert(kLvBins * kLvT <= 2 * kLvTable, "the groups' sums fold through the exchange buffers");

// one frame of the 16.16.4 plan by lane `lane` of a 64-thread group whose
// exchange buffer is `buf` and barrier `sync`: pass 0 loads x[base + i]
// times the window (with NAVG > 0 it also bins |x|^2 into `pbin`, the
// frame's N / NAVG means), and the last pass hands each of the lane's 16
// bins to emit(slot, k, dB), slot = 4 i + r of bin k = lane + 64 i + 256 r.
// The group's barrier after the last pass frees buf for the next frame.
template <int NAVG, class Sync, class Emit>
__device__ __forceinline__ void reg_frame_dB(const float* __restrict__ xr,
                                             const float* __restrict__ xi, int stride,
                                             const float2* __restrict__ w, const float2* tws,
                                             float2* buf, int lane, long long base,
                                             float* __restrict__ pbin, Sync sync, Emit emit) {
  namespace R = iqt::reg;
  constexpr int N = kLvN;
  constexpr int T = kLvT;
  float pw[kLvBins];
  R::pass_lane<N, 0, false, T, false>(
      lane, tws,
      [&](int slot, int i) {
        const long long j = (base + i) * stride;
        const float a = xr[j];
        const float b = xi[j];
        if constexpr (NAVG > 0) pw[slot] = a * a + b * b;
        return iqt::cmul(make_float2(a, b), __ldg(&w[i]));
      },
      [buf](int, int i, float2 v) { buf[R::pad(i)] = v; }, sync);
  if constexpr (NAVG > 0) R::bin_power<NAVG, T>(pw, lane, pbin);
  sync();
  R::pass_lane<N, 1, false, T, true>(
      lane, tws, [buf](int, int i) { return buf[R::pad(i)]; },
      [buf](int, int i, float2 v) { buf[R::pad(i)] = v; }, sync);
  sync();
  R::pass_lane<N, 2, false, T, false>(
      lane, tws, [buf](int, int i) { return buf[R::pad(i)]; },
      [&](int slot, int k, float2 v) {
        const float p = __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y));
        emit(slot, k, __fmul_rn(kDbPerLn, logf(p + kEps)));
      },
      sync);
  sync();
}

template <int MODE, int NAVG>
__global__ void __launch_bounds__(kLvThreads, 2)
spectrogram_levels_reg_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                              int stride, const float2* __restrict__ w,
                              const float2* __restrict__ tw, int* __restrict__ levels,
                              float* __restrict__ part, float* __restrict__ pbin, int n_frames,
                              int n_bins, int frames_per_block, float e0, float scale) {
  namespace R = iqt::reg;
  constexpr int N = kLvN;
  constexpr int T = kLvT;
  extern __shared__ float2 smem[];
  const int group = threadIdx.x / T;
  const int lane = threadIdx.x % T;
  float2* buf = smem + group * R::padded_size(N);
  float2* tws = smem + kLvTable;
  // slot q of this lane: max at ext[q T + lane], min at ext[(16 + q) T + lane]
  float* const ext0 = reinterpret_cast<float*>(smem + kLvExtremes);
  float* ext = ext0 + group * 2 * kLvBins * T + lane;
  for (int e = threadIdx.x; e < R::table_total<N>(); e += kLvThreads) tws[e] = __ldg(&tw[e]);
  const auto sync = [group] {
    asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(T) : "memory");
  };

  float sm[kLvBins];
#pragma unroll
  for (int q = 0; q < kLvBins; ++q) {
    sm[q] = 0.f;
    ext[q * T] = -INFINITY;
    ext[(kLvBins + q) * T] = INFINITY;
  }
  __syncthreads();

  const int f0 = blockIdx.x * frames_per_block;
  const int f1 = min(f0 + frames_per_block, n_frames);
  for (int f = f0 + group; f < f1; f += kLvGroups) {
    const long long base = static_cast<long long>(f) * N;
    float* frame_pbin = nullptr;
    if constexpr (NAVG > 0) frame_pbin = pbin + static_cast<long long>(f) * (N / NAVG);
    reg_frame_dB<NAVG>(
        xr, xi, stride, w, tws, buf, lane, base, frame_pbin, sync,
        [&](int slot, int k, float d) {
          if (MODE == kLevels) {
            float q = floorf(__fmul_rn(__fsub_rn(d, e0), scale));
            q = fminf(fmaxf(q, 0.f), static_cast<float>(n_bins - 1));
            levels[base + k] = static_cast<int>(q);
          }
          sm[slot] += d;
          ext[slot * T] = fmaxf(ext[slot * T], d);
          ext[(kLvBins + slot) * T] = fminf(ext[(kLvBins + slot) * T], d);
        });
  }

  // fold groups 1, 2, ... into group 0 in order: the sums through the
  // exchange buffers, which every group has left once all reach the
  // barrier, the extremes where they lie
  float* fold = reinterpret_cast<float*>(smem) + lane;
  for (int g = 1; g < kLvGroups; ++g) {
    __syncthreads();
    if (group == g) {
#pragma unroll
      for (int q = 0; q < kLvBins; ++q) fold[q * T] = sm[q];
    }
    __syncthreads();
    if (group == 0) {
      const float* other = ext0 + g * 2 * kLvBins * T + lane;
#pragma unroll
      for (int q = 0; q < kLvBins; ++q) {
        sm[q] += fold[q * T];
        ext[q * T] = fmaxf(ext[q * T], other[q * T]);
        ext[(kLvBins + q) * T] = fminf(ext[(kLvBins + q) * T], other[(kLvBins + q) * T]);
      }
    }
  }
  if (group == 0) {
    const long long plane = static_cast<long long>(gridDim.x) * N;
    float* pb = part + static_cast<long long>(blockIdx.x) * N;
#pragma unroll
    for (int q = 0; q < kLvBins; ++q) {
      const int k = lane + T * (q / 4) + 4 * T * (q % 4);  // slot q = 4 i + r
      pb[k] = sm[q];
      pb[plane + k] = ext[q * T];
      pb[2 * plane + k] = ext[(kLvBins + q) * T];
    }
  }
}

// ---- the dB mode at nfft 1024 -----------------------------------------
//
// Replaces the same TPU kernel as spectrogram_kernel<PT, kDb>
// (spectrogram_dB_pallas), with the same contract and rounding, at nfft =
// 1024: the frames of the levels kernel above (frame groups of 64 threads
// on their own barriers, the 16.16.4 passes through reg_frame_dB), with
// the dB value stored where the last pass leaves it. Lane t holds bins
// t + 64 i + 256 r, so a warp's stores of one slot are 32 consecutive
// float32. It keeps no statistics, writes no partials and bins no power,
// and no reduce kernel follows. Bound on an H100: 128 MiB of planes in and
// 64 MiB of dB out a 2^24-sample chunk, about 0.060 ms at 3.35 TB/s; it
// replaces the radix-2 body's ten block-wide barriers and shared-memory
// round trips a frame, its bit-reversed scatter, and its 512 threads of
// 2 bins each.
constexpr size_t kDbSmem = static_cast<size_t>(kLvExtremes) * sizeof(float2);

__global__ void __launch_bounds__(kLvThreads, 2)
spectrogram_db_reg_kernel(const float* __restrict__ xr, const float* __restrict__ xi, int stride,
                          const float2* __restrict__ w, const float2* __restrict__ tw,
                          float* __restrict__ db, int n_frames, int frames_per_block) {
  namespace R = iqt::reg;
  constexpr int N = kLvN;
  constexpr int T = kLvT;
  extern __shared__ float2 smem[];
  const int group = threadIdx.x / T;
  const int lane = threadIdx.x % T;
  float2* buf = smem + group * R::padded_size(N);
  float2* tws = smem + kLvTable;
  for (int e = threadIdx.x; e < R::table_total<N>(); e += kLvThreads) tws[e] = __ldg(&tw[e]);
  const auto sync = [group] {
    asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(T) : "memory");
  };
  __syncthreads();

  const int f0 = blockIdx.x * frames_per_block;
  const int f1 = min(f0 + frames_per_block, n_frames);
  for (int f = f0 + group; f < f1; f += kLvGroups) {
    float* out = db + static_cast<long long>(f) * N;
    reg_frame_dB<0>(xr, xi, stride, w, tws, buf, lane, static_cast<long long>(f) * N, nullptr,
                    sync, [out](int, int k, float d) { out[k] = d; });
  }
}

template <int MODE>
cudaError_t allow_levels_reg() {
  cudaError_t err;
  if ((err = iqt::allow_smem(spectrogram_levels_reg_kernel<MODE, 0>, kLvSmem))) return err;
  if ((err = iqt::allow_smem(spectrogram_levels_reg_kernel<MODE, 1>, kLvSmem))) return err;
  if ((err = iqt::allow_smem(spectrogram_levels_reg_kernel<MODE, 2>, kLvSmem))) return err;
  if ((err = iqt::allow_smem(spectrogram_levels_reg_kernel<MODE, 4>, kLvSmem))) return err;
  if ((err = iqt::allow_smem(spectrogram_levels_reg_kernel<MODE, 8>, kLvSmem))) return err;
  return iqt::allow_smem(spectrogram_levels_reg_kernel<MODE, 16>, kLvSmem);
}

template <int MODE>
cudaError_t launch_levels_reg(int navg, int n_blocks, cudaStream_t s, const float* xr,
                              const float* xi, int stride, const float2* w, const float2* tw,
                              int* levels, float* part, float* pbin, int n_frames, int n_bins,
                              int frames_per_block, float e0, float scale) {
#define IQT_LV(A)                                                                          \
  case A:                                                                                  \
    spectrogram_levels_reg_kernel<MODE, A><<<n_blocks, kLvThreads, kLvSmem, s>>>(          \
        xr, xi, stride, w, tw, levels, part, pbin, n_frames, n_bins, frames_per_block, e0, \
        scale);                                                                            \
    break;
  switch (navg) {
    IQT_LV(0)
    IQT_LV(1)
    IQT_LV(2)
    IQT_LV(4)
    IQT_LV(8)
    IQT_LV(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef IQT_LV
  return cudaGetLastError();
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
// of dynamic shared memory (one frame, nfft * 8 bytes)
extern "C" int iqt_spectrogram_prepare(int max_smem) {
  cudaError_t err;
  if ((err = allow_mode<kDb>(max_smem))) return err;
  if ((err = allow_mode<kLevels>(max_smem))) return err;
  if ((err = allow_mode<kStats>(max_smem))) return err;
  if ((err = allow_levels_reg<kLevels>())) return err;
  if ((err = allow_levels_reg<kStats>())) return err;
  return iqt::allow_smem(spectrogram_db_reg_kernel, kDbSmem);
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
  spectrogram_reduce_kernel<<<nfft / 32, kReduceWarps * 32, 0, s>>>(
      pp, static_cast<float*>(psum), static_cast<float*>(pmax),
      static_cast<float*>(pmin), n_blocks, nfft);
  return cudaGetLastError();
}

// the levels (mode 1) or stats (mode 2) mode at nfft = 1024 by
// spectrogram_levels_reg_kernel: arguments as for iqt_spectrogram, with tw
// the n_tw entries of 1024's forward tables (ops/kernels/fused_ola.py
// reg_forward_twiddles) and navg in {0, 1, 2, 4, 8, 16}. Another nfft,
// mode, navg or table length: cudaErrorInvalidValue.
extern "C" int iqt_spectrogram_levels_reg(const void* xr, const void* xi, const void* w,
                                          const void* tw, void* levels, void* part, void* psum,
                                          void* pmax, void* pmin, void* pbin, int n_tw,
                                          int stride, int n_frames, int nfft, int mode,
                                          int n_bins, int navg, int frames_per_block,
                                          int n_blocks, float e0, float scale, void* stream) {
  if (nfft != kLvN || n_tw != iqt::reg::table_total<kLvN>()) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto xrp = static_cast<const float*>(xr);
  auto xip = static_cast<const float*>(xi);
  auto wp = static_cast<const float2*>(w);
  auto tp = static_cast<const float2*>(tw);
  auto lp = static_cast<int*>(levels);
  auto pp = static_cast<float*>(part);
  auto bp = static_cast<float*>(pbin);
  cudaError_t err;
  if (mode == kLevels)
    err = launch_levels_reg<kLevels>(navg, n_blocks, s, xrp, xip, stride, wp, tp, lp, pp, bp,
                                     n_frames, n_bins, frames_per_block, e0, scale);
  else if (mode == kStats)
    err = launch_levels_reg<kStats>(navg, n_blocks, s, xrp, xip, stride, wp, tp, lp, pp, bp,
                                    n_frames, n_bins, frames_per_block, e0, scale);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  spectrogram_reduce_kernel<<<nfft / 32, kReduceWarps * 32, 0, s>>>(
      pp, static_cast<float*>(psum), static_cast<float*>(pmax), static_cast<float*>(pmin),
      n_blocks, nfft);
  return cudaGetLastError();
}

// the dB mode at nfft = 1024 by spectrogram_db_reg_kernel: arguments as for
// iqt_spectrogram, with tw the n_tw entries of 1024's forward tables
// (ops/kernels/fused_ola.py reg_forward_twiddles). Another nfft or table
// length: cudaErrorInvalidValue.
extern "C" int iqt_spectrogram_db_reg(const void* xr, const void* xi, const void* w,
                                      const void* tw, void* db, int n_tw, int stride,
                                      int n_frames, int nfft, int frames_per_block,
                                      int n_blocks, void* stream) {
  if (nfft != kLvN || n_tw != iqt::reg::table_total<kLvN>()) return cudaErrorInvalidValue;
  spectrogram_db_reg_kernel<<<n_blocks, kLvThreads, kDbSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi), stride,
      static_cast<const float2*>(w), static_cast<const float2*>(tw), static_cast<float*>(db),
      n_frames, frames_per_block);
  return cudaGetLastError();
}
