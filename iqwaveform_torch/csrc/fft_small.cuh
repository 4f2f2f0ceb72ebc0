// Small frames (64-1024 points) in frame groups: the shared device code of
// the persistence spectrogram's group kernels (csrc/spectrogram_group.cuh)
// and the channelizer's small-frame kernel (csrc/chan_small.cu).
//
// A frame of N points runs on a group of T = N / 16 lanes (4 at 64 points,
// 32 at 512, 64 at 1024), several groups a block of kThreads threads, on
// csrc/fft_reg.cuh's compile-time plan of N (64 = 16.4, 128 = 16.8, 256 =
// 16.16, 512 = 16.16.2, 1024 = 16.16.4): one radix-16 butterfly a lane in
// pass 0, 16 points a lane in every pass. A group syncs on its own
// barrier, never the block's: __syncwarp where the group lies in one warp
// (N <= 512), a named barrier of its 64 threads at 1024. Groups that share
// a warp take their frames in rounds of the whole block (every lane of the
// warp runs every round; a group past the run's last frame loads zeros and
// stores nothing), so that their shuffles and __syncwarp see the whole
// warp.
//
// Per frame (group_frame): pass 0 loads sample i = lane + T r (r < 16) of
// the frame, in natural order and coalesced, times the window, and keeps
// |x|^2 of its 16 samples; bin_group sums those into the detector-binned
// power by shuffles (no second read of the frame); the passes run through
// the group's padded exchange buffer; the last hands each of the lane's 16
// outputs to the caller's emit(slot, k, Y_k), bin k = slot_bin<N>(lane,
// slot): the same 16 bins every frame, so a lane's running statistics of
// its bins stay with it (tests/test_torch_fft_small.py models the passes,
// the binning and the bin map in float64).
#pragma once

#include "fft_reg.cuh"

namespace iqt {
namespace small {

constexpr int kThreads = 256;  // threads of a block
constexpr int kSlots = 16;     // points a lane holds in each pass

// the frame group of N points: its lanes, the groups of a block and the
// last pass's radix
template <int N>
struct Group {
  static constexpr int T = N / kSlots;
  static constexpr int G = kThreads / T;
  static constexpr int last_radix = reg::Plan<N>::radix(reg::Plan<N>::stages - 1);
  static_assert(reg::Plan<N>::radix(0) == 16 && T >= 4 && T <= 64 && kThreads % T == 0,
                "pass 0 is one radix-16 butterfly a lane");
};

// the bin of slot q of `lane` after the last pass: q = i R + r of its
// butterfly b = lane + T i, whose output r is bin b + (N / R) r
template <int N>
__host__ __device__ constexpr int slot_bin(int lane, int q) {
  constexpr int R = Group<N>::last_radix;
  return lane + Group<N>::T * (q / R) + (N / R) * (q % R);
}

// the group's barrier; `group` is its index in the block
template <int T>
__device__ __forceinline__ void group_sync(int group) {
  if constexpr (T > 32) {
    asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(T) : "memory");
  } else {
    __syncwarp();
  }
}

// the group's frames of a block's run [f0, f1): f0 + group, f0 + group +
// G, ...; fn(f, live) for each. Groups below a warp run rounds of the
// whole block (a group past f1 is not live), the others stop at their last
// frame.
template <int N, class Fn>
__device__ __forceinline__ void group_frames(int group, int f0, int f1, Fn fn) {
  constexpr int G = Group<N>::G;
  if constexpr (Group<N>::T >= 32) {
    for (int f = f0 + group; f < f1; f += G) fn(f, true);
  } else {
    for (int r = f0; r < f1; r += G) fn(r + group, r + group < f1);
  }
}

__host__ __device__ constexpr int ilog2(int n) { return n > 1 ? 1 + ilog2(n / 2) : 0; }

// The shape of the binning of NAVG consecutive samples by T lanes, each
// holding pw[r] = |x|^2 of sample lane + T r (r < 16): a detector bin spans
// C rows (C = NAVG / T where NAVG > T, else 1) of L lanes (the whole group
// where NAVG > T, else NAVG adjacent lanes), LW of them in one warp. A lane
// first sums its own rows by runs of C (V values left), then the L lanes
// reduce by xor shuffles over offsets LW / 2, ..., 1: the first TS steps
// transpose (each halves the values a lane holds and hands the other half
// to its partner), the rest add. A lane is then left KEEP sums, of values
// u = first + j (first below), and RUN adjacent lanes hold the same sums;
// where L = 64 (NAVG >= 64 at 1024 points) the two warps' sums meet in
// shared memory.
template <int NAVG, int T>
struct BinShape {
  static constexpr int C = NAVG > T ? NAVG / T : 1;
  static constexpr int V = kSlots / C;
  static constexpr int L = NAVG > T ? T : NAVG;
  static constexpr int LW = L < 32 ? L : 32;
  static constexpr int TS = ilog2(V < LW ? V : LW);
  static constexpr int KEEP = V >> TS;
  static constexpr int RUN = LW > V ? LW / V : 1;
  static_assert((NAVG & (NAVG - 1)) == 0 && NAVG >= 1 && NAVG <= 16 * T && C <= kSlots,
                "NAVG a power of two that divides the frame");

  // the first value index of `lane`'s sums, and whether it writes them
  __host__ __device__ static constexpr int first(int lane) {
    return ((lane & (LW - 1)) / RUN) * KEEP;
  }
  __host__ __device__ static constexpr bool writer(int lane) { return (lane & (RUN - 1)) == 0; }
  // the detector bin of value u of `lane` (a row where C = 1, a run of C
  // rows of every lane else)
  __host__ __device__ static constexpr int bin(int lane, int u) {
    return C > 1 ? u : lane / NAVG + (T / NAVG) * u;
  }
};

// The detector-binned power of one frame from pass 0's |x|^2 (see
// BinShape): out[q] = the mean of samples q NAVG .. q NAVG + NAVG - 1, a
// fixed order of sums. `live` false: the group is past its last frame and
// writes nothing (its lanes still shuffle). At L = 64 warp 1 leaves its
// sums in `xw` (KEEP = 1; 8 or 16 floats of the group's own) and warp 0
// adds them after a group barrier.
template <int NAVG, int T, class Sync>
__device__ __forceinline__ void bin_group(const float (&pw)[kSlots], int lane, bool live,
                                          float* out, float* xw, Sync sync) {
  using B = BinShape<NAVG, T>;
  float v[B::V];
#pragma unroll
  for (int u = 0; u < B::V; ++u) {
    v[u] = pw[u * B::C];
#pragma unroll
    for (int c = 1; c < B::C; ++c) v[u] += pw[u * B::C + c];
  }
#pragma unroll
  for (int step = 0; step < ilog2(B::LW); ++step) {
    const int o = (B::LW / 2) >> step;
    if (step < B::TS) {
      const int n = (B::V / 2) >> step;
      const bool hi = (lane & o) != 0;
#pragma unroll
      for (int j = 0; j < n; ++j) {
        const float send = hi ? v[j] : v[j + n];
        const float keep = hi ? v[j + n] : v[j];
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    }
  }
  const int u0 = B::first(lane);
  if constexpr (B::L > 32) {
    const bool upper = lane >= 32;
    if (upper && B::writer(lane)) xw[u0] = v[0];
    sync();
    if (upper) return;
    v[0] += xw[u0];
  }
  if (!live || !B::writer(lane)) return;
#pragma unroll
  for (int j = 0; j < B::KEEP; ++j)
    out[B::bin(lane, u0 + j)] = v[j] / static_cast<float>(NAVG);
}

// passes S .. stages - 2 of N's forward plan through the group's padded
// exchange buffer, a group barrier after each
template <int N, int S, class Sync>
__device__ __forceinline__ void group_middle(int lane, const float2* tws, float2* buf, Sync sync) {
  if constexpr (S < reg::Plan<N>::stages - 1) {
    reg::pass_lane<N, S, false, Group<N>::T, true>(
        lane, tws, [buf](int, int i) { return buf[reg::pad(i)]; },
        [buf](int, int i, float2 v) { buf[reg::pad(i)] = v; }, sync);
    sync();
    group_middle<N, S + 1>(lane, tws, buf, sync);
  }
}

// One frame by lane `lane` of its group: sample i comes from load(i)
// (complex, unwindowed; not called where `live` is false, which reads
// zeros), times w[i]; with NAVG > 0 its detector-binned power goes to
// `pbin` (the frame's N / NAVG means; xw the group's scratch of bin_group);
// the last pass hands each of the lane's 16 outputs to emit(slot, k, Y_k)
// once its loads have all finished (the group's barrier), so emit may
// write over `buf`. The caller syncs the group before `buf` is written
// again.
template <int N, int NAVG, class Load, class Sync, class Emit>
__device__ __forceinline__ void group_frame(int lane, bool live, const float2* tws, float2* buf,
                                            const float2* __restrict__ w, Load load,
                                            float* __restrict__ pbin, float* xw, Sync sync,
                                            Emit emit) {
  constexpr int T = Group<N>::T;
  float pw[kSlots];
  reg::pass_lane<N, 0, false, T, false>(
      lane, tws,
      [&](int slot, int i) {
        const float2 x = live ? load(i) : make_float2(0.f, 0.f);
        if constexpr (NAVG > 0) pw[slot] = x.x * x.x + x.y * x.y;
        return cmul(x, __ldg(&w[i]));
      },
      [buf](int, int i, float2 v) { buf[reg::pad(i)] = v; }, sync);
  if constexpr (NAVG > 0) bin_group<NAVG, T>(pw, lane, live, pbin, xw, sync);
  sync();
  group_middle<N, 1>(lane, tws, buf, sync);
  reg::pass_lane<N, reg::Plan<N>::stages - 1, false, T, true>(
      lane, tws, [buf](int, int i) { return buf[reg::pad(i)]; }, emit, sync);
}

}  // namespace small
}  // namespace iqt
