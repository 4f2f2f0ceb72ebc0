// A transform split over a thread-block cluster (compute capability 9.0).
//
// A frame too large for one block's shared memory runs on a cluster of C
// blocks that read and write each other's shared memory (distributed
// shared memory). N = C M: each block holds M points in its own padded
// exchange buffer and runs the M-point register-resident passes of
// fft_reg.cuh on them; one radix-C DFT across the cluster joins the C
// parts.
//
// Forward, decimation in frequency (part c is x[c M + n], n < M):
//   X[C k + r] = sum_n W_M^{n k} (W_N^{n r} sum_c W_C^{c r} x[c M + n])
// The radix-C step: the block that owns point n (a contiguous slice of
// about M / C points a block, slice_lo) reads x[c M + n] for every c,
// takes the C-point DFT in registers, and stores output r times the cross
// twiddle W_N^{n r} at n in block r's buffer. Block r's M-point passes
// then leave bins C k + r in its buffer.
// Inverse, decimation in time (block r loads bins C j + r, j < M):
//   y[s M + n] = sum_r W_C^{-r s} (W_N^{-r n} sum_j W_M^{-j n} Z[C j + r])
// Block r's M-point inverse passes, times the cross twiddle, leave v_r[n]
// in its buffer; the block that owns point n reads v_r[n] of every block
// and its C-point inverse DFT gives output samples s M + n.
// Each point of each part is read and written by one block alone in
// either radix-C step: every other block's buffer is touched once a
// point, not C times.
//
// Every access to another block's buffer stands between two barriers of
// the whole cluster (cluster.sync(): arrive with release, wait with
// acquire): one after the writes it reads (at the start: after every
// block has begun), one before the next write to that buffer. A block
// does not exit while others may read its buffer.
//
// The cross twiddles come from the host, built in float64 and rounded
// once to float32 (ops/kernels/fused_ola.py _cluster_tables): C rows of M
// a transform, read from device memory where consecutive threads read
// consecutive entries.
#pragma once

#include <cooperative_groups.h>

#include "fft_reg.cuh"

namespace iqt {
namespace cluster {

namespace cg = cooperative_groups;

// The N-point transform of reg::fft, by a block of T threads, whose pass 0
// ends its loads with `sync_first()` in place of the block's barrier: the
// barrier of the whole cluster where pass 0 reads other blocks' buffers,
// which its stores (and theirs) then overwrite. The passes between and the
// last one run as in reg::fft.
template <int N, bool INV, int T, class First, class Last, class Sync>
__device__ __forceinline__ void fft(float2* buf, const float2* tw, First first, Last last,
                                    Sync sync_first) {
  static_assert(reg::Plan<N>::stages >= 2, "a plan of at least two passes");
  reg::pass_lane<N, 0, INV, T, true>(
      threadIdx.x, tw, [&first](int, int i) { return first(i); },
      [buf](int, int i, float2 v) { buf[reg::pad(i)] = v; }, sync_first);
  __syncthreads();
  reg::middle_passes<N, 1, INV, T>(buf, tw);
  reg::pass<N, reg::Plan<N>::stages - 1, INV, T, true>(
      tw, [buf](int i) { return buf[reg::pad(i)]; }, last);
}

// the slice [lo, hi) of the n points that block `rank` of C owns in a
// radix-C step: contiguous, sizes differing by at most one
__host__ __device__ constexpr int slice_lo(int n, int rank, int c) { return n * rank / c; }

// this block's rank in its cluster and its blockIdx.x, read anew where
// used (asm volatile: ptxas keeps no copy of them live across the passes
// between two uses)
__device__ __forceinline__ int fresh_rank() {
  int rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  return rank;
}

__device__ __forceinline__ int fresh_block_x() {
  int b;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(b));
  return b;
}

// the 32-bit shared::cluster address of `p` (in this block's shared
// memory) in block `rank`'s shared memory, mapped where used: a generic
// pointer from cluster.map_shared_rank takes two registers, and the
// compiler kept such pointers live across the passes between their uses
__device__ __forceinline__ unsigned map_addr(const void* p, int rank) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(a)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))), "r"(rank));
  return a;
}

__device__ __forceinline__ float2 ld_remote(unsigned a) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_remote(unsigned a, float2 v) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};" ::"r"(a), "f"(v.x), "f"(v.y)
               : "memory");
}

// The trim of a frame split over a cluster of two blocks (csrc/ola_frames.cuh
// fused_ola_frames_plan_cluster_kernel), read by the inverse's first pass
// (csrc/fft_plan.cuh, a Load of pass_r) of block `rank`: its point i is
// inverse bin j = 2 i + rank, which reads forward bin k = in_lo + j -
// out_lo where j is in [out_lo, out_hi) and k in [zero_lo, zero_hi), else
// zero. Block r holds forward bins 2 k' + r at k',
// so every such k lies in one block, src = (rank + in_lo - out_lo) mod 2,
// at point i + q of its buffer, and both conditions are one range of i,
// [lo, hi) (cluster_trim): the first pass reads point i + q of block src's
// buffer by its 32-bit shared::cluster address `from` (one register, where
// a generic pointer takes two, in a pass that holds up to 32 points a
// thread).
struct ClusterTrim {
  int lo, hi, q;
  unsigned from;
  __device__ float2 read(const float2*, int i) const {
    float2 v = make_float2(0.f, 0.f);
    if (i >= lo && i < hi) {
      v = ld_remote(from + static_cast<unsigned>(reg::pad(i + q) * sizeof(float2)));
    }
    return v;
  }
};

// ceil(x / 2) of any int (an arithmetic shift)
__device__ __forceinline__ int ceil_half(int x) { return (x + 1) >> 1; }

// the trim of block `rank` of a two-block cluster whose halves are m2
// inverse points, `buf` its exchange buffer (a shared-memory address)
__device__ __forceinline__ ClusterTrim cluster_trim(int zero_lo, int zero_hi, int in_lo,
                                                    int out_lo, int out_hi, int rank, int m2,
                                                    const float2* buf) {
  const int shift = rank + in_lo - out_lo;
  const int src = shift & 1;
  const int lo = max(max(0, ceil_half(out_lo - rank)), ceil_half(zero_lo - shift));
  const int hi = min(min(m2, ceil_half(out_hi - rank)), ceil_half(zero_hi - shift));
  return ClusterTrim{lo, hi, (shift - src) / 2, map_addr(buf, src)};
}

}  // namespace cluster
}  // namespace iqt
