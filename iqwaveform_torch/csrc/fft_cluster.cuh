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

}  // namespace cluster
}  // namespace iqt
