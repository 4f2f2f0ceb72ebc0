// The 2:1 overlap-add of frames the frame-batch kernels wrote: the second
// half of the port's 2:1 route at the pairs the older 2:1 kernels of
// csrc/fused_ola.cu are not compiled for (ops/kernels/fused_ola.py
// ola_route '<frame route>+add').
//
// Replaces: the overlap-add and the tail of iqwaveform_tpu/ops/pallas/
//   fused_ola_pallas.py fused_ola_strided (_fused_ola_strided_kernel),
//   whose first block writes frame 0's first half alone and every later
//   block adds the previous frame's second half to its own first half.
//
// Input: y (batch, F, nfft_out) complex64, frame f of row b the output of
// the OLA chain of input frame f (one of the frame kernels of
// csrc/ola_frames.cuh or csrc/ola_split.cu, which read the frames straight
// from the row at hop_in and the samples past its end from its halo). With
// h = nfft_out / 2 = hop_out:
//   out[b, f h + s] = y[b, f, s] + y[b, f - 1, h + s]   (f >= 1, s < h)
//   out[b, s]       = y[b, 0, s]                          (f = 0)
//   tail[b, s]      = y[b, F - 1, h + s]                  (where asked for)
// One thread an output sample, plain stores, each address written once, the
// sum of each pair in that fixed order: the result does not depend on the
// order in which blocks run (and, with two terms, equals any other order's).
//
// Bound on an H100 (device memory): it reads F nfft_out and writes F h (+ h)
// complex64 a row, 24 bytes an output sample: 0.06 ms at 3.35 TB/s for the
// 2^23 output samples of a 2^24-sample step at 2:1 resampling. A later
// change may fold the add into the frame kernels' last store (as
// fused_ola_reg_kernel does with atomics) and save the frames' round trip
// through device memory.
#include <cuda_runtime.h>

namespace {

constexpr int kAddThreads = 256;

__global__ void __launch_bounds__(kAddThreads)
ola_add_kernel(const float2* __restrict__ y, float2* __restrict__ out, float2* __restrict__ tail,
               int n_frames, int h) {
  const long long o = static_cast<long long>(blockIdx.x) * kAddThreads + threadIdx.x;
  const long long n_out = static_cast<long long>(n_frames) * h;
  const long long row = blockIdx.y;
  const float2* yr = y + row * n_frames * 2 * h;
  if (o < n_out) {
    const int f = static_cast<int>(o / h);
    const int s = static_cast<int>(o - static_cast<long long>(f) * h);
    float2 v = __ldg(&yr[static_cast<long long>(f) * 2 * h + s]);
    if (f > 0) {
      const float2 w = __ldg(&yr[static_cast<long long>(f - 1) * 2 * h + h + s]);
      v = make_float2(v.x + w.x, v.y + w.y);
    }
    out[row * n_out + o] = v;
  } else if (tail != nullptr && o < n_out + h) {
    const int s = static_cast<int>(o - n_out);
    tail[row * h + s] = __ldg(&yr[static_cast<long long>(n_frames - 1) * 2 * h + h + s]);
  }
}

}  // namespace

// y: (batch, n_frames, 2 h) complex64, contiguous; out: (batch, n_frames h)
// complex64; tail: (batch, h) complex64, or nullptr to form none. Sizes the
// grid cannot hold: cudaErrorInvalidValue, before the launch.
extern "C" int iqt_ola_add(const void* y, void* out, void* tail, int batch, int n_frames, int h,
                           void* stream) {
  if (batch < 1 || batch >= (1 << 16) || n_frames < 1 || h < 1) return cudaErrorInvalidValue;
  const long long n_row = static_cast<long long>(n_frames) * h + (tail != nullptr ? h : 0);
  const long long blocks = (n_row + kAddThreads - 1) / kAddThreads;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  ola_add_kernel<<<dim3(static_cast<unsigned>(blocks), batch), kAddThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(y), static_cast<float2*>(out), static_cast<float2*>(tail),
      n_frames, h);
  return cudaGetLastError();
}
