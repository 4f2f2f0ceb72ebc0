// The frame-batch OLA kernels (csrc/ola_frames.cuh) on interleaved
// complex64 frames: their host launchers, called through the C entries of
// csrc/fused_ola.cu, compiled in a source of their own so that nvcc builds
// the element types (and the 2:1 kernels of csrc/fused_ola.cu) in parallel.
#include "ola_frames.cuh"

namespace iqt {
namespace ola {
IQT_FRAMES_INSTANCES(, float2)
}  // namespace ola
}  // namespace iqt
