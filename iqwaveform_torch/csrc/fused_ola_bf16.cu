// The frame-batch OLA kernels (csrc/ola_frames.cuh) on (2, n) planes of
// bfloat16: their host launchers, called through the C entries of
// csrc/fused_ola.cu, compiled in a source of their own so that nvcc builds
// the element types in parallel.
#include "ola_frames.cuh"

namespace iqt {
namespace ola {
IQT_FRAMES_INSTANCES(, __nv_bfloat16)
}  // namespace ola
}  // namespace iqt
