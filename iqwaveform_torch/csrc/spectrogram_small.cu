// The persistence spectrogram's frame-group kernels (csrc/spectrogram_group.cuh)
// at 64, 128 and 256 points: their host launchers, called through the C
// entries of csrc/spectrogram.cu, compiled in a source of their own so
// that nvcc builds them beside the 512- and 1024-point instances.
#include "spectrogram_group.cuh"

namespace iqt {
namespace spg {
IQT_SPG_GROUP_INSTANCES(, 64)
IQT_SPG_GROUP_INSTANCES(, 128)
IQT_SPG_GROUP_INSTANCES(, 256)
}  // namespace spg
}  // namespace iqt
