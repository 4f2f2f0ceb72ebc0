// Error text for the codes the kernels' C entry points return, and the
// device attributes the wrappers read once per device.
#include <cuda_runtime.h>

extern "C" const char* iqt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out[0] = SM count, out[1] = the most dynamic shared memory a block may
// opt in to, out[2] = the shared memory of one SM, all of device `device`
extern "C" int iqt_device_attrs(int device, int* out) {
  cudaError_t err = cudaDeviceGetAttribute(
      &out[0], cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(
      &out[1], cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(
      &out[2], cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
}
