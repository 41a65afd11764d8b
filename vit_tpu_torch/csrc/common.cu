// Helpers shared by the kernels' C interface.

#include <cuda_runtime.h>

// Message for an error code returned by one of the launch entries.
extern "C" const char* vit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
