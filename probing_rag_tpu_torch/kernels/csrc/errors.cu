// Readable names for the CUDA error codes the C entries return.

#include <cuda_runtime.h>

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
