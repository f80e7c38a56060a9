// Error text for the status codes the launch functions return.

#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
