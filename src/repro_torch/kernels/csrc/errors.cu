// The text of a CUDA error code, for the Python wrappers' exceptions: every
// entry point of the kernel library returns cudaGetLastError() after its
// launch, and the wrapper raises with this string when that is not 0.
#include <cuda_runtime.h>

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
