// C entry shared by the kernel wrappers: the text of a CUDA error code.
#include <cuda_runtime.h>

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
