// Error-string lookup for the ctypes wrappers (kernels/build.py).
#include <cuda_runtime.h>

extern "C" const char* ck_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
