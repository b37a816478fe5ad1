// Error reporting for the ctypes bindings: the wrappers turn a non-zero
// return code of a launch function into a Python exception with this text.
#include <cuda_runtime.h>

extern "C" const char* avsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
