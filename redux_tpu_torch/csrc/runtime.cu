// Error reporting for the ctypes binding.
#include "common.cuh"

RXT_API const char* rxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
