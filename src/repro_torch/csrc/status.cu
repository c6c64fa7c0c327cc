// The name of a CUDA error code, for the Python wrappers' messages.
#include <cuda_runtime.h>

extern "C" const char* synapse_error_string(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}
