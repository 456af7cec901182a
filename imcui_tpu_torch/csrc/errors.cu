// Error text for the codes the kernels' C entry points return.

#include <cuda_runtime.h>

#include "errors.cuh"

extern "C" const char* imcui_error_string(int code) {
  if (code == IMCUI_TENSOR_MAP_ERROR)
    return "cuTensorMapEncodeTiled failed to encode a TMA tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
