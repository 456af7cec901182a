// Codes the kernels' C entry points return beside cudaError_t values.
#pragma once

// A TMA tensor map could not be encoded (cuTensorMapEncodeTiled is missing
// from the driver, or refused the tensor).
constexpr int IMCUI_TENSOR_MAP_ERROR = 0x7000;
