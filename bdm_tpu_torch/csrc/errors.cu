// Error text for the codes the kernel entry points return.
#include "common.cuh"

BDM_EXPORT const char* bdm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
