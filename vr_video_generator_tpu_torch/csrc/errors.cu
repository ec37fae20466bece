// Error text for the codes the kernel entry points return.

#include <cuda_runtime.h>

extern "C" const char* vrvg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
