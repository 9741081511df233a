// The device's clock as a span mark inside a captured CUDA graph
// (utils/trace.py GraphMarks): one thread writes %globaltimer (ns) into a
// slot of an int64 buffer. A CUDA event cannot be read per replay, a
// kernel's write can be copied after each one.

#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(long long* out, int slot) {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  out[slot] = t;
}

}  // namespace

extern "C" {

// out: int64 device buffer of more than `slot` entries. Returns the
// cudaError_t of the launch.
int ptw_stamp(void* out, int slot, void* stream) {
  if (slot < 0) return (int)cudaErrorInvalidValue;
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((long long*)out, slot);
  return (int)cudaGetLastError();
}

}  // extern "C"
