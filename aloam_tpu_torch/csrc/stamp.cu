// One thread writes the device's global nanosecond timer (%globaltimer)
// into buf[slot]: the start or the end of a span (aloam_tpu_torch/spans.py).
// Launched on the stream between a stage's operations, it runs once the
// operation before it has finished; under a CUDA graph capture each launch
// becomes a kernel node of the graph, with its slot fixed in the node.

#include <cuda_runtime.h>

__global__ void aloam_stamp_kernel(long long* buf, int slot) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  buf[slot] = static_cast<long long>(t);
}

extern "C" int aloam_stamp(long long* buf, int slot, void* stream) {
  aloam_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(buf,
                                                                     slot);
  return static_cast<int>(cudaGetLastError());
}
