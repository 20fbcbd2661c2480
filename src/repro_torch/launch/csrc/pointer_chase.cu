// Dependent-load latency of the card: one thread follows a chain of indices
// through a buffer, each load's address the value of the one before, so no
// two loads overlap. Over a buffer far larger than the 50 MB L2 laid out as
// one random cycle of 128-byte slots, each step is a DRAM round trip (TLB
// misses included, as a probe of a large structure meets them); over a
// buffer that fits in L2, after a warm pass, an L2 round trip. Loads go
// through L2 only (ld.global.cg), as a probe's first touch of a line does.
// Used by launch/sweep_quantile.py and chip_smoke.py for the quantile
// kernel's latency floor; not a port of any TPU kernel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void chase_kernel(const int32_t* __restrict__ next, int start,
                             int steps, int32_t* __restrict__ out) {
  int p = start;
  for (int i = 0; i < steps; ++i) p = __ldcg(next + p);
  *out = p;
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// next: a buffer of int32 indices into itself; out: one int32.
extern "C" int pointer_chase(const void* next, int start, int steps,
                             void* out, void* stream) {
  chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(next), start, steps,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
