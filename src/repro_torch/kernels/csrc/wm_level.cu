// One wavelet-matrix level over R rows of narrow keys: the level's bit, the
// LSB-first packed bitmap (zero past n), the zero count, and every element's
// destination under the stable 0/1 partition.
//
// Replaces repro/kernels/wm_level.py:wm_level_fused_pallas; its two phases
// also serve the contracts of wm_counts_pallas and wm_apply_pallas. The fused
// Pallas form runs a (2, nblocks) grid in order and carries the block counts
// in VMEM scratch from the count pass to the apply pass. CUDA blocks have no
// order, so the level is two launches with a tiny scan between them:
//   1. wm_counts: zeros per 1024-key block            -> (R, nb) int32
//   2. (torch)    exclusive cumsum of the counts and the row totals
//   3. wm_apply:  destinations and bitmap words, given the offsets
// One thread holds one key; with lane i holding key i of its warp,
// __ballot_sync(bit) is exactly the bitmap word, and
// __popc(~ballot & lanemask_lt) is the number of zeros before the lane.
// Keys past n read as ones (the reference pads with ones): they sort after
// every real key, are never written, and are masked out of the bitmap.
//
// Bound on the H100: bytes. Per key 4 B are read and 4 B of destination plus
// 1/8 B of bitmap written; the count pass reads the keys a second time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 1024;  // keys per CUDA block, one per thread
constexpr int kWarps = kBlock / 32;

__device__ __forceinline__ unsigned level_bit(const int32_t* row, long long i,
                                              int n, int shift) {
  return i < n ? (static_cast<uint32_t>(row[i]) >> shift) & 1u : 1u;
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(0xffffffffu, x, d);
  return x;
}

__global__ void wm_counts_kernel(const int32_t* __restrict__ keys, int n,
                                 long long key_stride, int shift, int nb,
                                 int32_t* __restrict__ counts) {
  __shared__ int warp_zeros[kWarps];
  const long long row = blockIdx.x / nb;
  const int blk = blockIdx.x % nb;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long i = static_cast<long long>(blk) * kBlock + threadIdx.x;
  const unsigned ones =
      __ballot_sync(0xffffffffu, level_bit(keys + row * key_stride, i, n, shift));
  if (lane == 0) warp_zeros[warp] = 32 - __popc(ones);
  __syncthreads();
  if (warp == 0) {
    const int z = warp_sum(warp_zeros[lane]);
    if (lane == 0) counts[row * nb + blk] = z;
  }
}

__global__ void wm_apply_kernel(const int32_t* __restrict__ keys, int n,
                                long long key_stride, int shift, int nb,
                                const int32_t* __restrict__ zeros_excl,
                                const int32_t* __restrict__ total_zeros,
                                int32_t* __restrict__ dest,
                                long long dest_stride,
                                int32_t* __restrict__ bitmap, int W,
                                long long bitmap_stride) {
  __shared__ int warp_excl[kWarps];
  const long long row = blockIdx.x / nb;
  const int blk = blockIdx.x % nb;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long i = static_cast<long long>(blk) * kBlock + threadIdx.x;
  const bool valid = i < n;
  const unsigned bit = level_bit(keys + row * key_stride, i, n, shift);
  const unsigned ones = __ballot_sync(0xffffffffu, bit);
  const unsigned word = __ballot_sync(0xffffffffu, valid && bit);
  const unsigned lanemask_lt = (1u << lane) - 1u;
  const int lane_zeros = __popc(~ones & lanemask_lt);
  if (lane == 0) warp_excl[warp] = 32 - __popc(ones);
  __syncthreads();
  if (warp == 0) {
    const int z = warp_excl[lane];
    int x = z;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    warp_excl[lane] = x - z;
  }
  __syncthreads();
  const int local_zeros = warp_excl[warp] + lane_zeros;  // zeros before key
  const int zb = zeros_excl[row * nb + blk];
  if (valid) {
    const int d = bit == 0u
        ? zb + local_zeros
        : total_zeros[row] + (blk * kBlock - zb)
              + (static_cast<int>(threadIdx.x) - local_zeros);
    dest[row * dest_stride + i] = d;
  }
  const long long w = static_cast<long long>(blk) * kWarps + warp;
  if (lane == 0 && w < W) bitmap[row * bitmap_stride + w] =
      static_cast<int32_t>(word);
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// keys: (rows, key_stride) int32, the first n of each row used;
// counts: (rows, nb) int32 with nb = ceil(n / 1024).
extern "C" int wm_counts(const void* keys, int rows, int n,
                         long long key_stride, int shift, void* counts,
                         int nb, void* stream) {
  const long long grid = static_cast<long long>(rows) * nb;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (grid > 0) {
    wm_counts_kernel<<<static_cast<unsigned>(grid), kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(keys), n, key_stride, shift, nb,
        static_cast<int32_t*>(counts));
  }
  return static_cast<int>(cudaGetLastError());
}

// zeros_excl: (rows, nb) exclusive per-block zero offsets; total_zeros:
// (rows,); dest: (rows, dest_stride) int32; bitmap: (rows, bitmap_stride)
// int32 with W = ceil(n / 32) words written per row.
extern "C" int wm_apply(const void* keys, int rows, int n,
                        long long key_stride, int shift, int nb,
                        const void* zeros_excl, const void* total_zeros,
                        void* dest, long long dest_stride, void* bitmap,
                        int W, long long bitmap_stride, void* stream) {
  const long long grid = static_cast<long long>(rows) * nb;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (grid > 0) {
    wm_apply_kernel<<<static_cast<unsigned>(grid), kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(keys), n, key_stride, shift, nb,
        static_cast<const int32_t*>(zeros_excl),
        static_cast<const int32_t*>(total_zeros),
        static_cast<int32_t*>(dest), dest_stride,
        static_cast<int32_t*>(bitmap), W, bitmap_stride);
  }
  return static_cast<int>(cudaGetLastError());
}
