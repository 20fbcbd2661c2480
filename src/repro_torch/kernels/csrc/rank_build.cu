// Jacobson rank directories of R packed bit rows, one launch for all rows.
//
// Replaces repro/kernels/rank_build.py:rank_build_levels_pallas (and, at
// R = 1, rank_build_pallas). The Pallas form walks a sequential TPU grid and
// carries the running popcount in SMEM from one step to the next; CUDA
// blocks run in no order, so here one block owns one whole row and loops
// over it in chunks, with the carry in a register.
//
// Per chunk each of the 256 threads owns one 4-word rank block: it sums the
// popcounts of its words, the block takes an exclusive scan of those sums
// (warp shuffles, then one warp over the 8 warp totals), and the thread
// writes its block-relative rank (uint16 pattern in the int16 table) and,
// on every 8th block, the absolute superblock rank. A chunk is 1024 words =
// 32 superblocks, so superblocks never straddle chunks.
//
// Bound on the H100: bytes. Each word is read once (4 B) and 1/8 B + 1/2 B
// of directory is written per word; the popcounts and scans are far below
// the card's integer rate.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockWords = 4;

__global__ void rank_build_levels_kernel(const uint32_t* __restrict__ words,
                                         int W, long long row_stride,
                                         uint32_t* __restrict__ superblock,
                                         int nsb,
                                         uint16_t* __restrict__ block,
                                         int nblk) {
  __shared__ uint32_t warp_incl[kWarps];
  const long long row = blockIdx.x;
  const uint32_t* w = words + row * row_stride;
  uint32_t* sb_out = superblock + row * nsb;
  uint16_t* blk_out = block + row * nblk;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  uint32_t carry = 0;
  for (int base = 0; base < nblk; base += kThreads) {
    const int b = base + threadIdx.x;
    uint32_t c = 0;
#pragma unroll
    for (int j = 0; j < kBlockWords; ++j) {
      const int wi = b * kBlockWords + j;
      if (b < nblk && wi < W) c += __popc(w[wi]);
    }
    // inclusive scan inside the warp
    uint32_t x = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_incl[warp] = x;
    __syncthreads();
    if (warp == 0) {
      uint32_t s = lane < kWarps ? warp_incl[lane] : 0;
#pragma unroll
      for (int d = 1; d < kWarps; d <<= 1) {
        const uint32_t y = __shfl_up_sync(0xffffffffu, s, d);
        if (lane >= d) s += y;
      }
      if (lane < kWarps) warp_incl[lane] = s;
    }
    __syncthreads();
    const uint32_t excl = carry + (warp ? warp_incl[warp - 1] : 0) + x - c;
    // the superblock's first block sits at lane & ~7 of the same warp
    const uint32_t sb_rank = __shfl_sync(0xffffffffu, excl, lane & ~7);
    if (b < nblk) {
      blk_out[b] = static_cast<uint16_t>(excl - sb_rank);
      if ((b & 7) == 0) sb_out[b >> 3] = excl;
    }
    carry += warp_incl[kWarps - 1];
    __syncthreads();  // warp_incl is rewritten by the next chunk
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// words: (rows, row_stride) uint32, the first W words of each row used;
// superblock: (rows, nsb) uint32; block: (rows, nblk) uint16.
extern "C" int rank_build_levels(const void* words, int rows, int W,
                                 long long row_stride, void* superblock,
                                 int nsb, void* block, int nblk,
                                 void* stream) {
  if (rows > 0 && nblk > 0) {
    rank_build_levels_kernel<<<rows, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), W, row_stride,
        static_cast<uint32_t*>(superblock), nsb,
        static_cast<uint16_t*>(block), nblk);
  }
  return static_cast<int>(cudaGetLastError());
}
