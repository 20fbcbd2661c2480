// The first CUDA form of the sharded range quantile, kept unchanged as the
// baseline variant "warp_v1" of launch/sweep_quantile.py, which builds and
// times it beside the serving kernel (kernels/csrc/wm_quantile.cu). Nothing
// on a serving path calls it.
//
// Global range quantile over S stacked wavelet-matrix shards: the
// count-then-refine descent, every shard and every level in one launch.
//
// Replaces repro/kernels/wm_quantile.py:wm_quantile_sharded_pallas (and, at
// S = 1, wm_quantile_pallas). The Pallas form keeps the whole stacked
// structure resident in VMEM and unrolls shards and levels statically. On
// the H100 the directories (about 0.39 GB at full width) stay in global
// memory, and S and nbits are runtime arguments.
//
// One warp answers one query. The shards are spread over the lanes, shard
// s on lane s % 32, up to kMaxPerLane per lane, with each lane's local
// [lo, hi) in registers. Per level each lane probes rank1 at both ends of
// its non-empty local ranges (an empty range contributes no zeros and stays
// empty, so it is skipped), __shfl_xor_sync sums the zero counts over the
// warp, and the whole warp takes the branch on the global k. A probe reads
// the superblock entry, the block entry and one 16-byte load of the block's
// four words (rows are zero-padded to at least nblocks*4 words, and to a
// multiple of 4, by the wrapper).
//
// Bound on the H100: bytes, as scattered 32-byte sectors; most shards' local
// ranges are empty, and the probes of neighbouring queries share L2 lines.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxPerLane = 8;  // S <= 256

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(0xffffffffu, x, d);
  return x;
}

__device__ __forceinline__ long long clamp_ll(long long x, long long lo,
                                              long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// # of 1 bits before position i of one level row (i in [0, shard size]).
__device__ __forceinline__ int rank1(const int32_t* words_row,
                                     const int32_t* super_row,
                                     const int16_t* block_row, int nblocks,
                                     int i) {
  const int w = i >> 5;
  const int bc = min(w >> 2, nblocks - 1);
  int r = super_row[bc >> 3] + static_cast<uint16_t>(block_row[bc]);
  const int4 q = *reinterpret_cast<const int4*>(words_row + 4 * bc);
  const uint32_t v[4] = {static_cast<uint32_t>(q.x), static_cast<uint32_t>(q.y),
                         static_cast<uint32_t>(q.z), static_cast<uint32_t>(q.w)};
  const uint32_t partial_mask = (1u << (i & 31)) - 1u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int wpos = 4 * bc + j;
    if (wpos < w) r += __popc(v[j]);
    else if (wpos == w) r += __popc(v[j] & partial_mask);
  }
  return r;
}

__global__ void wm_quantile_sharded_kernel(
    const int32_t* __restrict__ q_lo, const int32_t* __restrict__ q_hi,
    const int32_t* __restrict__ q_k, int Q,
    const int32_t* __restrict__ words, long long words_stride,
    const int32_t* __restrict__ superblock, long long super_stride,
    const int16_t* __restrict__ block, long long block_stride,
    const int32_t* __restrict__ zeros, int S, int nbits, int n,
    int shard_bits, int nblocks, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (q >= Q) return;  // uniform across the warp
  const long long size = 1LL << shard_bits;
  const long long glo = clamp_ll(q_lo[q], 0, n);
  const long long ghi = clamp_ll(q_hi[q], glo, n);

  int lo[kMaxPerLane], hi[kMaxPerLane];
  int total = 0;
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    const int s = lane + 32 * j;
    lo[j] = hi[j] = 0;
    if (s < S) {
      const long long base = static_cast<long long>(s) << shard_bits;
      lo[j] = static_cast<int>(clamp_ll(glo - base, 0, size));
      hi[j] = static_cast<int>(clamp_ll(ghi - base, 0, size));
      total += hi[j] - lo[j];
    }
  }
  total = warp_sum(total);
  if (total <= 0) {
    if (lane == 0) out[q] = -1;
    return;
  }
  int k = q_k[q];
  k = k < 0 ? 0 : (k > total - 1 ? total - 1 : k);

  int sym = 0;
  for (int l = 0; l < nbits; ++l) {
    int lo0[kMaxPerLane], hi0[kMaxPerLane];
    int z = 0;
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j) {
      const int s = lane + 32 * j;
      lo0[j] = hi0[j] = 0;
      if (s < S && hi[j] > lo[j]) {
        const long long row = static_cast<long long>(s) * nbits + l;
        const int32_t* wr = words + row * words_stride;
        const int32_t* sr = superblock + row * super_stride;
        const int16_t* br = block + row * block_stride;
        lo0[j] = lo[j] - rank1(wr, sr, br, nblocks, lo[j]);
        hi0[j] = hi[j] - rank1(wr, sr, br, nblocks, hi[j]);
        z += hi0[j] - lo0[j];
      }
    }
    z = warp_sum(z);
    const int bit = k >= z ? 1 : 0;
    sym = (sym << 1) | bit;
    if (bit) k -= z;
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j) {
      const int s = lane + 32 * j;
      if (s < S && hi[j] > lo[j]) {
        const int zl = zeros[static_cast<long long>(s) * nbits + l];
        lo[j] = bit ? zl + (lo[j] - lo0[j]) : lo0[j];
        hi[j] = bit ? zl + (hi[j] - hi0[j]) : hi0[j];
      }
    }
  }
  if (lane == 0) out[q] = sym;
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int wm_quantile_max_shards() { return 32 * kMaxPerLane; }

// lo/hi/k/out: (Q,) int32; words: (S*nbits, words_stride) int32, 16-byte
// aligned rows of at least nblocks*4 words; superblock: (S*nbits,
// super_stride) int32; block: (S*nbits, block_stride) int16; zeros:
// (S*nbits,) int32. Row s*nbits + l holds level l of shard s.
extern "C" int wm_quantile_sharded(const void* lo, const void* hi,
                                   const void* k, int Q, const void* words,
                                   long long words_stride,
                                   const void* superblock,
                                   long long super_stride, const void* block,
                                   long long block_stride, const void* zeros,
                                   int S, int nbits, int n, int shard_bits,
                                   int nblocks, void* out, void* stream) {
  if (S > 32 * kMaxPerLane || nblocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = (Q + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (grid > 0) {
    wm_quantile_sharded_kernel<<<grid, 32 * kWarpsPerBlock, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(lo), static_cast<const int32_t*>(hi),
        static_cast<const int32_t*>(k), Q,
        static_cast<const int32_t*>(words), words_stride,
        static_cast<const int32_t*>(superblock), super_stride,
        static_cast<const int16_t*>(block), block_stride,
        static_cast<const int32_t*>(zeros), S, nbits, n, shard_bits, nblocks,
        static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
