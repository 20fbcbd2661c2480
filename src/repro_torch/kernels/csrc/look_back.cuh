// Decoupled look-back (Merrill & Garland, "Single-pass Parallel Prefix Scan
// with Decoupled Look-back", NVIDIA 2016), shared by the single-pass scans:
// the level scans of zero_scan.cuh, rank_build.cu and radix_rank.cu.
//
// A tile of a row publishes a status word as soon as it knows its own count
// (an aggregate), then adds up its predecessors' words back to the nearest
// one that holds an inclusive prefix, and publishes its own inclusive
// prefix. The first tile of a row publishes its prefix at once, so a walk
// never leaves its row. Tile ids come from an atomic counter in launch order
// (not blockIdx), so every predecessor of a tile is already running and a
// walk never waits on a block that has not been scheduled. A word that is
// still zero has not been published yet. The caller zeroes the words.
//
// Two forms:
//   - look_back: one 64-bit word per tile, flag in the top two bits and a
//     62-bit count, written with st.release and read with ld.acquire; warp
//     0 reads the 32 predecessors of a window at once;
//   - look_back_column: one 32-bit word per (tile, column), flag in the top
//     two bits and a 30-bit count; one thread walks one column
//     (radix_rank.cu: a column per bucket).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lookback {

constexpr unsigned kFull = 0xffffffffu;

constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 2ull << 62;
constexpr unsigned long long kCount = kAggregate - 1;

constexpr unsigned kAggregate32 = 1u << 30;
constexpr unsigned kPrefix32 = 2u << 30;
constexpr unsigned kCount32 = kAggregate32 - 1;

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned load_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ long long warp_sum(long long x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(kFull, x, d);
  return x;
}

// The count before tile t in its row (warp 0, all lanes): publish the
// tile's aggregate, walk back to the nearest inclusive prefix, publish the
// tile's own. Lanes read the predecessors t-1-lane of a window at once.
__device__ __forceinline__ long long look_back(unsigned long long* status,
                                               int t, int first, int agg,
                                               int lane) {
  if (t == first) {
    if (lane == 0) store_release(status + t, kPrefix | agg);
    return 0;
  }
  if (lane == 0) store_release(status + t, kAggregate | agg);
  long long excl = 0;
  for (int pos = t - 1;; pos -= 32) {
    const int q = pos - lane;
    unsigned long long v = kPrefix;          // before the row: a zero prefix
    if (q >= first) {
      do {
        v = load_acquire(status + q);
      } while ((v >> 62) == 0);
    }
    const unsigned prefixes = __ballot_sync(kFull, (v >> 62) == 2);
    if (prefixes) {
      const int k = __ffs(prefixes) - 1;     // the nearest inclusive prefix
      excl += warp_sum(lane <= k ? static_cast<long long>(v & kCount) : 0);
      break;
    }
    excl += warp_sum(static_cast<long long>(v & kCount));
  }
  if (lane == 0) store_release(status + t, kPrefix | (excl + agg));
  return excl;
}

// The count before tile t in its row of one column (one thread): word q of
// the column is column[q * stride]. A word carries all it publishes, so the
// loads and stores are relaxed (at gpu scope). Counts and their row sums
// stay below 2^30.
__device__ __forceinline__ int look_back_column(unsigned* column,
                                                long long stride, int t,
                                                int first, int agg) {
  unsigned* mine = column + t * stride;
  if (t == first) {
    store_relaxed(mine, kPrefix32 | static_cast<unsigned>(agg));
    return 0;
  }
  store_relaxed(mine, kAggregate32 | static_cast<unsigned>(agg));
  int excl = 0;
  for (int q = t - 1;; --q) {                // the row's first tile stops it
    unsigned v;
    do {
      v = load_relaxed(column + q * stride);
    } while ((v >> 30) == 0);
    excl += static_cast<int>(v & kCount32);
    if ((v >> 30) == 2) break;
  }
  store_relaxed(mine, kPrefix32 | static_cast<unsigned>(excl + agg));
  return excl;
}

}  // namespace lookback
