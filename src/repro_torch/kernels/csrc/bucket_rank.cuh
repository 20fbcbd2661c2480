// Blocked stable bucket rank of radix_rank.cu.
//
// A stable counting sort gives element i the destination
//   base[key_i] + across[tile_i][key_i] + (# j < i in the same tile with
//   key_j == key_i),
// with tiles of kTile = 1024 consecutive keys, base the exclusive scan of the
// bucket totals and across the exclusive scan of the per-tile histograms over
// tiles. Two launches and a torch scan between them, because CUDA blocks run
// in no order (the TPU forms carry these sums through a sequential grid):
//   1. count: one warp per tile writes the tile's histogram
//      (radix_rank.cu, radix_hist_kernel);
//   2. (torch) offsets = base + across for every (tile, bucket), as one
//      exclusive scan over the histograms laid out bucket-major.
//   3. apply: one warp per tile walks it in 32 rounds of 32 keys, in order.
//      Each warp keeps one running counter per bucket in shared memory,
//      seeded with the tile's offsets. In a round, __match_any_sync finds the
//      lanes holding the same key; a lane's destination is the counter plus the
//      number of those peers on lower lanes, and the lowest peer then advances
//      the counter by the peer count. Rounds run in key order and lanes in key
//      order inside a round, so the rank is stable; tiles never share a
//      counter, so no ordering between warps is needed.
// Positions past n carry the sentinel bucket B (after every real bucket), as
// the reference pads them; out-of-range keys are read as the sentinel too, so
// shared memory is never indexed out of bounds.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bucket_rank {

constexpr int kTile = 1024;          // keys per tile
constexpr int kMaxBuckets = 512;     // real buckets; one more for the sentinel
constexpr int kApplyWarps = 8;       // tiles per apply block, one per warp
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int clamp_key(int key, int num_buckets) {
  return static_cast<unsigned>(key) > static_cast<unsigned>(num_buckets)
             ? num_buckets
             : key;
}

// Apply phase: one warp's running per-bucket counters for one tile.
struct TileRanker {
  int* counter;  // nb1 ints of this warp's shared memory

  __device__ __forceinline__ void seed(const int32_t* __restrict__ offsets,
                                       int nb1, int lane) {
    for (int b = lane; b < nb1; b += 32) counter[b] = offsets[b];
    __syncwarp();
  }

  // Destination of this lane's key in the current round (all 32 lanes call).
  __device__ __forceinline__ int rank(int key, int lane) {
    const unsigned peers = __match_any_sync(kFull, key);
    const int d = counter[key] + __popc(peers & ((1u << lane) - 1u));
    __syncwarp();
    if (lane == __ffs(peers) - 1) counter[key] += __popc(peers);
    __syncwarp();
    return d;
  }
};

}  // namespace bucket_rank
