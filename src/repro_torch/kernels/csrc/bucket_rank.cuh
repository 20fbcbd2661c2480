// Stable bucket rank of a warp's digits, shared by radix_rank.cu's
// radix_scan and radix_apply.
//
// A stable counting sort gives digit i of bucket d the destination
//   (where d starts) + (count of d in earlier tiles) + (count of d earlier
//   in i's tile).
// Both kernels give each warp 1,024 consecutive digits in shared memory and
// rank them in 32 ordered rounds: in round r lane l takes digit 32 r + l, so
// rounds run in digit order and lanes in digit order within a round, which
// keeps the rank stable. A round finds a lane's peers (the lanes of its
// digit) by a shared-memory atomicOr of lane bits into a per-warp,
// per-bucket mask (faster on the H100 than __match_any_sync or one
// __ballot_sync per digit bit, launch/sweep_rank_radix.py): its rank is the
// bucket's per-warp counter plus its peers on lower lanes, and the lowest
// peer then advances the counter and clears the mask. radix_scan starts the
// counters at 0 and adds each bucket's base after a look-back; radix_apply
// starts them at the tile's given offsets.
// Positions past n carry the sentinel bucket B (after every real bucket), as
// the reference pads them; out-of-range digits are read as the sentinel too,
// so shared memory is never indexed out of bounds.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bucket_rank {

constexpr int kTile = 1024;          // digits a warp ranks
constexpr int kMaxBuckets = 512;     // real buckets; one more for the sentinel
constexpr int kWarps = 8;            // warps a block, each ranking kTile

__device__ __forceinline__ int clamp_key(int key, int num_buckets) {
  return static_cast<unsigned>(key) > static_cast<unsigned>(num_buckets)
             ? num_buckets
             : key;
}

// Dynamic shared memory of a block: each warp's kTile digits, and one
// counter and one lane mask per bucket and warp.
constexpr int shared_bytes(int num_buckets) {
  return (kWarps * kTile + 2 * kWarps * (num_buckets + 1)) * 4;
}

// One ordered round (all 32 lanes call, d clamped): the counter of d before
// the round plus the lane's peers on lower lanes. cnt and lanes are the
// warp's own B+1 counters and masks; the masks are zero between rounds.
// Counters wrap mod 2^32.
__device__ __forceinline__ unsigned peer_rank(unsigned* cnt, unsigned* lanes,
                                              int d, int lane) {
  atomicOr(lanes + d, 1u << lane);
  __syncwarp();
  const unsigned peers = lanes[d];
  const unsigned before = cnt[d];
  const unsigned below = __popc(peers & ((1u << lane) - 1u));
  __syncwarp();
  if (below == 0) {
    cnt[d] = before + __popc(peers);
    lanes[d] = 0;
  }
  __syncwarp();
  return before + below;
}

}  // namespace bucket_rank
