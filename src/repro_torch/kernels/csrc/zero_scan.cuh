// Single-pass stable 0/1 partition of key rows: a zero scan with decoupled
// look-back (Merrill & Garland, "Single-pass Parallel Prefix Scan with
// Decoupled Look-back", NVIDIA 2016), shared by wm_level.cu and wt_level.cu.
// wm_level.cu's wm_apply uses its warp half alone (load4, ballot_slabs,
// slab_word, store4): a warp's keys there are one block with a known base.
//
// One launch places every key of a wavelet level. The destination of key i
// needs Z(i), the zeros before i in its row, and per-node constants that
// the caller already knows (the bases are permutation-invariant):
//   zin     = Z(i) - zs                 zeros before i inside i's node
//   dest(i) = s0 + zin                  if bit(i) == 0
//           = s1 + (i - s0) - zin       if bit(i) == 1
// s0 and s1 are where the node's 0s and 1s start in the level's output, zs
// the zeros of all earlier nodes. A matrix level is one node per row
// (s0 = 0, s1 = the row's total zeros, zs = 0); a tree level looks the node
// up in a per-row table of <= kMaxNodes nodes (s0 | s1 | zs) in shared
// memory. Nodes are contiguous segments of the row (node ids are
// non-decreasing), so this is the stable sort by (node << 1) | bit.
//
// Tiles of kTile = 8192 keys of one row, one per block of 256 threads:
//   - tile ids come from an atomic counter in launch order, not blockIdx,
//     so every predecessor of a tile is already running: the look-back
//     never waits on a block that has not been scheduled;
//   - each warp owns 1024 consecutive keys in eight slabs of 128; lane l
//     loads keys 4l..4l+3 of a slab with one 16-byte load, so a thread has
//     eight such loads in flight per array (keys, node ids);
//   - __ballot_sync of key c of every lane of a slab gives bit l of
//     ballot[c] = bit of key 4l + c; the in-warp zero counts come from
//     popcounts of those ballots, and bitmap word w of the slab (keys
//     32w..32w+31, lanes 8w..8w+7) interleaves byte w of the four ballots,
//     so the bitmap is written as whole words, zero past n; after the
//     ballots a thread keeps its keys only as 32 level bits and its node
//     ids as bytes, which frees the registers of the loads;
//   - the tile publishes its zero count in its 64-bit status word, flag in
//     the top two bits (aggregate, then inclusive prefix), written with
//     st.release and read with ld.acquire; warp 0 walks back over windows
//     of 32 predecessors until it finds an inclusive prefix, which the
//     row's first tile always publishes at once, so rows never share a sum
//     and a row of up to 2^31 keys cannot reach the flag bits
//     (look_back.cuh);
//   - the other warps write the bitmap words while warp 0 looks back; then
//     every thread stores its 32 destinations as eight 16-byte stores.
// Move mode (kMove, a matrix level only): the level applies its own stable
// partition, and no destination reaches device memory. Each warp stages its
// 1,024 keys in its 4 KB slice of shared memory (32 KB a block), a slab at a
// time as soon as the slab's ballots give the keys' in-warp ranks: a zero at
// its rank among the warp's zeros from the slice's start, a one at its rank
// among the warp's ones from the slice's end, backwards, so that no key
// waits for the warp's total and a slab's keys die with its ballots, as in
// the dest mode. After the look-back the warp's zeros are one run of the
// output from Z(warp_base) on, its ones one run from s1 + warp_base -
// Z(warp_base) on, and lane j of each of 32 rounds stores key j of the
// warp's runs: 128 consecutive bytes a store, split only where the zeros
// end. It serves the same Pallas kernel, repro/kernels/wm_level.py:132
// wm_level_fused_pallas, whose level returns destinations that the build
// then applies with a scatter.
// The tile shape is the fastest of a sweep of (threads, loads per thread)
// on the H100 (launch/sweep_level_scan.py): larger tiles spread the fixed
// chain of a block (tile id, loads, look-back, stores) over more keys,
// until the registers that hold the loads in flight cut the resident
// blocks per SM.
// Keys past n read as ones (the reference pads with ones): they are never
// written and their bitmap bits are 0. The caller zeroes the status words
// and the tile counter; the kernel allocates nothing.
//
// Bound on the H100: bytes. Per key 4 B of key (and 4 B of node id for a
// tree level) in, 4 B of destination (in move mode: of moved key) and 1/8 B
// of bitmap out.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "look_back.cuh"

namespace zero_scan {

using lookback::kFull;
using lookback::look_back;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlabs = 8;                    // 16-byte loads per thread
constexpr int kWarpKeys = kSlabs * 128;
constexpr int kTile = kWarps * kWarpKeys;    // 8192 keys per tile
constexpr int kMaxNodes = 256;
struct Params {
  const int32_t* keys;
  long long key_stride;
  int n, shift, tiles_per_row;
  // tree level: node ids and the per-row node table (s0 | s1 | zs)
  const int32_t* nid;
  long long nid_stride;
  const int32_t* table;
  int nodes;
  // matrix level: the rows' total zeros, and the zeros the scan counted
  const int32_t* total_zeros;
  long long total_stride;
  int32_t* zeros_out;
  int32_t* dest;                 // move mode: the moved keys
  long long dest_stride;
  int32_t* bitmap;
  long long bitmap_stride;
  int W;
  unsigned long long* status;    // one word per tile, zeroed
  unsigned int* next_tile;       // zeroed
};

// Keys i..i+3 of a row (pad past n): one 16-byte load where all four are
// real and the row is 16-byte aligned.
template <bool kVec>
__device__ __forceinline__ void load4(const int32_t* __restrict__ row,
                                      int i, int n, int pad, int (&v)[4]) {
  if (kVec && i + 3 < n) {
    const int4 x = *reinterpret_cast<const int4*>(row + i);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = i + c < n ? row[i + c] : pad;
  }
}

template <bool kVec>
__device__ __forceinline__ void store4(int32_t* __restrict__ row, int i,
                                       int n, const int (&v)[4]) {
  if (kVec && i + 3 < n) {
    *reinterpret_cast<int4*>(row + i) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (i + c < n) row[i + c] = v[c];
  }
}

// Bit k of an 8-bit x moved to bit 4k.
__device__ __forceinline__ unsigned spread4(unsigned x) {
  x = (x | (x << 12)) & 0x000F000Fu;
  x = (x | (x << 6)) & 0x03030303u;
  return (x | (x << 3)) & 0x11111111u;
}

// The ballots of a warp's kSlabs slabs of 128 keys, lane l holding keys
// 4l..4l+3 of slab s in key[s]: ballot c of a slab has bit l set where key
// 4l + c is a one. A lane keeps its keys only as their level bits. With
// kStage (move mode) it also stages each slab's keys in the warp's slice
// `stage`: key i of the warp with z zeros before it at z if a zero, at
// kWarpKeys - 1 - (i - z) if a one. Keys past n are ones, the warp's last,
// so they take the ones' last places, nearest the zeros.
struct Ballots {
  unsigned bits[(kSlabs + 7) / 8];     // bit 4 (s % 8) + c of bits[s / 8]
  int zb[kSlabs];                      // zeros of the warp before key 4 lane
  int zeros;                           // zeros of the warp
  unsigned mine[(kSlabs + 7) / 8][4];  // the ballots of this lane's words:
                                       // slab s where s % 8 == lane >> 2
};

template <bool kStage = false>
__device__ __forceinline__ Ballots ballot_slabs(const int (&key)[kSlabs][4],
                                                int shift, int lane,
                                                int* __restrict__ stage =
                                                    nullptr) {
  Ballots w = {};
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int s = 0; s < kSlabs; ++s) {
    unsigned ones[4];
    int before = 0, slab_ones = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const unsigned b = (static_cast<uint32_t>(key[s][c]) >> shift) & 1u;
      w.bits[s / 8] |= b << (4 * (s % 8) + c);
      ones[c] = __ballot_sync(kFull, b);
      before += __popc(~ones[c] & lt);
      slab_ones += __popc(ones[c]);
    }
    w.zb[s] = w.zeros + before;
    if constexpr (kStage) {
      int z = w.zb[s];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = s * 128 + 4 * lane + c;
        const int b = (w.bits[s / 8] >> (4 * (s % 8) + c)) & 1u;
        stage[b ? kWarpKeys - 1 - (i - z) : z] = key[s][c];
        z += 1 - b;
      }
    }
    w.zeros += 128 - slab_ones;
    if ((s % 8) == (lane >> 2)) {
#pragma unroll
      for (int c = 0; c < 4; ++c) w.mine[s / 8][c] = ones[c];
    }
  }
  return w;
}

// Bitmap word (lane & 3) of a slab, keys 32 (lane & 3) .. + 31, from the
// slab's four ballots: byte (lane & 3) of each, interleaved.
__device__ __forceinline__ unsigned slab_word(const unsigned (&m)[4],
                                              int lane) {
  const int sh = 8 * (lane & 3);
  unsigned word = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) word |= spread4((m[c] >> sh) & 0xffu) << c;
  return word;
}

// The bitmap words of a warp's keys: word 32r + lane (< 4 kSlabs) is
// slab_word of slab 8r + (lane >> 2), whose ballots the lane holds in
// mine[r]; masked past n.
template <int kRounds>
__device__ __forceinline__ void write_words(
    const Params& p, int row, int warp_base, int lane,
    const unsigned (&mine)[kRounds][4]) {
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const unsigned word = slab_word(mine[r], lane);
    const int gw = warp_base / 32 + 32 * r + lane;
    const int left = p.n - 32 * gw;
    if (32 * r + lane < 4 * kSlabs && gw < p.W)
      p.bitmap[row * p.bitmap_stride + gw] = static_cast<int32_t>(
          left >= 32 ? word : word & ((1u << left) - 1u));
  }
}

// Move mode's stores: the first `real` keys of a warp's staged runs, run
// place j < zeros (stage[j]) to z0 + j and the others (stage[kWarpKeys - 1 -
// (j - zeros)]) to o0 + j - zeros.
__device__ __forceinline__ void store_moved(const int* __restrict__ stage,
                                            int real, int zeros, int z0,
                                            int o0, int32_t* __restrict__ out,
                                            int lane) {
#pragma unroll 8
  for (int j = lane; j < kWarpKeys; j += 32) {
    if (j < real)
      out[j < zeros ? z0 + j : o0 + j - zeros] =
          stage[j < zeros ? j : kWarpKeys - 1 - (j - zeros)];
  }
}

template <bool kTree, bool kVec, bool kMove = false>
__global__ void __launch_bounds__(kThreads)
    zero_scan_kernel(const Params p) {
  static_assert(!(kTree && kMove), "the move mode is a matrix level's");
  __shared__ int s_tile, s_excl;
  __shared__ int s_warp_zeros[kWarps];
  __shared__ int s_table[kTree ? 3 * kMaxNodes : 1];
  __shared__ int s_stage[kMove ? kTile : 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = static_cast<int>(atomicAdd(p.next_tile, 1u));
  __syncthreads();
  const int t = s_tile;
  const int row = t / p.tiles_per_row;
  const int first = row * p.tiles_per_row;
  const int warp_base = (t - first) * kTile + warp * kWarpKeys;

  int key[kSlabs][4];
  const int32_t* krow = p.keys + row * p.key_stride;
#pragma unroll
  for (int s = 0; s < kSlabs; ++s)
    load4<kVec>(krow, warp_base + s * 128 + 4 * lane, p.n, -1, key[s]);
  // node ids, clamped to the table and packed a byte each, four a slab
  unsigned nodes[kTree ? kSlabs : 1];
  if constexpr (kTree) {
    int nid[kSlabs][4];
    const int32_t* nrow = p.nid + row * p.nid_stride;
#pragma unroll
    for (int s = 0; s < kSlabs; ++s)
      load4<kVec>(nrow, warp_base + s * 128 + 4 * lane, p.n, 0, nid[s]);
    const int32_t* trow = p.table + static_cast<long long>(row) * 3 * p.nodes;
    for (int k = threadIdx.x; k < 3 * p.nodes; k += kThreads)
      s_table[k] = trow[k];
#pragma unroll
    for (int s = 0; s < kSlabs; ++s) {
      nodes[s] = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        nodes[s] |= static_cast<unsigned>(min(max(nid[s][c], 0), p.nodes - 1))
                    << (8 * c);
    }
  }

  // ballots per slab and key slot: the in-warp zero counts and the bitmap
  const Ballots bal = ballot_slabs<kMove>(
      key, p.shift, lane, kMove ? s_stage + warp * kWarpKeys : nullptr);
  if (lane == 0) s_warp_zeros[warp] = bal.zeros;
  __syncthreads();
  int warp_excl = 0, agg = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int z = s_warp_zeros[w];
    warp_excl += w < warp ? z : 0;
    agg += z;
  }

  if (warp == 0) {
    const long long excl = look_back(p.status, t, first, agg, lane);
    if (lane == 0) {
      s_excl = static_cast<int>(excl);
      if constexpr (!kTree) {               // the last tile: the row's zeros
        if (t == first + p.tiles_per_row - 1)
          p.zeros_out[row] = static_cast<int>(excl) + agg;
      }
    }
  } else {
    write_words(p, row, warp_base, lane, bal.mine);
  }
  __syncthreads();
  if (warp == 0) write_words(p, row, warp_base, lane, bal.mine);

  int s0 = 0, s1 = 0, zs = 0;
  if constexpr (!kTree) s1 = p.total_zeros[row * p.total_stride];
  const int zbase = s_excl + warp_excl;
  int32_t* drow = p.dest + row * p.dest_stride;
  if constexpr (kMove) {
    // the warp's zeros from Z(warp_base), its ones from the row's ones before
    // warp_base on
    store_moved(s_stage + warp * kWarpKeys, min(kWarpKeys, p.n - warp_base),
                bal.zeros, zbase, s1 + warp_base - zbase, drow, lane);
    return;
  }
#pragma unroll
  for (int s = 0; s < kSlabs; ++s) {
    const int i0 = warp_base + s * 128 + 4 * lane;
    int z = zbase + bal.zb[s];                 // Z(i0)
    int d[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int bit = (bal.bits[s / 8] >> (4 * (s % 8) + c)) & 1u;
      if constexpr (kTree) {
        const int v = (nodes[s] >> (8 * c)) & 0xffu;
        s0 = s_table[v];
        s1 = s_table[p.nodes + v];
        zs = s_table[2 * p.nodes + v];
      }
      const int zin = z - zs;
      d[c] = bit ? s1 + (i0 + c - s0) - zin : s0 + zin;
      z += 1 - bit;
    }
    store4<kVec>(drow, i0, p.n, d);
  }
}

// The one-node (matrix) or table (tree) scan over `rows` rows. `vec`: every
// row of keys, node ids and destinations (not the moved keys: their stores
// are 4-byte) starts 16-byte aligned.
template <bool kTree, bool kMove = false>
int launch(const Params& p, int rows, bool vec, cudaStream_t stream) {
  const long long tiles = static_cast<long long>(rows) * p.tiles_per_row;
  if (tiles > 0x7fffffffLL ||
      static_cast<long long>(p.n) + kTile > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kTree && (p.nodes < 1 || p.nodes > kMaxNodes))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tiles > 0) {
    const unsigned grid = static_cast<unsigned>(tiles);
    if (vec)
      zero_scan_kernel<kTree, true, kMove><<<grid, kThreads, 0, stream>>>(p);
    else
      zero_scan_kernel<kTree, false, kMove><<<grid, kThreads, 0, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// Registers, static shared bytes, local bytes and resident blocks per SM of
// the vectorised kernel, into out[0..3].
template <bool kTree, bool kMove = false>
int info(int* out) {
  cudaFuncAttributes a;
  cudaError_t err =
      cudaFuncGetAttributes(&a, zero_scan_kernel<kTree, true, kMove>);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, zero_scan_kernel<kTree, true, kMove>, kThreads, 0);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = blocks;
  return static_cast<int>(err);
}

}  // namespace zero_scan
