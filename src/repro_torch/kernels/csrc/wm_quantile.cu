// Global range quantile over S stacked wavelet-matrix shards: the
// count-then-refine descent, every shard and every level in one launch.
//
// Replaces repro/kernels/wm_quantile.py:wm_quantile_sharded_pallas (and, at
// S = 1, wm_quantile_pallas). The Pallas form keeps the whole stacked
// structure resident in VMEM and unrolls shards and levels statically. On
// the H100 the directories stay in global memory (0.35 GB at full width, far
// above the 50 MB L2), so every rank probe is a dependent, scattered load,
// and S and nbits are runtime arguments.
//
// Work: a warp serves one query at a time. The non-empty local ranges of a
// query are the shards [s0, s1] that its global range covers; their
// (shard, endpoint) probes are dealt to the lanes in rounds of 32, lo and
// hi of a shard on neighbouring lanes. Per level every lane issues the
// loads of all its rounds (the probe and the level's zeros entry) before it
// uses any, so a level costs one round trip to memory. When lo and hi share
// a block (a range that has become empty, or a narrow one) the two
// neighbouring lanes read the same sectors in one load instruction, which
// the memory system serves once. __shfl_xor_sync sums the query's zeros
// over the warp, every lane takes the branch on the global k, and each lane
// steps its own endpoint on: zl + rank1 on the one branch, pos - rank1 on
// the zero branch. The first kRegRounds rounds live in registers; a query
// with more probes keeps the rest in the warp's slice of a scratch buffer,
// so the shard count has no cap. Warps stride over the queries, so the
// scratch is sized by the grid, not by the batch. Every query of a 4,096
// batch is resident at once when the kernel fits 4 blocks an SM
// (kMinBlocks, 64 registers): the sweep found one wave of warps 1.6x
// faster than two.
//
// Layout: the reference directories read in place, a superblock entry, a
// block entry and the block's four words in one 16-byte load (three
// sectors a probe). A copy cut into 32-byte "rank lines", one sector a
// probe, and 2 or 4 queries a warp are variants of
// launch/csrc/wm_quantile_variants.cu; launch/sweep_quantile.py found the
// lines within 1-3% of the directories and one query a warp the fastest.
//
// Bound on the H100: not bytes (the distinct 32-byte sectors a batch of
// 4,096 matrix-path queries probes, about 387,000, take 7% of the kernel's
// time at the HBM rate), and only a ninth of it is the floor of nbits
// dependent DRAM round trips. Each warp runs nbits dependent steps of
// address arithmetic, scattered loads, popcounts and a butterfly; the
// sweep's ablations put about half of the time in that chain without any
// probe load and a quarter in the DRAM round trips.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;             // warps per block
constexpr int kRegRounds = 3;         // probe rounds of 32 kept in registers
constexpr int kMinBlocks = 4;         // resident blocks an SM asked of nvcc
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const int32_t* lo;
  const int32_t* hi;
  const int32_t* k;
  int Q;
  const int32_t* words;   // (S * nbits, words_stride) int32
  long long words_stride;
  const int32_t* super;
  long long super_stride;
  const int16_t* block;
  long long block_stride;
  int nblocks;
  const int32_t* zeros;   // (S * nbits,): zeros of row s * nbits + l
  int nbits, n, shard_bits;
  int32_t* scratch;       // per warp: positions, then one-branch positions
  int over;               // probes a warp keeps in scratch
  int32_t* out;
};

// What one probe loads: a block's four words and the rank at its start.
struct Probe {
  int4 q;
  int base;
};

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(kFull, x, d);
  return x;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ void load_probe(const Params& r, long long row,
                                           int pos, Probe& p) {
  const int bc = min(pos >> 7, r.nblocks - 1);
  p.q = __ldg(reinterpret_cast<const int4*>(r.words + row * r.words_stride) +
              bc);
  p.base = __ldg(r.super + row * r.super_stride + (bc >> 3)) +
           static_cast<uint16_t>(__ldg(r.block + row * r.block_stride + bc));
}

// # of 1 bits before position pos of the row, from what load_probe read.
__device__ __forceinline__ int rank_probe(const Probe& p, int pos,
                                          int nblocks) {
  const uint32_t v[4] = {static_cast<uint32_t>(p.q.x),
                         static_cast<uint32_t>(p.q.y),
                         static_cast<uint32_t>(p.q.z),
                         static_cast<uint32_t>(p.q.w)};
  const uint32_t partial = (1u << (pos & 31)) - 1u;
  const int w = pos >> 5;
  const int bc = min(pos >> 7, nblocks - 1);
  int rank = p.base;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (4 * bc + j < w) rank += __popc(v[j]);
    else if (4 * bc + j == w) rank += __popc(v[j] & partial);
  }
  return rank;
}

// Endpoint (0: lo, 1: hi), shard and starting position of probe pr of the
// query [glo, ghi): probe 2j + e is endpoint e of shard s0 + j.
__device__ __forceinline__ void probe_at(int glo, int ghi, int pr,
                                         int shard_bits, int& e, int& s,
                                         int& pos) {
  e = pr & 1;
  s = (glo >> shard_bits) + (pr >> 1);
  const long long base = static_cast<long long>(s) << shard_bits;
  const long long size = 1LL << shard_bits;
  pos = e ? static_cast<int>(min(static_cast<long long>(ghi) - base, size))
          : static_cast<int>(max(static_cast<long long>(glo) - base, 0LL));
}

__global__ void __launch_bounds__(32 * kWarps, kMinBlocks)
    wm_quantile_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int warps = gridDim.x * kWarps;
  int32_t* over_pos = p.scratch + static_cast<long long>(warp) * 2 * p.over;
  int32_t* over_one = over_pos + p.over;

  for (int q = warp; q < p.Q; q += warps) {   // warp-uniform
    const int a = clampi(p.lo[q], 0, p.n);
    const int b = clampi(p.hi[q], a, p.n);
    if (b == a) {
      if (lane == 0) p.out[q] = -1;
      continue;
    }
    const int P = 2 * (((b - 1) >> p.shard_bits) - (a >> p.shard_bits) + 1);
    int kk = clampi(p.k[q], 0, b - a - 1);
    int sym = 0;

    // register rounds: position, first row (s * nbits), endpoint (-1: none)
    int pos[kRegRounds], row0[kRegRounds], end[kRegRounds];
#pragma unroll
    for (int r = 0; r < kRegRounds; ++r) {
      const int pr = lane + 32 * r;
      pos[r] = row0[r] = 0;
      end[r] = -1;
      if (pr < P) {
        int s;
        probe_at(a, b, pr, p.shard_bits, end[r], s, pos[r]);
        row0[r] = s * p.nbits;
      }
    }
    for (int pr = lane + 32 * kRegRounds; pr < P; pr += 32) {
      int e, s, x;
      probe_at(a, b, pr, p.shard_bits, e, s, x);
      over_pos[pr - 32 * kRegRounds] = x;
    }

    for (int l = 0; l < p.nbits; ++l) {
      Probe pb[kRegRounds];
      int zl[kRegRounds], rank[kRegRounds];
      // every load of the level first
#pragma unroll
      for (int r = 0; r < kRegRounds; ++r) {
        zl[r] = 0;
        if (end[r] >= 0) {
          const long long row = row0[r] + l;
          load_probe(p, row, pos[r], pb[r]);
          zl[r] = __ldg(p.zeros + row);
        }
      }
      int acc = 0;
#pragma unroll
      for (int r = 0; r < kRegRounds; ++r) {
        rank[r] = 0;
        if (end[r] >= 0) {
          rank[r] = rank_probe(pb[r], pos[r], p.nblocks);
          const int z = pos[r] - rank[r];        // zeros before the endpoint
          acc += end[r] ? z : -z;
        }
      }
      // rounds past the registers, one at a time, through the scratch: the
      // zero-branch position replaces the position, the one-branch
      // position waits beside it
      for (int pr = lane + 32 * kRegRounds; pr < P; pr += 32) {
        const int o = pr - 32 * kRegRounds;
        const int x = over_pos[o];
        const long long row =
            static_cast<long long>((a >> p.shard_bits) + (pr >> 1)) *
                p.nbits + l;
        Probe pq;
        load_probe(p, row, x, pq);
        const int z0 = __ldg(p.zeros + row);
        const int rk = rank_probe(pq, x, p.nblocks);
        acc += (pr & 1) ? x - rk : rk - x;
        over_pos[o] = x - rk;
        over_one[o] = z0 + rk;
      }
      const int z = warp_sum(acc);
      const bool one = kk >= z;
      sym = (sym << 1) | (one ? 1 : 0);
      if (one) kk -= z;
#pragma unroll
      for (int r = 0; r < kRegRounds; ++r) {
        if (end[r] >= 0) pos[r] = one ? zl[r] + rank[r] : pos[r] - rank[r];
      }
      if (one) {
        for (int pr = lane + 32 * kRegRounds; pr < P; pr += 32) {
          const int o = pr - 32 * kRegRounds;
          over_pos[o] = over_one[o];
        }
      }
    }
    if (lane == 0) p.out[q] = sym;
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out: registers, local bytes, resident blocks per SM, warps per block,
// probes a warp keeps in registers.
extern "C" int wm_quantile_info(void* out) {
  int* o = static_cast<int*>(out);
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, wm_quantile_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, wm_quantile_kernel, 32 * kWarps, 0);
  o[0] = a.numRegs;
  o[1] = static_cast<int>(a.localSizeBytes);
  o[2] = blocks;
  o[3] = kWarps;
  o[4] = 32 * kRegRounds;
  return static_cast<int>(err);
}

// lo/hi/k/out: (Q,) int32. Row s*nbits + l of every array holds level l of
// shard s. words: (S*nbits, words_stride) int32, 16-byte aligned rows of at
// least nblocks*4 words; superblock (int32) and block (int16) the
// directories of those rows. zeros: (S*nbits,) int32. scratch:
// max_blocks * kWarps * 2 * over int32, over >= 2 * S - 32 * kRegRounds
// (may be null when that is not positive).
extern "C" int wm_quantile_sharded(
    const void* lo, const void* hi, const void* k, int Q, const void* words,
    long long words_stride, const void* superblock, long long super_stride,
    const void* block, long long block_stride, int nblocks,
    const void* zeros, int S, int nbits, int n, int shard_bits,
    void* scratch, int over, int max_blocks, void* out, void* stream) {
  const long long need = 2LL * S - 32 * kRegRounds;
  if (S <= 0 || nbits <= 0 || shard_bits < 0 || shard_bits > 30 ||
      max_blocks <= 0 || nblocks <= 0 || over < need ||
      (over > 0 && scratch == nullptr) ||
      (static_cast<long long>(S) << shard_bits) < n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long grid = min(static_cast<long long>(max_blocks),
                             (static_cast<long long>(Q) + kWarps - 1) / kWarps);
  if (grid > 0) {
    Params p;
    p.lo = static_cast<const int32_t*>(lo);
    p.hi = static_cast<const int32_t*>(hi);
    p.k = static_cast<const int32_t*>(k);
    p.Q = Q;
    p.words = static_cast<const int32_t*>(words);
    p.words_stride = words_stride;
    p.super = static_cast<const int32_t*>(superblock);
    p.super_stride = super_stride;
    p.block = static_cast<const int16_t*>(block);
    p.block_stride = block_stride;
    p.nblocks = nblocks;
    p.zeros = static_cast<const int32_t*>(zeros);
    p.nbits = nbits;
    p.n = n;
    p.shard_bits = shard_bits;
    p.scratch = static_cast<int32_t*>(scratch);
    p.over = over;
    p.out = static_cast<int32_t*>(out);
    wm_quantile_kernel<<<static_cast<int>(grid), 32 * kWarps, 0,
                         static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
