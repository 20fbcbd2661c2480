// The sharded range quantile's variants for launch/sweep_quantile.py, which
// rewrites the constants below in copies of this file and times each build
// beside the serving kernel (kernels/csrc/wm_quantile.cu). Nothing on a
// serving path calls it. With kQueriesPerWarp = 1, kRegRounds = 3,
// kMinBlocks = 4 and kLineWords = 0 it computes what the serving kernel
// computes, the same way.
//
// Work: a warp serves kQueriesPerWarp queries at a time. The non-empty local
// ranges of a query are the shards [s0, s1] that its global range covers;
// their (shard, endpoint) probes are dealt to the lanes in rounds of 32,
// lo and hi of a shard on neighbouring lanes, the probes of the next query
// after those of the one before. Per level every lane issues the loads of
// all its register rounds before it uses any; __shfl_xor_sync sums the
// zeros of each query over the warp and every lane takes its query's
// branch. Rounds past kRegRounds live in the warp's slice of a scratch
// buffer.
//
// Layout: kLineWords = 0 reads the reference directories in place (a
// superblock entry, a block entry and the block's four words in one
// 16-byte load: three sectors a probe). kLineWords = 7 or 15 reads "rank
// lines" instead, a copy of the directories cut into 32- or 64-byte lines
// (an int32 count of the ones before the line, then its words), one or two
// sectors a probe; launch/sweep_quantile.py builds them (line_rows).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;             // warps per block
constexpr int kQueriesPerWarp = 1;    // queries a warp serves together
constexpr int kRegRounds = 3;         // probe rounds of 32 kept in registers
constexpr int kMinBlocks = 4;         // resident blocks an SM asked of nvcc
constexpr int kLineWords = 0;         // 0: the directories; else words a line
constexpr int kLineInts = kLineWords + 1;
constexpr int kLineBits = 32 * (kLineWords > 0 ? kLineWords : 1);
constexpr int kLoads = kLineWords > 0 ? kLineInts / 4 : 1;  // 16-byte loads
constexpr unsigned kFull = 0xffffffffu;
static_assert(kLineWords == 0 || kLineInts % 4 == 0,
              "a line is a whole number of 16-byte loads");

struct Rows {
  const int32_t* words;   // the words, or the lines: (rows, stride) int32
  long long stride;       // int32 elements a row
  const int32_t* super;   // the directories (not read with lines)
  long long super_stride;
  const int16_t* block;
  long long block_stride;
  int nblocks;
};

struct Params {
  const int32_t* lo;
  const int32_t* hi;
  const int32_t* k;
  int Q;
  Rows rows;
  const int32_t* zeros;   // (S * nbits,): zeros of row s * nbits + l
  int nbits, n, shard_bits;
  int32_t* scratch;       // per warp: positions, then one-branch positions
  int over;               // probes a warp keeps in scratch
  int32_t* out;
};

// What one probe loads: a block's words and its two ranks, or a line.
struct Probe {
  int4 q[kLoads];
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

__device__ __forceinline__ void load_probe(const Rows& r, long long row,
                                           int pos, Probe& p) {
  if constexpr (kLineWords > 0) {
    const unsigned line = static_cast<unsigned>(pos) / kLineBits;
    const int4* src = reinterpret_cast<const int4*>(r.words + row * r.stride) +
                      static_cast<long long>(line) * kLoads;
#pragma unroll
    for (int j = 0; j < kLoads; ++j) p.q[j] = __ldg(src + j);
    p.base = 0;
  } else {
    const int bc = min(pos >> 7, r.nblocks - 1);
    p.q[0] = __ldg(reinterpret_cast<const int4*>(r.words + row * r.stride) +
                   bc);
    p.base = __ldg(r.super + row * r.super_stride + (bc >> 3)) +
             static_cast<uint16_t>(__ldg(r.block + row * r.block_stride + bc));
  }
}

// # of 1 bits before position pos of the row, from what load_probe read.
__device__ __forceinline__ int rank_probe(const Rows& r, const Probe& p,
                                          int pos) {
  uint32_t v[4 * kLoads];
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    v[4 * j] = p.q[j].x;
    v[4 * j + 1] = p.q[j].y;
    v[4 * j + 2] = p.q[j].z;
    v[4 * j + 3] = p.q[j].w;
  }
  const uint32_t partial = (1u << (pos & 31)) - 1u;
  if constexpr (kLineWords > 0) {
    const unsigned line = static_cast<unsigned>(pos) / kLineBits;
    const int w = (pos - static_cast<int>(line) * kLineBits) >> 5;
    int rank = static_cast<int>(v[0]);
#pragma unroll
    for (int j = 0; j < kLineWords; ++j) {
      if (j < w) rank += __popc(v[j + 1]);
      else if (j == w) rank += __popc(v[j + 1] & partial);
    }
    return rank;
  } else {
    const int w = pos >> 5;
    const int bc = min(pos >> 7, r.nblocks - 1);
    int rank = p.base;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (4 * bc + j < w) rank += __popc(v[j]);
      else if (4 * bc + j == w) rank += __popc(v[j] & partial);
    }
    return rank;
  }
}

struct Tile {
  int glo[kQueriesPerWarp], ghi[kQueriesPerWarp], s0[kQueriesPerWarp];
  int off[kQueriesPerWarp + 1];   // first probe of each query; off[T] = P
};

// Query slot, endpoint (0: lo, 1: hi), shard and starting position of probe
// pr < P: probe 2j + e of a query is endpoint e of its shard s0 + j.
__device__ __forceinline__ void probe_at(const Tile& tl, int pr, int shard_bits,
                                         int& t, int& e, int& s, int& pos) {
  t = 0;
#pragma unroll
  for (int u = 1; u < kQueriesPerWarp; ++u) t += pr >= tl.off[u];
  int glo = tl.glo[0], ghi = tl.ghi[0], s0 = tl.s0[0], o = tl.off[0];
#pragma unroll
  for (int u = 1; u < kQueriesPerWarp; ++u) {
    if (t == u) {
      glo = tl.glo[u];
      ghi = tl.ghi[u];
      s0 = tl.s0[u];
      o = tl.off[u];
    }
  }
  const int j = pr - o;
  e = j & 1;
  s = s0 + (j >> 1);
  const long long base = static_cast<long long>(s) << shard_bits;
  const long long size = 1LL << shard_bits;
  pos = e ? static_cast<int>(min(static_cast<long long>(ghi) - base, size))
          : static_cast<int>(max(static_cast<long long>(glo) - base, 0LL));
}

__device__ __forceinline__ void add_to(int (&acc)[kQueriesPerWarp], int t,
                                       int v) {
#pragma unroll
  for (int u = 0; u < kQueriesPerWarp; ++u) acc[u] += t == u ? v : 0;
}

__global__ void __launch_bounds__(32 * kWarps, kMinBlocks)
    wm_quantile_kernel(const Params p) {
  constexpr int T = kQueriesPerWarp;
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int warps = gridDim.x * kWarps;
  int32_t* over_pos = p.scratch + static_cast<long long>(warp) * 2 * p.over;
  int32_t* over_one = over_pos + p.over;

  for (int q0 = warp * T; q0 < p.Q; q0 += warps * T) {   // warp-uniform
    Tile tl;
    int kk[T], sym[T];
    tl.off[0] = 0;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int q = q0 + t;
      int a = 0, b = 0, m = 0, kq = 0;
      if (q < p.Q) {
        a = clampi(p.lo[q], 0, p.n);
        b = clampi(p.hi[q], a, p.n);
        if (b > a) {
          m = ((b - 1) >> p.shard_bits) - (a >> p.shard_bits) + 1;
          kq = clampi(p.k[q], 0, b - a - 1);
        }
      }
      tl.glo[t] = a;
      tl.ghi[t] = b;
      tl.s0[t] = a >> p.shard_bits;
      tl.off[t + 1] = tl.off[t] + 2 * m;
      kk[t] = kq;
      sym[t] = 0;
    }
    const int P = tl.off[T];

    // register rounds: position, first row (s * nbits), slot << 1 | endpoint
    int pos[kRegRounds], row0[kRegRounds], meta[kRegRounds];
#pragma unroll
    for (int r = 0; r < kRegRounds; ++r) {
      const int pr = lane + 32 * r;
      pos[r] = row0[r] = 0;
      meta[r] = -1;
      if (pr < P) {
        int t, e, s;
        probe_at(tl, pr, p.shard_bits, t, e, s, pos[r]);
        row0[r] = s * p.nbits;
        meta[r] = (t << 1) | e;
      }
    }
    for (int pr = lane + 32 * kRegRounds; pr < P; pr += 32) {
      int t, e, s, x;
      probe_at(tl, pr, p.shard_bits, t, e, s, x);
      over_pos[pr - 32 * kRegRounds] = x;
    }

    for (int l = 0; l < p.nbits; ++l) {
      Probe pb[kRegRounds];
      int zl[kRegRounds], rank[kRegRounds];
      // every load of the level first
#pragma unroll
      for (int r = 0; r < kRegRounds; ++r) {
        zl[r] = 0;
        if (meta[r] >= 0) {
          const long long row = row0[r] + l;
          load_probe(p.rows, row, pos[r], pb[r]);
          zl[r] = __ldg(p.zeros + row);
        }
      }
      int acc[T];
#pragma unroll
      for (int t = 0; t < T; ++t) acc[t] = 0;
#pragma unroll
      for (int r = 0; r < kRegRounds; ++r) {
        rank[r] = 0;
        if (meta[r] >= 0) {
          rank[r] = rank_probe(p.rows, pb[r], pos[r]);
          const int z = pos[r] - rank[r];        // zeros before the endpoint
          add_to(acc, meta[r] >> 1, (meta[r] & 1) ? z : -z);
        }
      }
      // rounds past the registers, one at a time, through the scratch: the
      // zero-branch position replaces the position, the one-branch
      // position waits beside it
      for (int pr = lane + 32 * kRegRounds; pr < P; pr += 32) {
        const int o = pr - 32 * kRegRounds;
        const int x = over_pos[o];
        int t, e, s, unused;
        probe_at(tl, pr, p.shard_bits, t, e, s, unused);
        const long long row = static_cast<long long>(s) * p.nbits + l;
        Probe q;
        load_probe(p.rows, row, x, q);
        const int z0 = __ldg(p.zeros + row);
        const int rk = rank_probe(p.rows, q, x);
        add_to(acc, t, e ? x - rk : rk - x);
        over_pos[o] = x - rk;
        over_one[o] = z0 + rk;
      }
      int bits = 0;   // bit t: the branch query slot t takes
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const int z = warp_sum(acc[t]);
        const int bit = kk[t] >= z ? 1 : 0;
        sym[t] = (sym[t] << 1) | bit;
        if (bit) kk[t] -= z;
        bits |= bit << t;
      }
#pragma unroll
      for (int r = 0; r < kRegRounds; ++r) {
        if (meta[r] >= 0) {
          pos[r] = (bits >> (meta[r] >> 1)) & 1 ? zl[r] + rank[r]
                                                 : pos[r] - rank[r];
        }
      }
      for (int pr = lane + 32 * kRegRounds; pr < P; pr += 32) {
        const int o = pr - 32 * kRegRounds;
        int t, e, s, unused;
        probe_at(tl, pr, p.shard_bits, t, e, s, unused);
        if ((bits >> t) & 1) over_pos[o] = over_one[o];
      }
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
      if (lane == t && q0 + t < p.Q) {
        p.out[q0 + t] = tl.off[t + 1] > tl.off[t] ? sym[t] : -1;
      }
    }
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out: registers, local bytes, resident blocks per SM, warps per block,
// queries per warp, probes a warp keeps in registers, words per line (0:
// the reference directories).
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
  o[4] = kQueriesPerWarp;
  o[5] = 32 * kRegRounds;
  o[6] = kLineWords;
  return static_cast<int>(err);
}

// lo/hi/k/out: (Q,) int32. Row s*nbits + l of every array holds level l of
// shard s. rows: the words, (S*nbits, rows_stride) int32, 16-byte aligned
// rows of at least nblocks*4 words; superblock (int32) and block (int16)
// the directories of those rows. With lines (kLineWords > 0) rows are
// whole lines instead, a line for every 32*kLineWords positions and one
// more, and the directories are not read. zeros: (S*nbits,) int32.
// scratch: max_blocks * kWarps * 2 * over int32, over >= kQueriesPerWarp *
// 2 * S - 32 * kRegRounds (may be null when that is not positive).
extern "C" int wm_quantile_sharded(
    const void* lo, const void* hi, const void* k, int Q, const void* rows,
    long long rows_stride, const void* superblock, long long super_stride,
    const void* block, long long block_stride, int nblocks,
    const void* zeros, int S, int nbits, int n, int shard_bits,
    void* scratch, int over, int max_blocks, void* out, void* stream) {
  const long long need =
      static_cast<long long>(kQueriesPerWarp) * 2 * S - 32 * kRegRounds;
  if (S <= 0 || nbits <= 0 || shard_bits < 0 || shard_bits > 30 ||
      max_blocks <= 0 || over < need || (over > 0 && scratch == nullptr) ||
      (static_cast<long long>(S) << shard_bits) < n ||
      (kLineWords == 0 && nblocks <= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = (static_cast<long long>(Q) + kQueriesPerWarp - 1) /
                          kQueriesPerWarp;
  const long long grid =
      min(static_cast<long long>(max_blocks), (tiles + kWarps - 1) / kWarps);
  if (grid > 0) {
    Params p;
    p.lo = static_cast<const int32_t*>(lo);
    p.hi = static_cast<const int32_t*>(hi);
    p.k = static_cast<const int32_t*>(k);
    p.Q = Q;
    p.rows = {static_cast<const int32_t*>(rows), rows_stride,
              static_cast<const int32_t*>(superblock), super_stride,
              static_cast<const int16_t*>(block), block_stride, nblocks};
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
