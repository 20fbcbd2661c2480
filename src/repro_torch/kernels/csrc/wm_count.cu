// Global range count over S stacked wavelet-matrix shards: the symbols in
// [sym_lo, sym_hi) within each query's local ranges, summed over the
// shards, in one launch.
//
// No Pallas counterpart: the reference counts through XLA
// (``repro.analytics.engine.sharded_range_count``, two count-below
// descents a shard). The port's plain version is those descents in eager
// torch, about 1,800 launches a batch of the serving front-end on the H100.
//
// Work, laid out as wm_quantile.cu's: a query's shards are dealt 16 to a
// warp, lo and hi of a shard on neighbouring lanes, so that a narrow
// range's two probes share their sectors. A block serves a query, its warps
// (up to 8) taking the query's groups of 16 shards in turn, and blocks
// stride over the queries: a batch of 128 queries over 128 shards is 1,024
// warps on every SM, where a warp a query would leave 128 warps to walk a
// query's 8 groups one after another. A group whose 16 local ranges are
// all empty (masked shards, or ones the query does not cover) probes
// nothing.
// Each lane descends its endpoint for the two bounds:
//   - a bound whose answer is known takes no probe: below(b) is 0 for
//     b <= 0 and the range's width for b >= 2^nbits, and a query with
//     sym_hi <= sym_lo counts nothing;
//   - while the bits of the two bounds agree their intervals are equal,
//     so the lane probes once a level, and from the first level where the
//     bits part it probes twice, both loads issued before either is used.
// At a level whose bound bit is 1 the lane adds its share of the zero
// child's width (pos - rank, negated on the lo lane) and steps into the
// one child (zeros + rank), else into the zero child (pos - rank). The
// counts are summed over the warp (__reduce_add_sync) and over the
// block's warps, and the block writes the query's total: no atomic and no
// zeroing launch. The rank probe is wm_quantile.cu's.
//
// Bound on the H100: nbits dependent DRAM loads a warp (18 x 337 ns), and
// the distinct 32-byte directory sectors the batch's probes touch over
// the HBM rate (chip_smoke.py counts them as it counts the quantile's).
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kWarps = 8;               // warps per block
constexpr int kShards = 16;             // shards a warp's group
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const int32_t* los;     // (Q, S) local ranges
  const int32_t* his;
  const int32_t* sym_lo;  // (Q,)
  const int32_t* sym_hi;
  int Q, S;
  const int32_t* words;   // (S * nbits, words_stride)
  long long words_stride;
  const int32_t* super;
  long long super_stride;
  const int16_t* block;
  long long block_stride;
  int nblocks;
  const int32_t* zeros;   // (S * nbits,)
  int nbits;
  int32_t* out;           // (Q,)
};

struct Probe {
  int4 q;
  int base;
};

__device__ __forceinline__ void load_probe(const Params& p, long long row,
                                           int pos, Probe& r) {
  const int bc = min(pos >> 7, p.nblocks - 1);
  r.q = __ldg(reinterpret_cast<const int4*>(p.words + row * p.words_stride) +
              bc);
  r.base = __ldg(p.super + row * p.super_stride + (bc >> 3)) +
           static_cast<uint16_t>(__ldg(p.block + row * p.block_stride + bc));
}

__device__ __forceinline__ int rank_probe(const Probe& r, int pos,
                                          int nblocks) {
  const uint32_t v[4] = {static_cast<uint32_t>(r.q.x),
                         static_cast<uint32_t>(r.q.y),
                         static_cast<uint32_t>(r.q.z),
                         static_cast<uint32_t>(r.q.w)};
  const uint32_t partial = (1u << (pos & 31)) - 1u;
  const int w = pos >> 5;
  const int bc = min(pos >> 7, nblocks - 1);
  int rank = r.base;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (4 * bc + j < w) rank += __popc(v[j]);
    else if (4 * bc + j == w) rank += __popc(v[j] & partial);
  }
  return rank;
}

__global__ void __launch_bounds__(32 * kWarps)
    wm_count_kernel(const Params p) {
  __shared__ int spart[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int chunks = (p.S + kShards - 1) / kShards;
  const int top = 1 << p.nbits;
  const int e = lane & 1;                 // 0: the lo endpoint, 1: hi
  const int sign = e ? 1 : -1;

  for (int q = blockIdx.x; q < p.Q; q += gridDim.x) {   // block-uniform
    const int bhi = min(max(p.sym_hi[q], 0), top);
    const int blo = min(max(p.sym_lo[q], 0), top);
    if (bhi <= blo) {                      // an empty symbol range
      if (threadIdx.x == 0) p.out[q] = 0;
      continue;
    }
    // below(bhi): a descent unless bhi is 2^nbits (the width); below(blo):
    // a descent unless blo is 0 (nothing). bhi > blo, so bhi > 0 and
    // blo < 2^nbits.
    const bool act_h = bhi < top, act_l = blo > 0;
    // the first level where the bounds' bits part (nbits: never)
    const int part = act_h && act_l
                         ? p.nbits - 32 + __clz(bhi ^ blo)
                         : p.nbits;
    int total = 0;
    for (int c = warp; c < chunks; c += nwarps) {      // warp-uniform
      const int s = c * kShards + (lane >> 1);
      int lo = 0, hi = 0;
      if (s < p.S) {
        const long long o = static_cast<long long>(q) * p.S + s;
        lo = p.los[o];
        hi = p.his[o];
      }
      const bool live = hi > lo;
      if (!__any_sync(kFull, live)) continue;
      const int pos0 = e ? hi : lo;
      int ph = pos0, pl = pos0, acc_h = 0, acc_l = 0;
      if (live && (act_h || act_l)) {
        const long long row0 = static_cast<long long>(s) * p.nbits;
        for (int l = 0; l < p.nbits; ++l) {
          const long long row = row0 + l;
          const bool one = l < part || !act_h || !act_l;   // one probe
          Probe a, b;
          load_probe(p, row, act_h ? ph : pl, a);
          if (!one) load_probe(p, row, pl, b);
          const int z = __ldg(p.zeros + row);
          const int rh = rank_probe(a, act_h ? ph : pl, p.nblocks);
          const int rl = one ? rh : rank_probe(b, pl, p.nblocks);
          const int sh = p.nbits - 1 - l;
          if (act_h) {
            if ((bhi >> sh) & 1) {
              acc_h += sign * (ph - rh);
              ph = z + rh;
            } else {
              ph -= rh;
            }
          }
          if (act_l) {
            if ((blo >> sh) & 1) {
              acc_l += sign * (pl - rl);
              pl = z + rl;
            } else {
              pl -= rl;
            }
          }
        }
      }
      if (live) total += (act_h ? acc_h : sign * pos0) - (act_l ? acc_l : 0);
    }
    total = __reduce_add_sync(kFull, total);
    if (lane == 0) spart[warp] = total;
    __syncthreads();
    if (warp == 0) {
      total = __reduce_add_sync(kFull, lane < nwarps ? spart[lane] : 0);
      if (lane == 0) p.out[q] = total;
    }
    __syncthreads();                       // spart is the next query's
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// los/his: (Q, S) int32 local ranges; sym_lo/sym_hi: (Q,) int32.
// words/superblock/block/zeros: the quantile kernel's operands (row
// s*nbits + l is level l of shard s). out: (Q,) int32, every entry
// written.
extern "C" int wm_count_sharded(
    const void* los, const void* his, const void* sym_lo, const void* sym_hi,
    int Q, int S, const void* words, long long words_stride,
    const void* superblock, long long super_stride, const void* block,
    long long block_stride, int nblocks, const void* zeros, int nbits,
    void* out, void* stream) {
  if (Q < 0 || S <= 0 || nbits <= 0 || nbits > 30 || nblocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (Q == 0) return static_cast<int>(cudaGetLastError());
  // the grid that fills the card once (resident blocks an SM x SMs)
  static std::atomic<int> max_blocks{0};
  if (max_blocks.load() == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, wm_count_kernel, 32 * kWarps, 0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    max_blocks.store(max(1, per_sm) * max(1, sms));
  }
  Params p;
  p.los = static_cast<const int32_t*>(los);
  p.his = static_cast<const int32_t*>(his);
  p.sym_lo = static_cast<const int32_t*>(sym_lo);
  p.sym_hi = static_cast<const int32_t*>(sym_hi);
  p.Q = Q;
  p.S = S;
  p.words = static_cast<const int32_t*>(words);
  p.words_stride = words_stride;
  p.super = static_cast<const int32_t*>(superblock);
  p.super_stride = super_stride;
  p.block = static_cast<const int16_t*>(block);
  p.block_stride = block_stride;
  p.nblocks = nblocks;
  p.zeros = static_cast<const int32_t*>(zeros);
  p.nbits = nbits;
  p.out = static_cast<int32_t*>(out);
  // a warp a group of kShards shards, at most kWarps a block
  const int warps = min(kWarps, (S + kShards - 1) / kShards);
  const int grid = static_cast<int>(min(static_cast<long long>(Q),
                                        static_cast<long long>(
                                            max_blocks.load())));
  wm_count_kernel<<<grid, 32 * warps, 0,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
