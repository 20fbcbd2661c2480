// The first CUDA form of the front-end's greedy top-k, kept unchanged
// as the baseline of launch/sweep_frontend.py, which builds and times it
// beside the serving kernel (kernels/csrc/topk_greedy.cu). Nothing on a
// serving path calls it.
//
// Greedy global range top-k over S stacked wavelet-matrix shards: the
// serving front-end's degraded top-k, every round of a query's frontier in
// one launch.
//
// No Pallas counterpart: the reference runs this op (``repro.analytics.
// range_ops.topk_frontier``) as an XLA loop. The port's plain version is a
// loop of eager torch ops, about 75 launches a round and a host sync every
// eighth round, so a batch at the front-end's budget of 48 pops took tens
// of milliseconds of host time on the H100, most of the front-end's
// 250 ms deadline.
//
// Work: one warp serves one query (a block is one warp). A frontier slot is
// a node of the matrix: its per-shard intervals (S pairs, in a global
// scratch slice of the query: cap x S x 2 int32), its weight (summed
// width), symbol prefix, level and whether it is alive (16 bytes a slot:
// in shared memory while cap x 16 bytes fit what a block may opt into,
// 227 KB on the H100, that is budgets up to 7,263 pops; past that in a
// second global scratch slice of the query, cap x 4 int32, so that no
// budget is refused). A round is the plain version's round:
//   1. the lanes scan the used slots for the heaviest alive one (the first
//      by slot among equals) and reduce over the warp;
//   2. the query stops for good when that weight is <= 0 or k answers are
//      out (a stopped round changes nothing, so the warp leaves the loop);
//   3. a leaf is the next answer; an internal node's shard intervals split
//      on their level's rows, the shards dealt over the lanes, two rank
//      probes a non-empty interval (an empty one stays empty, with weight
//      0, whatever its positions), into two new slots;
//   4. the popped slot retires, and with ``prune`` every alive slot whose
//      weight is below the need-th largest lower bound ceil(weight /
//      leaves below) of the frontier retires too (need = k - answers).
// The rank probe is wm_quantile.cu's: a block's four words in one 16-byte
// load beside its superblock and block entries.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const int32_t* los;     // (Q, S) local ranges
  const int32_t* his;
  int Q, S;
  const int32_t* words;   // (S * nbits, words_stride)
  long long words_stride;
  const int32_t* super;
  long long super_stride;
  const int16_t* block;
  long long block_stride;
  int nblocks;
  const int32_t* zeros;   // (S * nbits,)
  int nbits, k, budget, cap, prune;
  int32_t* scratch;       // (Q, cap, S, 2) intervals
  int32_t* slots;         // (Q, 4, cap) slot fields, or null: shared
  int32_t* out_syms;      // (Q, k)
  int32_t* out_cnts;      // (Q, k)
  int32_t* out_found;     // (Q,)
};

__device__ __forceinline__ int rank1(const Params& p, long long row,
                                     int pos) {
  const int bc = min(pos >> 7, p.nblocks - 1);
  const int4 q = __ldg(
      reinterpret_cast<const int4*>(p.words + row * p.words_stride) + bc);
  int rank = __ldg(p.super + row * p.super_stride + (bc >> 3)) +
             static_cast<uint16_t>(__ldg(p.block + row * p.block_stride + bc));
  const uint32_t v[4] = {static_cast<uint32_t>(q.x),
                         static_cast<uint32_t>(q.y),
                         static_cast<uint32_t>(q.z),
                         static_cast<uint32_t>(q.w)};
  const uint32_t partial = (1u << (pos & 31)) - 1u;
  const int w = pos >> 5;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (4 * bc + j < w) rank += __popc(v[j]);
    else if (4 * bc + j == w) rank += __popc(v[j] & partial);
  }
  return rank;
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(kFull, x, d);
  return x;
}

__device__ __forceinline__ long long warp_max(long long x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const long long y = __shfl_xor_sync(kFull, x, d);
    x = y > x ? y : x;
  }
  return x;
}

__global__ void topk_greedy_kernel(const Params p) {
  extern __shared__ int smem[];
  const int q = blockIdx.x;
  int* sw = p.slots ? p.slots + static_cast<long long>(q) * 4 * p.cap
                    : smem;             // weight
  int* ssym = sw + p.cap;               // symbol prefix
  int* slev = ssym + p.cap;             // level
  int* salive = slev + p.cap;           // alive (0/1)
  const int lane = threadIdx.x;
  const int S = p.S;
  int32_t* iv = p.scratch + static_cast<long long>(q) * p.cap * S * 2;

  for (int j = lane; j < p.k; j += 32) {
    p.out_syms[static_cast<long long>(q) * p.k + j] = -1;
    p.out_cnts[static_cast<long long>(q) * p.k + j] = 0;
  }
  int w0 = 0;
  for (int s = lane; s < S; s += 32) {
    const int lo = p.los[static_cast<long long>(q) * S + s];
    const int hi = p.his[static_cast<long long>(q) * S + s];
    iv[2 * s] = lo;
    iv[2 * s + 1] = hi;
    w0 += hi - lo;
  }
  w0 = warp_sum(w0);
  if (lane == 0) {
    sw[0] = w0;
    ssym[0] = 0;
    slev[0] = 0;
    salive[0] = 1;
  }
  __syncwarp();
  int nslots = 1, nout = 0;
  const int kk = min(p.k, p.cap);

  for (int it = 0; it < p.budget; ++it) {
    // 1. the heaviest alive slot, the first among equals
    const int used = min(nslots, p.cap);
    int bw = -1, bi = 0x7fffffff;
    for (int j = lane; j < used; j += 32) {
      const int wj = salive[j] ? sw[j] : -1;
      if (wj > bw) {
        bw = wj;
        bi = j;
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const int ow = __shfl_xor_sync(kFull, bw, d);
      const int oi = __shfl_xor_sync(kFull, bi, d);
      if (ow > bw || (ow == bw && oi < bi)) {
        bw = ow;
        bi = oi;
      }
    }
    // 2. a stopped query stays stopped
    if (bw <= 0 || nout >= p.k) break;
    const int best = bi;
    const int level = slev[best];
    const int sym = ssym[best];

    if (level == p.nbits) {
      // 3a. a leaf: the next answer
      if (lane == 0) {
        const long long o = static_cast<long long>(q) * p.k + min(nout, p.k - 1);
        p.out_syms[o] = sym;
        p.out_cnts[o] = bw;
      }
      ++nout;
    } else {
      // 3b. two children on the node's level
      const int a = min(nslots, p.cap - 2), b = a + 1;
      const int32_t* src = iv + static_cast<long long>(best) * S * 2;
      int32_t* d0 = iv + static_cast<long long>(a) * S * 2;
      int32_t* d1 = iv + static_cast<long long>(b) * S * 2;
      int c0 = 0, c1 = 0;
      for (int s = lane; s < S; s += 32) {
        const int lo = src[2 * s], hi = src[2 * s + 1];
        int lo0 = 0, hi0 = 0, lo1 = 0, hi1 = 0;
        if (hi > lo) {
          const long long row = static_cast<long long>(s) * p.nbits + level;
          const int rl = rank1(p, row, lo), rh = rank1(p, row, hi);
          const int z = __ldg(p.zeros + row);
          lo0 = lo - rl;
          hi0 = hi - rh;
          lo1 = z + rl;
          hi1 = z + rh;
        }
        d0[2 * s] = lo0;
        d0[2 * s + 1] = hi0;
        d1[2 * s] = lo1;
        d1[2 * s + 1] = hi1;
        c0 += hi0 - lo0;
        c1 += hi1 - lo1;
      }
      c0 = warp_sum(c0);
      c1 = warp_sum(c1);
      if (lane == 0) {
        sw[a] = c0;
        ssym[a] = sym << 1;
        slev[a] = level + 1;
        salive[a] = 1;
        sw[b] = c1;
        ssym[b] = (sym << 1) | 1;
        slev[b] = level + 1;
        salive[b] = 1;
      }
      nslots += 2;
    }
    __syncwarp();
    // 4. the popped slot retires
    if (lane == 0) salive[best] = 0;
    __syncwarp();
    const int need = p.k - nout;
    if (p.prune && need > 0 && need <= kk) {
      // the need-th largest lower bound over the cap slots (dead: -1)
      const int used2 = min(nslots, p.cap);
      long long prev = 0x7fffffffffffffffLL, thresh = -1;
      int remaining = need;
      while (true) {
        long long v = -2;
        for (int j = lane; j < used2; j += 32) {
          if (!salive[j]) continue;
          const long long leaves = 1LL << max(p.nbits - slev[j], 0);
          const long long lb = (sw[j] + leaves - 1) / leaves;
          if (lb < prev && lb > v) v = lb;
        }
        v = warp_max(v);
        if (v < 0) break;                 // fewer alive than need: -1
        int c = 0;
        for (int j = lane; j < used2; j += 32) {
          if (!salive[j]) continue;
          const long long leaves = 1LL << max(p.nbits - slev[j], 0);
          if ((sw[j] + leaves - 1) / leaves == v) ++c;
        }
        c = warp_sum(c);
        if (c >= remaining) {
          thresh = v;
          break;
        }
        remaining -= c;
        prev = v;
      }
      for (int j = lane; j < used2; j += 32) {
        if (salive[j] && sw[j] < thresh) salive[j] = 0;
      }
      __syncwarp();
    }
  }
  if (lane == 0) p.out_found[q] = nout;
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// los/his: (Q, S) int32 local ranges. words/superblock/block/zeros: the
// quantile kernel's operands (row s*nbits + l is level l of shard s).
// scratch: Q * cap * (2 * S + 4) int32 with cap = 2 * budget + 1 (the
// intervals, then the slot fields where they do not fit shared memory).
// out_syms, out_cnts: (Q, k) int32; out_found: (Q,) int32.
extern "C" int topk_greedy(
    const void* los, const void* his, int Q, int S, const void* words,
    long long words_stride, const void* superblock, long long super_stride,
    const void* block, long long block_stride, int nblocks,
    const void* zeros, int nbits, int k, int budget, int prune,
    void* scratch, void* out_syms, void* out_cnts, void* out_found,
    void* stream) {
  const long long cap = 2LL * budget + 1;
  long long smem = cap * 4 * static_cast<long long>(sizeof(int));
  if (Q < 0 || S <= 0 || nbits <= 0 || nbits > 30 || k <= 0 ||
      budget <= 0 || cap > 0x7fffffffLL || nblocks <= 0 ||
      (Q > 0 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (Q > 0) {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    int32_t* slots = nullptr;
    if (smem > optin) {
      // the slot fields after every query's intervals
      slots = static_cast<int32_t*>(scratch) + Q * cap * S * 2;
      smem = 0;
    } else if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(topk_greedy_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    Params p;
    p.los = static_cast<const int32_t*>(los);
    p.his = static_cast<const int32_t*>(his);
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
    p.k = k;
    p.budget = budget;
    p.cap = static_cast<int>(cap);
    p.prune = prune;
    p.scratch = static_cast<int32_t*>(scratch);
    p.slots = slots;
    p.out_syms = static_cast<int32_t*>(out_syms);
    p.out_cnts = static_cast<int32_t*>(out_cnts);
    p.out_found = static_cast<int32_t*>(out_found);
    topk_greedy_kernel<<<Q, 32, static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
