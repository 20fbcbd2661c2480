// Greedy global range top-k over S stacked wavelet-matrix shards: the
// serving front-end's degraded top-k, every round of a query's frontier in
// one launch.
//
// No Pallas counterpart: the reference runs this op (``repro.analytics.
// range_ops.topk_frontier``) as an XLA loop. The port's plain version is a
// loop of eager torch ops, about 75 launches a round and a host sync every
// eighth round.
//
// Work: a block serves one query, a thread a shard (min(S, 256) threads
// rounded to whole warps, each past that taking every 256th shard). A
// frontier slot is a node of the matrix: its per-shard intervals, its
// weight (summed width), symbol prefix, level and whether it is alive. A
// round is the plain version's round:
//   1. the heaviest alive slot (the first by slot among equals);
//   2. the query stops for good when that weight is <= 0 or k answers are
//      out (a stopped round changes nothing, so the block leaves the loop);
//   3. a leaf is the next answer; an internal node's intervals split on
//      their level's rows, each thread its own shards, every shard's two
//      rank probes issued at once (an empty interval stays empty, with
//      weight 0, whatever its positions), into two new slots, the
//      children's weights summed by warp reductions and the block's one
//      barrier a split;
//   4. the popped slot retires, and with ``prune`` every alive slot whose
//      weight is below the need-th largest lower bound ceil(weight /
//      leaves below) of the frontier retires too (need = k - answers).
// Every warp runs the frontier on its own copy of the slot fields (16 B a
// slot: weight, symbol, level, alive), so no warp waits for another's scan
// and a leaf round has no barrier: the warps share only the intervals,
// each thread its own shards', and the split's partial sums. A warp finds
// the threshold and the next round's heaviest slot in one pass over its
// slots (their fields four 16-byte loads a lane at a time): each lane
// keeps the kTop largest bounds of its slots in registers, and the warp
// pops the need largest of those lists' heads (a warp max a pop); for need
// over kTop (k > 8) it walks the distinct bounds downwards as the first
// design did. A retiree is lighter than the bound's own slot, so never the
// heaviest: the threshold retires its slots in the next round's pass.
// Layout: the intervals in shared memory as [slot][shard] int2, so that a
// thread reads and writes its own shard's pair without bank conflicts (97
// slots x 128 shards x 8 B = 99 KB at the front-end's budget of 48 pops),
// beside the warps' slot fields (6 KB). Two blocks of that size fit an SM.
// Past what a block may opt into (227 KB on the H100) the intervals and
// the slot fields live in a per-block slice of a global scratch, the grid
// striding over the queries, so that no budget is refused; the wrapper
// keeps that scratch per stream.
// The rank probe is wm_quantile.cu's: a block's four words in one 16-byte
// load beside its superblock and block entries.
//
// Bound on the H100: the pops are sequential, each pop reading the
// children's weights of the pop before, so a query takes at least its pops
// x one dependent DRAM load (337 ns), about 16 us at 48 pops, above the
// bytes a batch moves.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 256;
constexpr int kTop = 8;                 // bounds a lane keeps for the prune
constexpr long long kSpillBytes = 256LL << 20;   // global slices at most

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
  int32_t* scratch;       // per block: the warps' slot fields, the intervals
  long long slice;        // int32 a block's slice, 0: shared memory
  int32_t* out_syms;      // (Q, k)
  int32_t* out_cnts;      // (Q, k)
  int32_t* out_found;     // (Q,)
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

__device__ __forceinline__ int warp_sum(int x) {
  return __reduce_add_sync(kFull, x);
}

// ceil(w / 2^(nbits - level)): the smallest count a leaf below can hold
__device__ __forceinline__ int lower_bound(int w, int level, int nbits) {
  const int sh = max(nbits - level, 0);
  return (w >> sh) + ((w & ((1 << sh) - 1)) != 0);
}

// The need-th largest of the warp's lists of bounds (each lane's kTop
// largest, + 1, descending; 0 is none): need pops of the largest head,
// -1 if the lists hold fewer than need.
__device__ __forceinline__ int pop_threshold(int (&top)[kTop], int need,
                                             int lane) {
  int m = 0;
  for (int r = 0; r < need; ++r) {
    m = static_cast<int>(__reduce_max_sync(kFull,
                                           static_cast<unsigned>(top[0])));
    if (m == 0) return -1;
    const unsigned who = __ballot_sync(kFull, top[0] == m);
    if (lane == __ffs(who) - 1) {
#pragma unroll
      for (int i = 0; i + 1 < kTop; ++i) top[i] = top[i + 1];
      top[kTop - 1] = 0;
    }
  }
  return m - 1;
}

// The need-th largest lower bound of the alive slots (with multiplicity)
// for need over kTop: the distinct bounds walked downwards, a count each;
// -1 if fewer than need are alive.
__device__ int walk_threshold(const int4* slots, int used, int need,
                              int nbits, int lane) {
  int prev = 0x7fffffff, remaining = need;
  while (true) {
    int v = -1;
    for (int j = lane; j < used; j += 32) {
      const int4 f = slots[j];
      if (!f.w) continue;
      const int lb = lower_bound(f.x, f.z, nbits);
      if (lb < prev && lb > v) v = lb;
    }
    v = static_cast<int>(__reduce_max_sync(kFull, static_cast<unsigned>(
        v + 1))) - 1;
    if (v < 0) return -1;
    int c = 0;
    for (int j = lane; j < used; j += 32) {
      const int4 f = slots[j];
      if (f.w && lower_bound(f.x, f.z, nbits) == v) ++c;
    }
    c = warp_sum(c);
    if (c >= remaining) return v;
    remaining -= c;
    prev = v;
  }
}

// Slot fields: x weight, y symbol prefix, z level, w alive (0/1).
__global__ void __launch_bounds__(kMaxThreads)
    topk_greedy_kernel(const Params p) {
  extern __shared__ int4 smem4[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int S = p.S, cap = p.cap, nbits = p.nbits;
  // this warp's own copy of the slot fields: every warp runs the same
  // frontier, so no warp waits for another's scan
  int4* base = p.slice ? reinterpret_cast<int4*>(p.scratch +
                                                 blockIdx.x * p.slice)
                       : smem4;
  int4* slots = base + static_cast<long long>(warp) * cap;
  int2* iv = reinterpret_cast<int2*>(base + static_cast<long long>(nwarps) *
                                                cap);      // [slot][shard]
  // the warps' partial sums, two buffers by the parity of the splits: a
  // fast warp may write the next split's while a slow one reads this one's
  int* spart = reinterpret_cast<int*>(smem4) +
               (p.slice ? 0 : (nwarps * cap * 4 + cap * S * 2));
  const int kk = min(p.k, cap);

  for (int q = blockIdx.x; q < p.Q; q += gridDim.x) {   // block-uniform
    const long long qk = static_cast<long long>(q) * p.k;
    for (int j = tid; j < p.k; j += blockDim.x) {
      p.out_syms[qk + j] = -1;
      p.out_cnts[qk + j] = 0;
    }
    int w0 = 0;
    for (int s = tid; s < S; s += blockDim.x) {
      const long long o = static_cast<long long>(q) * S + s;
      const int lo = p.los[o], hi = p.his[o];
      iv[s] = make_int2(lo, hi);
      w0 += hi - lo;
    }
    // the second buffer: the first split writes the first while a slow
    // warp may still read this
    w0 = warp_sum(w0);
    if (lane == 0) spart[64 + 2 * warp] = w0;
    __syncthreads();
    w0 = warp_sum(lane < nwarps ? spart[64 + 2 * lane] : 0);
    if (lane == 0) slots[0] = make_int4(w0, 0, 0, 1);
    __syncwarp();
    // the last prune's threshold, pending over the slots below
    // ``kill_below`` (those that existed when it was found)
    int nslots = 1, nout = 0, thresh = -1, kill_below = 0, splits = 0;

    for (int it = 0;; ++it) {
      // 1 and 4 in one pass over this warp's slots: the last prune's
      // retirees go, the heaviest alive slot (the first among equals) is
      // found, and, where the last round prunes, the lanes' lists of
      // bounds fill. The threshold found here retires nothing heavier than
      // the heaviest slot, so it may wait for the next pass.
      const int used = min(nslots, cap);
      const int need = p.k - nout;
      const bool prune = it > 0 && p.prune && need > 0 && need <= kk;
      const bool lists = prune && need <= kTop;
      int top[kTop];
#pragma unroll
      for (int i = 0; i < kTop; ++i) top[i] = 0;
      int bw = -1, bi = 0x7fffffff;
      for (int j0 = 0; j0 < used; j0 += 128) {
        int4 f[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + 32 * u + lane;
          f[u] = j < used ? slots[j] : make_int4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + 32 * u + lane;
          if (!f[u].w) continue;
          if (j < kill_below && f[u].x < thresh) {
            slots[j].w = 0;
            continue;
          }
          if (f[u].x > bw) {
            bw = f[u].x;
            bi = j;
          }
          if (lists) {
            int x = lower_bound(f[u].x, f[u].z, nbits) + 1;
#pragma unroll
            for (int i = 0; i < kTop; ++i) {
              const int hi = max(top[i], x);
              x = min(top[i], x);
              top[i] = hi;
            }
          }
        }
      }
      const int mw = static_cast<int>(__reduce_max_sync(
          kFull, static_cast<unsigned>(bw + 1))) - 1;
      const int best = static_cast<int>(__reduce_min_sync(
          kFull, static_cast<unsigned>(bw == mw ? bi : 0x7fffffff)));
      thresh = -1;
      if (lists) {
        thresh = pop_threshold(top, need, lane);
      } else if (prune) {
        __syncwarp();
        thresh = walk_threshold(slots, used, need, nbits, lane);
      }
      kill_below = used;
      // 2. a stopped query stays stopped
      if (it >= p.budget || mw <= 0 || nout >= p.k) break;
      const int4 node = slots[best];
      const int level = node.z, sym = node.y;

      if (level == nbits) {
        // 3a. a leaf: the next answer
        if (tid == 0) {
          const long long o = qk + min(nout, p.k - 1);
          p.out_syms[o] = sym;
          p.out_cnts[o] = mw;
        }
        ++nout;
      } else {
        // 3b. two children on the node's level; a thread reads and writes
        // its own shards' intervals only
        const int a = min(nslots, cap - 2), b = a + 1;
        const int2* src = iv + static_cast<long long>(best) * S;
        int2* d0 = iv + static_cast<long long>(a) * S;
        int2* d1 = iv + static_cast<long long>(b) * S;
        int c0 = 0, c1 = 0;
        for (int s = tid; s < S; s += blockDim.x) {
          const int2 r = src[s];
          int2 z0 = make_int2(0, 0), z1 = make_int2(0, 0);
          if (r.y > r.x) {
            const long long row = static_cast<long long>(s) * nbits + level;
            Probe pl, ph;
            load_probe(p, row, r.x, pl);
            load_probe(p, row, r.y, ph);
            const int z = __ldg(p.zeros + row);
            const int rl = rank_probe(pl, r.x, p.nblocks);
            const int rh = rank_probe(ph, r.y, p.nblocks);
            z0 = make_int2(r.x - rl, r.y - rh);
            z1 = make_int2(z + rl, z + rh);
          }
          d0[s] = z0;
          d1[s] = z1;
          c0 += z0.y - z0.x;
          c1 += z1.y - z1.x;
        }
        int* part = spart + 64 * (splits & 1);
        c0 = warp_sum(c0);
        c1 = warp_sum(c1);
        if (lane == 0) {
          part[2 * warp] = c0;
          part[2 * warp + 1] = c1;
        }
        __syncthreads();
        c0 = warp_sum(lane < nwarps ? part[2 * lane] : 0);
        c1 = warp_sum(lane < nwarps ? part[2 * lane + 1] : 0);
        if (lane == 0) {
          slots[a] = make_int4(c0, sym << 1, level + 1, 1);
          slots[b] = make_int4(c1, (sym << 1) | 1, level + 1, 1);
        }
        nslots += 2;
        ++splits;
      }
      // 4. the popped slot retires (the prune follows in the next pass)
      if (lane == 0) slots[best].w = 0;
      __syncwarp();
    }
    if (tid == 0) p.out_found[q] = nout;
    __syncthreads();              // the next query reuses shared memory
  }
}

// Threads a block, shared bytes and int32 of global scratch a block (0:
// everything in shared memory) for S shards and ``cap`` slots: the warps'
// copies of the slot fields (16 B a slot), the intervals (8 B a slot and
// shard), then the partial sums (128 int32, in shared memory always).
void plan(int S, long long cap, int optin, int& threads, long long& smem,
          long long& slice) {
  threads = min(kMaxThreads, (S + 31) / 32 * 32);
  const long long body = (threads / 32) * cap * 4 + cap * S * 2;  // int32
  smem = (body + 128) * 4;
  slice = 0;
  if (smem > optin) {
    slice = (body + 3) & ~3LL;          // whole int4s a block
    smem = 128 * 4;
  }
}

cudaError_t optin_bytes(int& optin) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return e;
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The global scratch a launch of Q queries over S shards at ``budget``
// needs: out[0] int32 elements (0 when everything fits shared memory),
// out[1] threads a block, out[2] shared bytes a block, out[3] blocks.
extern "C" int topk_greedy_plan(int Q, int S, int budget, void* out) {
  long long* o = static_cast<long long*>(out);
  const long long cap = 2LL * budget + 1;
  if (Q < 0 || S <= 0 || budget <= 0 || cap > 0x3fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int optin = 0;
  const cudaError_t e = optin_bytes(optin);
  if (e != cudaSuccess) return static_cast<int>(e);
  int threads = 0;
  long long smem = 0, slice = 0;
  plan(S, cap, optin, threads, smem, slice);
  long long blocks = Q;
  if (slice) {
    blocks = min(static_cast<long long>(Q),
                 max(1LL, kSpillBytes / (4 * slice)));
  }
  o[0] = slice * blocks;
  o[1] = threads;
  o[2] = smem;
  o[3] = blocks;
  return 0;
}

// los/his: (Q, S) int32 local ranges. words/superblock/block/zeros: the
// quantile kernel's operands (row s*nbits + l is level l of shard s).
// scratch: topk_greedy_plan's out[0] int32 (scratch_elems of them), null
// when that is 0. out_syms, out_cnts: (Q, k) int32; out_found: (Q,) int32.
extern "C" int topk_greedy(
    const void* los, const void* his, int Q, int S, const void* words,
    long long words_stride, const void* superblock, long long super_stride,
    const void* block, long long block_stride, int nblocks,
    const void* zeros, int nbits, int k, int budget, int prune,
    void* scratch, long long scratch_elems, void* out_syms, void* out_cnts,
    void* out_found, void* stream) {
  const long long cap = 2LL * budget + 1;
  if (Q < 0 || S <= 0 || nbits <= 0 || nbits > 30 || k <= 0 ||
      budget <= 0 || cap > 0x3fffffffLL || nblocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (Q == 0) return static_cast<int>(cudaGetLastError());
  int optin = 0;
  cudaError_t e = optin_bytes(optin);
  if (e != cudaSuccess) return static_cast<int>(e);
  int threads = 0;
  long long smem = 0, slice = 0;
  plan(S, cap, optin, threads, smem, slice);
  long long blocks = Q;
  if (slice) {
    blocks = min(static_cast<long long>(Q),
                 max(1LL, kSpillBytes / (4 * slice)));
    if (scratch == nullptr || scratch_elems < slice * blocks) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  // the kernel's shared-memory attribute as last set (launches may come
  // from several host threads; setting it twice is harmless)
  static std::atomic<long long> opted{48 * 1024};
  if (smem > opted.load()) {
    e = cudaFuncSetAttribute(topk_greedy_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    long long seen = opted.load();
    while (seen < smem && !opted.compare_exchange_weak(seen, smem)) {
    }
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
  p.slice = slice;
  p.out_syms = static_cast<int32_t*>(out_syms);
  p.out_cnts = static_cast<int32_t*>(out_cnts);
  p.out_found = static_cast<int32_t*>(out_found);
  topk_greedy_kernel<<<static_cast<int>(blocks), threads,
                       static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
