// Global range count over S stacked wavelet-matrix shards: the symbols in
// [sym_lo, sym_hi) within each query's local ranges, summed over the
// shards, in one launch.
//
// No Pallas counterpart: the reference counts through XLA
// (``repro.analytics.engine.sharded_range_count``, two count-below
// descents a shard). The port's plain version is those descents in eager
// torch, about 1,800 launches a batch of the serving front-end on the H100
// (tens of milliseconds of host time against a 250 ms deadline).
//
// Work: one thread a (query, shard) pair, so a shard's two descents (below
// sym_hi and below sym_lo) run side by side: at each level the thread
// issues the four rank probes (both endpoints of both intervals) before it
// uses any, then steps each interval into the child that the bound's bit
// names, adding the zero child's width where the bit is 1. A pair with an
// empty local range (a shard the query does not cover, or a masked one)
// probes nothing. The shard's count max(0, below(sym_hi) - below(sym_lo))
// goes into the query's total by an integer atomicAdd, so the order of the
// shards does not change the sum. The rank probe is wm_quantile.cu's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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
  int32_t* out;           // (Q,), zeroed by the caller
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

__global__ void __launch_bounds__(kThreads)
    wm_count_kernel(const Params p) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (t >= static_cast<long long>(p.Q) * p.S) return;
  const int q = static_cast<int>(t / p.S);
  const int s = static_cast<int>(t - static_cast<long long>(q) * p.S);
  const int lo = p.los[t], hi = p.his[t];
  if (hi <= lo) return;
  const int top = 1 << p.nbits;
  // the two bounds, clamped into [0, 2^nbits]; at 2^nbits every symbol is
  // below the bound
  int bound[2] = {min(max(p.sym_hi[q], 0), top), min(max(p.sym_lo[q], 0), top)};
  int plo[2] = {lo, lo}, phi[2] = {hi, hi}, acc[2] = {0, 0};
  for (int l = 0; l < p.nbits; ++l) {
    const long long row = static_cast<long long>(s) * p.nbits + l;
    int rl[2], rh[2];
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      rl[b] = rank1(p, row, plo[b]);
      rh[b] = rank1(p, row, phi[b]);
    }
    const int z = __ldg(p.zeros + row);
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int lo0 = plo[b] - rl[b], hi0 = phi[b] - rh[b];
      if ((bound[b] >> (p.nbits - 1 - l)) & 1) {
        acc[b] += hi0 - lo0;
        plo[b] = z + rl[b];
        phi[b] = z + rh[b];
      } else {
        plo[b] = lo0;
        phi[b] = hi0;
      }
    }
  }
  const int below_hi = bound[0] >= top ? hi - lo : acc[0];
  const int below_lo = bound[1] >= top ? hi - lo : acc[1];
  const int c = below_hi - below_lo;
  if (c > 0) atomicAdd(p.out + q, c);
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// los/his: (Q, S) int32 local ranges; sym_lo/sym_hi: (Q,) int32.
// words/superblock/block/zeros: the quantile kernel's operands (row
// s*nbits + l is level l of shard s). out: (Q,) int32, zeroed first on the
// stream.
extern "C" int wm_count_sharded(
    const void* los, const void* his, const void* sym_lo, const void* sym_hi,
    int Q, int S, const void* words, long long words_stride,
    const void* superblock, long long super_stride, const void* block,
    long long block_stride, int nblocks, const void* zeros, int nbits,
    void* out, void* stream) {
  if (Q < 0 || S <= 0 || nbits <= 0 || nbits > 30 || nblocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int32_t) * Q, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long pairs = static_cast<long long>(Q) * S;
  if (pairs > 0) {
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
    const long long grid = (pairs + kThreads - 1) / kThreads;
    wm_count_kernel<<<static_cast<int>(grid), kThreads, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
