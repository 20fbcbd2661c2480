// One segmented wavelet-tree level over R rows of narrow keys: the level's
// bit, the LSB-first packed bitmap (zero past n), and every element's
// destination under the stable per-node 0/1 partition, i.e. the stable sort
// by bucket (nid << 1) | bit, with nbkt = 2^(l+1) <= 512 buckets.
//
// Replaces repro/kernels/wt_level.py:wt_level_fused_pallas. The Pallas form
// carries the per-block (node, bit) histograms in VMEM scratch across a
// sequential (2, nblocks) grid; CUDA blocks have no order, so the level is a
// count launch (wt_counts), the offsets' scan in torch, and an apply launch
// (wt_apply), on the blocked stable bucket rank of bucket_rank.cuh.
// In the apply warp, round r covers keys 32r..32r+31 of the tile, so
// __ballot_sync of the bits in that round is bitmap word r of the tile.
//
// Bound on the H100: bytes. Per key 4 B of key and 4 B of node id are read,
// 4 B of destination and 1/8 B of bitmap written; the (tiles, nbkt+1)
// histogram and its offsets add 4 (nbkt+1) / 1024 B per key at each pass
// (2 B at l = 8). The count phase reads the keys and node ids a second time.
#include "bucket_rank.cuh"

namespace {

using bucket_rank::kApplyWarps;
using bucket_rank::kFull;
using bucket_rank::kMaxBuckets;
using bucket_rank::kTile;

struct Level {
  const int32_t* sub;
  const int32_t* nid;
  int n, shift, nbkt;

  __device__ __forceinline__ unsigned bit(long long i) const {
    return (static_cast<uint32_t>(sub[i]) >> shift) & 1u;
  }
  __device__ __forceinline__ int key(long long i, unsigned b) const {
    return i < n ? bucket_rank::clamp_key((nid[i] << 1) | static_cast<int>(b),
                                          nbkt)
                 : nbkt;
  }
};

__global__ void wt_counts_kernel(const int32_t* __restrict__ sub,
                                 const int32_t* __restrict__ nid, int n,
                                 long long sub_stride, long long nid_stride,
                                 int shift, int nbkt, int nb,
                                 int32_t* __restrict__ hist) {
  const long long row = blockIdx.x / nb;
  const int tile = blockIdx.x % nb;
  const Level lv{sub + row * sub_stride, nid + row * nid_stride, n, shift,
                 nbkt};
  const long long i = static_cast<long long>(tile) * kTile + threadIdx.x;
  const unsigned b = i < n ? lv.bit(i) : 0u;
  bucket_rank::tile_histogram(lv.key(i, b), nbkt + 1,
                              hist + (row * nb + tile) * (nbkt + 1));
}

__global__ void wt_apply_kernel(const int32_t* __restrict__ sub,
                                const int32_t* __restrict__ nid, int rows,
                                int n, long long sub_stride,
                                long long nid_stride, int shift, int nbkt,
                                int nb, const int32_t* __restrict__ offsets,
                                int32_t* __restrict__ dest,
                                long long dest_stride,
                                int32_t* __restrict__ bitmap, int W,
                                long long bitmap_stride) {
  __shared__ int counters[kApplyWarps][kMaxBuckets + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long t = static_cast<long long>(blockIdx.x) * kApplyWarps + warp;
  if (t >= static_cast<long long>(rows) * nb) return;  // whole warp leaves
  const long long row = t / nb;
  const int tile = static_cast<int>(t % nb);
  const int nb1 = nbkt + 1;
  const Level lv{sub + row * sub_stride, nid + row * nid_stride, n, shift,
                 nbkt};
  bucket_rank::TileRanker ranker{counters[warp]};
  ranker.seed(offsets + t * nb1, nb1, lane);
  int32_t* out = dest + row * dest_stride;
  unsigned my_word = 0;
  for (int r = 0; r < 32; ++r) {
    const long long i = static_cast<long long>(tile) * kTile + r * 32 + lane;
    const bool valid = i < n;
    const unsigned b = valid ? lv.bit(i) : 0u;
    const unsigned word = __ballot_sync(kFull, b);
    if (lane == r) my_word = word;
    const int d = ranker.rank(lv.key(i, b), lane);
    if (valid) out[i] = d;
  }
  const long long w = static_cast<long long>(tile) * 32 + lane;
  if (w < W) bitmap[row * bitmap_stride + w] = static_cast<int32_t>(my_word);
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// sub, nid: (rows, *_stride) int32, the first n of each row used; hist:
// (rows, nb, nbkt + 1) int32, nb = ceil(n / 1024).
extern "C" int wt_counts(const void* sub, const void* nid, int rows, int n,
                         long long sub_stride, long long nid_stride, int shift,
                         int nbkt, void* hist, int nb, void* stream) {
  if (nbkt < 1 || nbkt > kMaxBuckets)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = static_cast<long long>(rows) * nb;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (grid > 0) {
    wt_counts_kernel<<<static_cast<unsigned>(grid), kTile, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(sub), static_cast<const int32_t*>(nid), n,
        sub_stride, nid_stride, shift, nbkt, nb, static_cast<int32_t*>(hist));
  }
  return static_cast<int>(cudaGetLastError());
}

// offsets: (rows, nb, nbkt + 1) int32, bucket base plus the bucket's count in
// earlier tiles; dest: (rows, dest_stride) int32; bitmap: (rows,
// bitmap_stride) int32 with W = ceil(n / 32) words written per row.
extern "C" int wt_apply(const void* sub, const void* nid, int rows, int n,
                        long long sub_stride, long long nid_stride, int shift,
                        int nbkt, int nb, const void* offsets, void* dest,
                        long long dest_stride, void* bitmap, int W,
                        long long bitmap_stride, void* stream) {
  if (nbkt < 1 || nbkt > kMaxBuckets)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = static_cast<long long>(rows) * nb;
  const long long grid = (tiles + kApplyWarps - 1) / kApplyWarps;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (grid > 0) {
    wt_apply_kernel<<<static_cast<unsigned>(grid), kApplyWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(sub), static_cast<const int32_t*>(nid),
        rows, n, sub_stride, nid_stride, shift, nbkt, nb,
        static_cast<const int32_t*>(offsets), static_cast<int32_t*>(dest),
        dest_stride,
        static_cast<int32_t*>(bitmap), W, bitmap_stride);
  }
  return static_cast<int>(cudaGetLastError());
}
