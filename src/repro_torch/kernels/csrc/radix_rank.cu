// Blocked stable counting rank over R rows of digits: the destination of
// every digit under a stable sort of its row (the paper's big-node stable
// integer sort).
//
// Replaces repro/kernels/radix_rank.py:radix_hist_pallas (radix_hist) and
// radix_apply_pallas (radix_apply). The Pallas apply takes the in-tile stable
// rank from a 1024 x (B+1) one-hot cumsum held in VMEM; here one warp walks
// the tile in 32 ordered rounds with __match_any_sync and a per-bucket counter
// in shared memory (bucket_rank.cuh), so no one-hot exists anywhere.
//
// Bound on the H100: bytes. Per digit 4 B are read and 4 B of destination
// written; the (tiles, B+1) histogram and its offsets add about 1 B per digit
// at each pass at B = 256. The count phase reads the digits a second time.
#include "bucket_rank.cuh"

namespace {

using bucket_rank::kApplyWarps;
using bucket_rank::kMaxBuckets;
using bucket_rank::kTile;

__device__ __forceinline__ int digit_at(const int32_t* row, long long i, int n,
                                        int num_buckets) {
  return i < n ? bucket_rank::clamp_key(row[i], num_buckets) : num_buckets;
}

__global__ void radix_hist_kernel(const int32_t* __restrict__ digits, int n,
                                  long long stride, int num_buckets, int nb,
                                  int32_t* __restrict__ hist) {
  const long long row = blockIdx.x / nb;
  const int tile = blockIdx.x % nb;
  const long long i = static_cast<long long>(tile) * kTile + threadIdx.x;
  const int nb1 = num_buckets + 1;
  bucket_rank::tile_histogram(digit_at(digits + row * stride, i, n, num_buckets),
                              nb1, hist + (row * nb + tile) * nb1);
}

__global__ void radix_apply_kernel(const int32_t* __restrict__ digits, int rows,
                                   int n, long long stride, int num_buckets,
                                   int nb, const int32_t* __restrict__ offsets,
                                   int32_t* __restrict__ dest,
                                   long long dest_stride) {
  __shared__ int counters[kApplyWarps][kMaxBuckets + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long t = static_cast<long long>(blockIdx.x) * kApplyWarps + warp;
  if (t >= static_cast<long long>(rows) * nb) return;  // whole warp leaves
  const long long row = t / nb;
  const int tile = static_cast<int>(t % nb);
  const int nb1 = num_buckets + 1;
  bucket_rank::TileRanker ranker{counters[warp]};
  ranker.seed(offsets + t * nb1, nb1, lane);
  const int32_t* src = digits + row * stride;
  int32_t* out = dest + row * dest_stride;
  for (int r = 0; r < 32; ++r) {
    const long long i = static_cast<long long>(tile) * kTile + r * 32 + lane;
    const int d = ranker.rank(digit_at(src, i, n, num_buckets), lane);
    if (i < n) out[i] = d;
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// digits: (rows, stride) int32, the first n of each row used;
// hist: (rows, nb, num_buckets + 1) int32, nb = ceil(n / 1024).
extern "C" int radix_hist(const void* digits, int rows, int n, long long stride,
                          int num_buckets, void* hist, int nb, void* stream) {
  if (num_buckets < 1 || num_buckets > kMaxBuckets)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = static_cast<long long>(rows) * nb;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (grid > 0) {
    radix_hist_kernel<<<static_cast<unsigned>(grid), kTile, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(digits), n, stride, num_buckets, nb,
        static_cast<int32_t*>(hist));
  }
  return static_cast<int>(cudaGetLastError());
}

// offsets: (rows, nb, num_buckets + 1) int32, bucket base plus the bucket's
// count in earlier tiles; dest: (rows, dest_stride) int32.
extern "C" int radix_apply(const void* digits, int rows, int n,
                           long long stride, int num_buckets, int nb,
                           const void* offsets, void* dest,
                           long long dest_stride, void* stream) {
  if (num_buckets < 1 || num_buckets > kMaxBuckets)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = static_cast<long long>(rows) * nb;
  const long long grid = (tiles + kApplyWarps - 1) / kApplyWarps;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (grid > 0) {
    radix_apply_kernel<<<static_cast<unsigned>(grid), kApplyWarps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(digits), rows, n, stride, num_buckets, nb,
        static_cast<const int32_t*>(offsets), static_cast<int32_t*>(dest),
        dest_stride);
  }
  return static_cast<int>(cudaGetLastError());
}
