// Stable counting rank over R rows of digits: the destination of every digit
// under a stable sort of its row (the paper's big-node stable integer sort).
// A stable counting sort gives digit i of bucket d the destination
//   start[d] + (count of d in earlier tiles) + (count of d earlier in i's
//   tile).
//
// Replaces repro/kernels/radix_rank.py:radix_hist_pallas and
// radix_apply_pallas. The Pallas forms carry the per-bucket counts of
// earlier tiles through a sequential grid; Hopper has no ordered grid.
//
// The build path (ops.radix_rank) is one sweep in the manner of Merrill and
// Adinets' "Onesweep" (NVIDIA 2022), written here:
//   - radix_scan, one launch given every row's bucket starts: tiles of
//     kScanTile = 8,192 digits, one per block of kScanWarps = 8 warps, tile
//     ids from an atomic counter in row-major launch order;
//       - the tile's digits go to shared memory by 16-byte cp.async copies
//         (no registers hold them in flight);
//       - each warp ranks its 1,024 digits in the 32 ordered rounds of
//         bucket_rank.cuh (peer masks), its counters starting at 0;
//       - the per-warp counts are scanned over the warps: each warp's
//         offset in the tile, and the tile's histogram;
//       - thread b publishes bucket b's tile count in a 32-bit status word
//         (2 flag bits, a 30-bit count; tile-major, so a block's words are
//         contiguous) and walks back on bucket b (look_back.cuh,
//         look_back_column) until it finds an inclusive prefix, for every
//         kScanThreads-th bucket up to 512;
//       - every digit is written at its own position, coalesced.
//     The tile and the peer masks are the fastest of a sweep on the H100
//     (launch/sweep_rank_radix.py).
//   - radix_totals, the launch before it when the starts are not given:
//     each block counts 65,536 digits of a row with 16-byte loads and one
//     shared atomic a digit (merging a warp's equal digits first with
//     __match_any_sync was slower in the sweep), then adds one global
//     atomic per (block, bucket); the caller scans the (R, B) totals.
// Positions past n are never written. Digits outside [0, B) read as the
// sentinel bucket B, which has no status word: their destination is -1.
//
// radix_hist and radix_apply are the counterparts of the two Pallas phase
// kernels, off the build path: a count launch of per-1,024-digit-tile
// histograms (B+1 columns, the sentinel last), the offsets' scan in torch,
// and an apply launch given each tile's offsets. An out-of-range digit there
// sorts after every real one. A thread a digit would hold an SM to 8 KB of
// 4-byte loads in flight, under what the card's latency needs, and a
// 1,024-thread block a tile would pay barriers for every 1,024 digits. So in
// both each warp owns one tile, eight warps a block, and no warp waits on
// another: no barrier.
//
// radix_hist is bound by bytes: 4 B of digit read and (B+1) * 4 / 1,024 B
// of histogram written per digit (1 B at B = 256). A lane issues all of its
// eight 16-byte loads before it uses any (4-byte loads only where a row is
// not 16-byte aligned, or at its ragged end), the warp zeroes its own B+1
// counters in shared memory meanwhile, adds one shared atomic a digit (as
// radix_totals does; merging equal digits with __match_any_sync first is
// slower), and writes the counters out coalesced. At 2^27 digits it runs at
// 92% of its bound on the H100 (0.217 ms against 0.200;
// launch/sweep_phase_kernels.py).
//
// radix_apply is bound by bytes too: 4 B of digit read and 4 B of
// destination written per digit, and (B+1) * 4 / 1,024 B of offsets read.
// Its rank must visit a tile's digits in order, while a lane's 16-byte load
// holds four digits of four different rounds, and a warp that walks its
// rounds behind one 4-byte load each keeps 128 B in flight. So a warp first
// puts its whole tile in flight by 16-byte cp.async copies into its slice
// of shared memory, and the tile's B+1 offsets by 4-byte copies into its
// counters, zeroing its peer masks meanwhile; ranks in the 32 ordered rounds
// of bucket_rank.cuh, each destination written back over its digit; and
// stores the slice out with 16-byte stores. A warp's counters start at its
// own tile's offsets, read directly: no look-back, and any offsets give the
// plain version's result, not only those of a scan. Destinations wrap mod
// 2^32, as the plain version's int64 sums cast to int32.
//
// The build path's bound on the H100: bytes. Per digit 4 B are read and
// 4 B of destination written; the status words (B per tile) and the starts
// add under 1/64 B per digit at B = 256. Without starts the totals launch
// reads the digits a second time.
#include "bucket_rank.cuh"
#include "look_back.cuh"
#include "zero_scan.cuh"

namespace {

using bucket_rank::kMaxBuckets;
using bucket_rank::kTile;

__device__ __forceinline__ void copy16_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void copy4_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

// ---- the apply phase -----------------------------------------------------

constexpr int kApplyWarps = bucket_rank::kWarps;   // tiles a block, one a warp
constexpr int kApplySlabs = kTile / 128;           // 16-byte copies a lane

template <bool kVec>
__global__ void __launch_bounds__(kApplyWarps * 32)
    radix_apply_kernel(const int32_t* __restrict__ digits, int n,
                       long long stride, int num_buckets, int nb,
                       long long tiles, const int32_t* __restrict__ offsets,
                       int32_t* __restrict__ dest, long long dest_stride) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long t = static_cast<long long>(blockIdx.x) * kApplyWarps + warp;
  if (t >= tiles) return;                          // the whole warp leaves
  const int B = num_buckets, nb1 = B + 1;
  int* slice = smem + warp * kTile;                // digits, then destinations
  unsigned* cnt = reinterpret_cast<unsigned*>(smem + kApplyWarps * kTile) +
                  warp * nb1;
  unsigned* lanes = cnt + kApplyWarps * nb1;
  const long long row = t / nb;
  const long long first = (t % nb) * kTile;
  const int left = static_cast<int>(min(static_cast<long long>(kTile),
                                         n - first));
  const int32_t* src = digits + row * stride + first;

  // everything in flight at once: the tile, its offsets; the masks zeroed
  if (kVec && left == kTile) {
#pragma unroll
    for (int s = 0; s < kApplySlabs; ++s)
      copy16_async(slice + s * 128 + 4 * lane, src + s * 128 + 4 * lane);
  } else {
#pragma unroll
    for (int k = 0; k < kTile / 32; ++k) {
      const int i = 32 * k + lane;
      slice[i] = i < left ? src[i] : B;
    }
  }
  const int32_t* off = offsets + t * nb1;
  for (int b = lane; b < nb1; b += 32) {
    copy4_async(cnt + b, off + b);
    lanes[b] = 0;
  }
  wait_async();
  __syncwarp();

#pragma unroll 4
  for (int r = 0; r < 32; ++r) {
    int* mine = slice + 32 * r + lane;
    *mine = static_cast<int>(bucket_rank::peer_rank(
        cnt, lanes, bucket_rank::clamp_key(*mine, B), lane));
  }
  __syncwarp();

  int32_t* out = dest + row * dest_stride + first;
#pragma unroll
  for (int s = 0; s < kApplySlabs; ++s) {
    const int i = s * 128 + 4 * lane;
    const int4 v = *reinterpret_cast<const int4*>(slice + i);
    const int d[4] = {v.x, v.y, v.z, v.w};
    zero_scan::store4<kVec>(out, i, left, d);
  }
}

// ---- the one-sweep rank --------------------------------------------------

constexpr int kScanWarps = bucket_rank::kWarps;
constexpr int kScanThreads = kScanWarps * 32;
constexpr int kWarpDigits = kTile;       // 32 rounds of 32 digits
constexpr int kScanTile = kScanWarps * kWarpDigits;
constexpr int kBucketsPerThread =
    (kMaxBuckets + kScanThreads - 1) / kScanThreads;

constexpr int kTotalsThreads = 256;
constexpr int kTotalsLoads = 8;          // 16-byte loads in flight a round
constexpr int kTotalsRounds = 8;
constexpr int kTotalsChunk = kTotalsThreads * kTotalsLoads * kTotalsRounds * 4;

struct ScanParams {
  const int32_t* digits;
  long long stride;
  int n, num_buckets, tiles_per_row;
  const int32_t* starts;         // (rows, starts_stride), B used
  long long starts_stride;
  int32_t* dest;
  long long dest_stride;
  unsigned* status;              // (tiles, B) words, zeroed
  unsigned* next_tile;           // zeroed
};

template <bool kVec>
__global__ void __launch_bounds__(kScanThreads)
    radix_scan_kernel(const ScanParams p) {
  extern __shared__ int smem[];
  __shared__ int s_tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int B = p.num_buckets;
  int* digit = smem;                               // kScanTile
  int* counters = smem + kScanTile;                // [warp][B + 1]
  if (threadIdx.x == 0) s_tile = static_cast<int>(atomicAdd(p.next_tile, 1u));
  for (int i = threadIdx.x; i < 2 * kScanWarps * (B + 1); i += kScanThreads)
    counters[i] = 0;
  __syncthreads();
  const int t = s_tile;
  const int row = t / p.tiles_per_row;
  const int first = row * p.tiles_per_row;
  const int tile_base = (t - first) * kScanTile;
  const int left = p.n - tile_base;                // digits of the row left
  const int32_t* src = p.digits + row * p.stride + tile_base;

  // the tile's digits into shared memory, the sentinel past n
  if (kVec && left >= kScanTile) {
#pragma unroll
    for (int k = 0; k < kScanTile / (4 * kScanThreads); ++k) {
      const int i = 4 * (k * kScanThreads + threadIdx.x);
      copy16_async(digit + i, src + i);
    }
    wait_async();
  } else {
    for (int i = threadIdx.x; i < kScanTile; i += kScanThreads)
      digit[i] = i < left ? src[i] : B;
  }
  int start[kBucketsPerThread];
#pragma unroll
  for (int k = 0; k < kBucketsPerThread; ++k) {
    const int b = threadIdx.x + k * kScanThreads;
    start[k] = b < B ? p.starts[row * p.starts_stride + b] : 0;
  }
  __syncthreads();

  // in-warp ranks: digit 32 r + lane of the warp in round r; each slot then
  // holds its digit and, from bit 16, its rank in the warp's bucket
  int* cnt = counters + warp * (B + 1);
  unsigned* lanes = reinterpret_cast<unsigned*>(
      counters + (kScanWarps + warp) * (B + 1));
  int* mine = digit + warp * kWarpDigits + lane;
#pragma unroll 4
  for (int r = 0; r < 32; ++r) {
    const int d = bucket_rank::clamp_key(mine[32 * r], B);
    const unsigned rank = bucket_rank::peer_rank(
        reinterpret_cast<unsigned*>(cnt), lanes, d, lane);
    mine[32 * r] = d | static_cast<int>(rank) << 16;
  }
  __syncthreads();

  // per bucket: the warps' offsets in the tile, the tile's count, the count
  // in earlier tiles of the row; then every warp's base for the bucket
#pragma unroll
  for (int k = 0; k < kBucketsPerThread; ++k) {
    const int b = threadIdx.x + k * kScanThreads;
    if (b < B) {
      int run = 0;
#pragma unroll
      for (int w = 0; w < kScanWarps; ++w) {
        const int c = counters[w * (B + 1) + b];
        counters[w * (B + 1) + b] = run;
        run += c;
      }
      const int excl =
          lookback::look_back_column(p.status + b, B, t, first, run);
      const int bucket_base = start[k] + excl;
#pragma unroll
      for (int w = 0; w < kScanWarps; ++w)
        counters[w * (B + 1) + b] += bucket_base;
    }
  }
  __syncthreads();

  int32_t* out = p.dest + row * p.dest_stride + tile_base + warp * kWarpDigits;
  const int warp_left = left - warp * kWarpDigits;
#pragma unroll 4
  for (int r = 0; r < 32; ++r) {
    const int v = mine[32 * r];
    const int dig = v & 0xffff;
    if (32 * r + lane < warp_left)
      out[32 * r + lane] = dig < B ? cnt[dig] + (v >> 16) : -1;
  }
}

// Digits i..i+3 of a row as bucket indices: the sentinel past n and for
// digits outside [0, B).
template <bool kVec>
__device__ __forceinline__ void load_digits4(const int32_t* __restrict__ row,
                                             int i, int n, int B,
                                             int (&v)[4]) {
  zero_scan::load4<kVec>(row, i, n, B, v);
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = bucket_rank::clamp_key(v[c], B);
}

constexpr int kHistWarps = 8;            // tiles per block, one a warp
constexpr int kHistSlabs = kTile / 128;  // 16-byte loads a lane

template <bool kVec>
__global__ void __launch_bounds__(kHistWarps * 32)
    radix_hist_kernel(const int32_t* __restrict__ digits, int n,
                      long long stride, int num_buckets, int nb,
                      long long tiles, int32_t* __restrict__ hist) {
  __shared__ int counts[kHistWarps][kMaxBuckets + 1];
  const int lane = threadIdx.x & 31;
  const long long t =
      static_cast<long long>(blockIdx.x) * kHistWarps + (threadIdx.x >> 5);
  if (t >= tiles) return;                          // the whole warp leaves
  const int nb1 = num_buckets + 1;
  int* cnt = counts[threadIdx.x >> 5];
  const long long row = t / nb;
  const long long first = (t % nb) * kTile;
  const int left = static_cast<int>(min(static_cast<long long>(kTile),
                                         n - first));
  const int32_t* src = digits + row * stride + first;
  int v[kHistSlabs][4];
#pragma unroll
  for (int s = 0; s < kHistSlabs; ++s)
    load_digits4<kVec>(src, s * 128 + 4 * lane, left, num_buckets, v[s]);
  for (int b = lane; b < nb1; b += 32) cnt[b] = 0;
  __syncwarp();
#pragma unroll
  for (int s = 0; s < kHistSlabs; ++s) {
#pragma unroll
    for (int c = 0; c < 4; ++c) atomicAdd(cnt + v[s][c], 1);
  }
  __syncwarp();
  int32_t* out = hist + t * nb1;
  for (int b = lane; b < nb1; b += 32) out[b] = cnt[b];
}

template <bool kVec>
__global__ void __launch_bounds__(kTotalsThreads)
    radix_totals_kernel(const int32_t* __restrict__ digits, int n,
                        long long stride, int num_buckets, int chunks,
                        int32_t* __restrict__ totals) {
  __shared__ int hist[kMaxBuckets];
  for (int b = threadIdx.x; b < num_buckets; b += kTotalsThreads) hist[b] = 0;
  __syncthreads();
  const long long row = blockIdx.x / chunks;
  const int chunk = blockIdx.x % chunks;
  const int32_t* src = digits + row * stride;
  for (int r = 0; r < kTotalsRounds; ++r) {
    int v[kTotalsLoads][4];
#pragma unroll
    for (int g = 0; g < kTotalsLoads; ++g) {
      const int i = chunk * kTotalsChunk +
                    ((r * kTotalsLoads + g) * kTotalsThreads + threadIdx.x) * 4;
      load_digits4<kVec>(src, i, n, num_buckets, v[g]);
    }
#pragma unroll
    for (int g = 0; g < kTotalsLoads; ++g) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (v[g][c] < num_buckets) atomicAdd(hist + v[g][c], 1);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < num_buckets; b += kTotalsThreads)
    if (hist[b]) atomicAdd(&totals[row * num_buckets + b], hist[b]);
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
  const long long tiles = static_cast<long long>(rows) * nb;
  const long long grid = (tiles + kHistWarps - 1) / kHistWarps;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = reinterpret_cast<uintptr_t>(digits) % 16 == 0 &&
                   (rows == 1 || stride % 4 == 0);
  if (grid > 0) {
    const auto st = static_cast<cudaStream_t>(stream);
    const unsigned g = static_cast<unsigned>(grid);
    const auto* d = static_cast<const int32_t*>(digits);
    auto* h = static_cast<int32_t*>(hist);
    if (vec)
      radix_hist_kernel<true><<<g, kHistWarps * 32, 0, st>>>(
          d, n, stride, num_buckets, nb, tiles, h);
    else
      radix_hist_kernel<false><<<g, kHistWarps * 32, 0, st>>>(
          d, n, stride, num_buckets, nb, tiles, h);
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
  const bool vec = reinterpret_cast<uintptr_t>(digits) % 16 == 0 &&
                   (rows == 1 || stride % 4 == 0) &&
                   reinterpret_cast<uintptr_t>(dest) % 16 == 0 &&
                   (rows == 1 || dest_stride % 4 == 0);
  if (grid > 0) {
    const auto kernel =
        vec ? &radix_apply_kernel<true> : &radix_apply_kernel<false>;
    const int smem = bucket_rank::shared_bytes(num_buckets);
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<static_cast<unsigned>(grid), kApplyWarps * 32, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(digits), n, stride, num_buckets, nb,
        tiles, static_cast<const int32_t*>(offsets),
        static_cast<int32_t*>(dest), dest_stride);
  }
  return static_cast<int>(cudaGetLastError());
}

// totals: (rows, num_buckets) int32, zeroed; adds the count of every real
// bucket among the first n digits of each row.
extern "C" int radix_totals(const void* digits, int rows, int n,
                            long long stride, int num_buckets, void* totals,
                            void* stream) {
  if (num_buckets < 1 || num_buckets > kMaxBuckets ||
      static_cast<long long>(n) + kTotalsChunk > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (n + kTotalsChunk - 1) / kTotalsChunk;
  const long long grid = static_cast<long long>(rows) * chunks;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = reinterpret_cast<uintptr_t>(digits) % 16 == 0 &&
                   (rows == 1 || stride % 4 == 0);
  if (grid > 0) {
    const auto st = static_cast<cudaStream_t>(stream);
    const unsigned g = static_cast<unsigned>(grid);
    if (vec)
      radix_totals_kernel<true><<<g, kTotalsThreads, 0, st>>>(
          static_cast<const int32_t*>(digits), n, stride, num_buckets, chunks,
          static_cast<int32_t*>(totals));
    else
      radix_totals_kernel<false><<<g, kTotalsThreads, 0, st>>>(
          static_cast<const int32_t*>(digits), n, stride, num_buckets, chunks,
          static_cast<int32_t*>(totals));
  }
  return static_cast<int>(cudaGetLastError());
}

// starts: (rows, starts_stride) int32, where each of the num_buckets buckets
// starts in its row's output; dest: (rows, dest_stride) int32; status:
// rows * ceil(n / 8192) * num_buckets + 1 zeroed 32-bit words, the last of
// them the tile counter. n < 2^30.
extern "C" int radix_scan(const void* digits, int rows, int n,
                          long long stride, int num_buckets,
                          const void* starts, long long starts_stride,
                          void* dest, long long dest_stride, void* status,
                          void* stream) {
  if (num_buckets < 1 || num_buckets > kMaxBuckets || n < 0 ||
      n >= (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  ScanParams p{};
  p.digits = static_cast<const int32_t*>(digits);
  p.stride = stride;
  p.n = n;
  p.num_buckets = num_buckets;
  p.tiles_per_row = (n + kScanTile - 1) / kScanTile;
  p.starts = static_cast<const int32_t*>(starts);
  p.starts_stride = starts_stride;
  p.dest = static_cast<int32_t*>(dest);
  p.dest_stride = dest_stride;
  const long long tiles = static_cast<long long>(rows) * p.tiles_per_row;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p.status = static_cast<unsigned*>(status);
  p.next_tile = p.status + tiles * num_buckets;
  const bool vec = reinterpret_cast<uintptr_t>(digits) % 16 == 0 &&
                   (rows == 1 || stride % 4 == 0);
  const int smem = bucket_rank::shared_bytes(num_buckets);
  if (tiles > 0) {
    const auto st = static_cast<cudaStream_t>(stream);
    const unsigned grid = static_cast<unsigned>(tiles);
    cudaError_t err;
    if (vec) {
      err = cudaFuncSetAttribute(radix_scan_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err == cudaSuccess)
        radix_scan_kernel<true><<<grid, kScanThreads, smem, st>>>(p);
    } else {
      err = cudaFuncSetAttribute(radix_scan_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err == cudaSuccess)
        radix_scan_kernel<false><<<grid, kScanThreads, smem, st>>>(p);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// Registers, shared bytes (static and dynamic), local bytes and resident
// blocks per SM of radix_scan's vectorised kernel at 256 buckets, into
// out[0..3].
extern "C" int radix_scan_info(void* out) {
  int* o = static_cast<int*>(out);
  const int smem = bucket_rank::shared_bytes(256);
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncSetAttribute(
      radix_scan_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&a, radix_scan_kernel<true>);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, radix_scan_kernel<true>, kScanThreads, smem);
  o[0] = a.numRegs;
  o[1] = static_cast<int>(a.sharedSizeBytes) + smem;
  o[2] = static_cast<int>(a.localSizeBytes);
  o[3] = blocks;
  return static_cast<int>(err);
}
