// Jacobson rank directories of R packed bit rows, one launch for all rows: a
// single-pass tiled scan with decoupled look-back.
//
// Replaces repro/kernels/rank_build.py:rank_build_levels_pallas (and, at
// R = 1, rank_build_pallas). The Pallas form walks a sequential TPU grid and
// carries the running popcount in SMEM from one step to the next; CUDA
// blocks run in no order. One block per row left most of the card idle when
// rows are few and long (18 rows of 2^22 words ran on 18 of 132 SMs), so a
// row is cut into tiles of kTile = 16,384 words (4,096 rank blocks of four
// words, 512 superblocks of 32), one tile per block of 512 threads, and the
// popcount carried into a tile comes from the look-back of look_back.cuh:
//   - tile ids come from an atomic counter in row-major launch order, so a
//     tile's predecessors are always running; the first tile of a row
//     publishes its prefix at once, so rows never share a sum;
//   - thread x owns rank blocks s * 512 + x of the tile (slab s < kSlabs),
//     each one 16-byte load, so a warp reads 512 contiguous bytes a load
//     and a thread has kSlabs loads in flight;
//   - the blocks' popcounts are scanned across the tile: warp shuffles
//     within a slab, then warp 0 over the kSlabs x kWarps warp totals in
//     slab order;
//   - the block-relative ranks (uint16 patterns in the int16 table) depend
//     on nothing outside the tile: warps 1.. write theirs as soon as warp 0
//     has scanned the warp totals (a named barrier), while warp 0 takes the
//     tile's row prefix from the look-back, with the tile's popcount as its
//     aggregate (one 64-bit status word a tile), and then writes its own; a
//     superblock's first block is lane & ~7 of the same warp and slab;
//   - lanes 0, 8, 16 and 24 write the absolute superblock ranks, uint32
//     patterns in int32 that wrap as the reference's uint32 carry does.
// Words past W read as zero; no entry past a row's tables is written. The
// tile shape is the fastest of a sweep on the H100
// (launch/sweep_rank_radix.py).
//
// Bound on the H100: bytes. Each word is read once (4 B) and 1/8 B + 1/2 B
// of directory is written per word; the popcounts and scans are far below
// the card's integer rate.
#include "look_back.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kSlabs = 8;                       // 16-byte loads per thread
constexpr int kWarps = kThreads / 32;
constexpr int kBlockWords = 4;
constexpr int kTileBlocks = kThreads * kSlabs;
constexpr int kTile = kTileBlocks * kBlockWords;  // 16384 words per tile
constexpr int kWarpTotals = kSlabs * kWarps;
constexpr unsigned kFull = lookback::kFull;

struct Params {
  const uint32_t* words;
  int W;
  long long row_stride;
  uint32_t* superblock;
  int nsb;
  uint16_t* block;
  int nblk;
  int tiles_per_row;
  unsigned long long* status;    // one word per tile, zeroed
  unsigned int* next_tile;       // zeroed
};

// Popcount of rank block b of a row: one 16-byte load where all four words
// are real and the row is 16-byte aligned.
template <bool kVec>
__device__ __forceinline__ uint32_t block_popcount(
    const uint32_t* __restrict__ row, int b, int W) {
  const int w0 = b * kBlockWords;
  if (kVec && w0 + kBlockWords <= W) {
    const uint4 x = *reinterpret_cast<const uint4*>(row + w0);
    return __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w);
  }
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < kBlockWords; ++j)
    if (w0 + j < W) c += __popc(row[w0 + j]);
  return c;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    rank_build_levels_kernel(const Params p) {
  __shared__ int s_tile;
  __shared__ uint32_t s_warp[kWarpTotals];
  __shared__ long long s_prefix;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = static_cast<int>(atomicAdd(p.next_tile, 1u));
  __syncthreads();
  const int t = s_tile;
  const int row = t / p.tiles_per_row;
  const int first = row * p.tiles_per_row;
  const int tile_blk = (t - first) * kTileBlocks + threadIdx.x;
  const uint32_t* w = p.words + row * p.row_stride;

  uint32_t c[kSlabs], incl[kSlabs];
#pragma unroll
  for (int s = 0; s < kSlabs; ++s)
    c[s] = block_popcount<kVec>(w, tile_blk + s * kThreads, p.W);
#pragma unroll
  for (int s = 0; s < kSlabs; ++s) {
    uint32_t x = c[s];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    incl[s] = x;
    if (lane == 31) s_warp[s * kWarps + warp] = x;
  }
  __syncthreads();
  // exclusive scan of the warp totals in slab order, in place, by warp 0,
  // which then walks back while the other warps write the block ranks
  if (warp == 0) {
    constexpr int kPer = (kWarpTotals + 31) / 32;
    uint32_t v[kPer], sum = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = lane * kPer + k;
      v[k] = i < kWarpTotals ? s_warp[i] : 0;
      sum += v[k];
    }
    uint32_t x = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    uint32_t run = x - sum;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = lane * kPer + k;
      if (i < kWarpTotals) s_warp[i] = run;
      run += v[k];
    }
    asm volatile("bar.arrive 1, %0;" ::"r"(kThreads) : "memory");
    const int agg = static_cast<int>(__shfl_sync(kFull, x, 31));
    const long long excl = lookback::look_back(p.status, t, first, agg, lane);
    if (lane == 0) s_prefix = excl;
  } else {
    asm volatile("bar.sync 1, %0;" ::"r"(kThreads) : "memory");
  }

  // the tile-relative exclusive rank of every block; block-relative ranks
  uint16_t* blk_out = p.block + static_cast<long long>(row) * p.nblk;
#pragma unroll
  for (int s = 0; s < kSlabs; ++s) {
    incl[s] += s_warp[s * kWarps + warp] - c[s];          // now exclusive
    const uint32_t sb_rank = __shfl_sync(kFull, incl[s], lane & ~7);
    const int b = tile_blk + s * kThreads;
    if (b < p.nblk) blk_out[b] = static_cast<uint16_t>(incl[s] - sb_rank);
  }
  __syncthreads();
  if ((lane & 7) == 0) {
    uint32_t* sb_out = p.superblock + static_cast<long long>(row) * p.nsb;
    const unsigned long long prefix =
        static_cast<unsigned long long>(s_prefix);
#pragma unroll
    for (int s = 0; s < kSlabs; ++s) {
      const int b = tile_blk + s * kThreads;
      if (b < p.nblk)
        sb_out[b >> 3] = static_cast<uint32_t>(prefix + incl[s]);
    }
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// words: (rows, row_stride) uint32, the first W words of each row used;
// superblock: (rows, nsb) uint32, nsb = ceil(W / 32); block: (rows, nblk)
// uint16, nblk = ceil(W / 4); status: rows * ceil(W / 16384) + 1 zeroed
// 64-bit words, the last of them the tile counter.
extern "C" int rank_build_levels(const void* words, int rows, int W,
                                 long long row_stride, void* superblock,
                                 int nsb, void* block, int nblk,
                                 void* status, void* stream) {
  Params p{};
  p.words = static_cast<const uint32_t*>(words);
  p.W = W;
  p.row_stride = row_stride;
  p.superblock = static_cast<uint32_t*>(superblock);
  p.nsb = nsb;
  p.block = static_cast<uint16_t*>(block);
  p.nblk = nblk;
  p.tiles_per_row = static_cast<int>((static_cast<long long>(W) + kTile - 1) /
                                     kTile);
  const long long tiles = static_cast<long long>(rows) * p.tiles_per_row;
  if (tiles > 0x7fffffffLL ||
      static_cast<long long>(nblk) + kTileBlocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  p.status = static_cast<unsigned long long*>(status);
  p.next_tile = reinterpret_cast<unsigned int*>(p.status + tiles);
  const bool vec = reinterpret_cast<uintptr_t>(words) % 16 == 0 &&
                   (rows == 1 || row_stride % 4 == 0);
  if (tiles > 0) {
    const auto st = static_cast<cudaStream_t>(stream);
    const unsigned grid = static_cast<unsigned>(tiles);
    if (vec)
      rank_build_levels_kernel<true><<<grid, kThreads, 0, st>>>(p);
    else
      rank_build_levels_kernel<false><<<grid, kThreads, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// Registers, static shared bytes, local bytes and resident blocks per SM of
// the vectorised kernel, into out[0..3].
extern "C" int rank_build_levels_info(void* out) {
  int* o = static_cast<int*>(out);
  cudaFuncAttributes a;
  cudaError_t err =
      cudaFuncGetAttributes(&a, rank_build_levels_kernel<true>);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, rank_build_levels_kernel<true>, kThreads, 0);
  o[0] = a.numRegs;
  o[1] = static_cast<int>(a.sharedSizeBytes);
  o[2] = static_cast<int>(a.localSizeBytes);
  o[3] = blocks;
  return static_cast<int>(err);
}
