// One wavelet-matrix level over R rows of narrow keys: the level's bit, the
// LSB-first packed bitmap (zero past n), the zero count, and every element's
// destination under the stable 0/1 partition.
//
// Replaces repro/kernels/wm_level.py:wm_level_fused_pallas with one launch:
// wm_level_scan, the single-pass zero scan of zero_scan.cuh with one node per
// row (s0 = 0, s1 = the row's total zeros, zs = 0). The fused Pallas form
// counts the zeros in a first pass over a sequential (2, nblocks) grid; a
// level's zero count is permutation-invariant, so the build counts the zeros
// of every level of every row once, before its first level (wm_level_zeros),
// and hands each level its totals.
//
// wm_level_move is the same scan in zero_scan.cuh's move mode, for the same
// Pallas kernel: in place of the destinations it writes the keys themselves
// to them, the level's stable partition applied inside the launch (staged a
// warp at a time in shared memory, stored as two runs of consecutive keys).
// A build moves each level's narrow keys this way, where the composed
// position rides in the low bits of the same int32 word; no destination
// array, no scatter and no int64 index reach device memory. Its bound is the
// dest mode's: 4 B of key in, 4 B of moved key and 1/8 B of bitmap out. At
// 128 rows of 2^20 keys on the H100 it takes the dest mode's time (0.50 ms
// against 0.51, 64% of the bound; the dest mode with the two applies a level
// paid before, 3.29 ms) in 61 registers and 4 resident blocks an SM against
// the dest mode's 78 and 3 (launch/sweep_level_scan.py --modes).
//
// wm_level_zeros: one block per 12,288 keys of a row; each thread adds up
// the bits of 12 keys at a time in four words of eight 4-bit counters (bit
// 4f + g of the key in field f of word g), then flushes them into 32 per-bit
// counters; a 31-shuffle transpose-reduce leaves bit b's warp total in lane
// b; shared-memory and then global atomics sum the blocks. Bound: bytes,
// 4 B per key read once.
//
// wm_counts and wm_apply are the counterparts of the reference's two phase
// kernels (wm_counts_pallas, wm_apply_pallas), off the build path: a count
// launch of zeros per 1024-key block, and an apply launch given the
// exclusive block offsets. Keys past n read as ones (the reference pads
// with ones): they sort after every real key, are never written, and are
// masked out of the bitmap.
//
// Both are bound by bytes. A thread a key would hold an SM to 8 KB of
// 4-byte loads in flight, under what the card's latency needs, and a
// 1,024-thread block a contract block would pay barriers for every 1,024
// keys. So in both each warp owns one contract block, eight warps a CUDA
// block, and no warp waits on another: no barrier. A lane issues its eight
// 16-byte loads (zero_scan.cuh's load4) before it uses any (4-byte loads
// only where a row is not 16-byte aligned, or at its ragged end).
//
// wm_counts reads 4 B a key and writes 4 B a block: a lane packs its 32
// level bits into one word, and the warp adds their popcounts with one
// __reduce_add_sync; lane 0 writes the block's zeros. No shared memory.
//
// wm_apply reads 4 B a key and writes 4 B of destination plus 1/8 B of
// bitmap. It runs the warp half of zero_scan.cuh: ballots for the in-warp
// zero counts and whole bitmap words, and 16-byte stores of the
// destinations. A warp's base is its block's own zeros_excl entry, read
// directly: no look-back, and any offsets give the plain version's result,
// not only those of a scan. Destinations are computed mod 2^32, as the
// plain version's int64 sums cast to int32. At 128 rows of 2^20 keys it
// runs at 89% of its bound on the H100 (0.364 ms against 0.326;
// launch/sweep_phase_kernels.py).
#include "zero_scan.cuh"

namespace {

constexpr int kBlock = 1024;     // keys per contract block, one a warp
constexpr int kPhaseWarps = 8;   // contract blocks per CUDA block
static_assert(zero_scan::kWarpKeys == kBlock,
              "a warp's keys are one contract block");

template <bool kVec>
__global__ void __launch_bounds__(kPhaseWarps * 32)
    wm_counts_kernel(const int32_t* __restrict__ keys, int n,
                     long long key_stride, int shift, int nb,
                     long long blocks, int32_t* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const long long t =
      static_cast<long long>(blockIdx.x) * kPhaseWarps + (threadIdx.x >> 5);
  if (t >= blocks) return;                         // the whole warp leaves
  const long long first = (t % nb) * kBlock;
  const int left = static_cast<int>(min(static_cast<long long>(kBlock),
                                         n - first));
  int key[zero_scan::kSlabs][4];
  const int32_t* src = keys + (t / nb) * key_stride + first;
#pragma unroll
  for (int s = 0; s < zero_scan::kSlabs; ++s)
    zero_scan::load4<kVec>(src, s * 128 + 4 * lane, left, -1, key[s]);
  unsigned bits = 0;                               // past n: ones
#pragma unroll
  for (int s = 0; s < zero_scan::kSlabs; ++s) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      bits |= ((static_cast<uint32_t>(key[s][c]) >> shift) & 1u) << (4 * s + c);
  }
  const unsigned ones = __reduce_add_sync(zero_scan::kFull, __popc(bits));
  if (lane == 0) counts[t] = kBlock - static_cast<int>(ones);
}

template <bool kVec>
__global__ void __launch_bounds__(kPhaseWarps * 32)
    wm_apply_kernel(const int32_t* __restrict__ keys, int n,
                    long long key_stride, int shift, int nb, long long blocks,
                    const int32_t* __restrict__ zeros_excl,
                    const int32_t* __restrict__ total_zeros,
                    int32_t* __restrict__ dest, long long dest_stride,
                    int32_t* __restrict__ bitmap, int W,
                    long long bitmap_stride) {
  const int lane = threadIdx.x & 31;
  const long long t =
      static_cast<long long>(blockIdx.x) * kPhaseWarps + (threadIdx.x >> 5);
  if (t >= blocks) return;                         // the whole warp leaves
  const long long row = t / nb;
  const int blk = static_cast<int>(t % nb);
  const long long first = static_cast<long long>(blk) * kBlock;
  const int left = static_cast<int>(min(static_cast<long long>(kBlock),
                                         n - first));
  int key[zero_scan::kSlabs][4];
  const int32_t* src = keys + row * key_stride + first;
#pragma unroll
  for (int s = 0; s < zero_scan::kSlabs; ++s)
    zero_scan::load4<kVec>(src, s * 128 + 4 * lane, left, -1, key[s]);
  const unsigned zb = static_cast<unsigned>(zeros_excl[t]);
  const unsigned total = static_cast<unsigned>(total_zeros[row]);
  const zero_scan::Ballots bal = zero_scan::ballot_slabs(key, shift, lane);

  // word `lane` of the block: keys 32 lane .. 32 lane + 31, zero past n
  const int gw = blk * (kBlock / 32) + lane;
  if (gw < W) {
    const unsigned word = zero_scan::slab_word(bal.mine[0], lane);
    const int real = left - 32 * lane;
    bitmap[row * bitmap_stride + gw] = static_cast<int32_t>(
        real >= 32 ? word : word & ((1u << real) - 1u));
  }

  // zeros go to zb + (zeros before the key in the block), ones to total +
  // (ones before the block) + (ones before the key in the block)
  const unsigned ones_base = total + static_cast<unsigned>(first) - zb;
  int32_t* drow = dest + row * dest_stride + first;
#pragma unroll
  for (int s = 0; s < zero_scan::kSlabs; ++s) {
    const int i0 = s * 128 + 4 * lane;
    unsigned z = static_cast<unsigned>(bal.zb[s]);
    int d[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const unsigned bit = (bal.bits[s / 8] >> (4 * (s % 8) + c)) & 1u;
      d[c] = static_cast<int>(bit ? ones_base + (i0 + c) - z : zb + z);
      z += 1u - bit;
    }
    zero_scan::store4<kVec>(drow, i0, left, d);
  }
}

constexpr int kCountThreads = 256;
constexpr int kCountGroup = 3;        // 16-byte loads per flush: 12 keys < 16
constexpr int kCountRounds = 4;
constexpr int kCountChunk = kCountThreads * kCountGroup * kCountRounds * 4;

// One step of the warp's transpose-reduce of 32 per-bit counters: a lane
// keeps the half of its first 2D counters that its bit D selects and adds
// its partner's; after the steps 16, 8, 4, 2, 1 lane b holds bit b's total.
template <int D>
__device__ __forceinline__ void fold(unsigned (&v)[32], int lane) {
  const bool upper = lane & D;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const unsigned send = upper ? v[k] : v[k + D];
    const unsigned keep = upper ? v[k + D] : v[k];
    v[k] = keep + __shfl_xor_sync(zero_scan::kFull, send, D);
  }
}

// Zeros of bits lo + width - 1 - j (j < width, level order) of the first n
// keys of each row, added into out (rows, width); one block per chunk.
template <bool kVec>
__global__ void __launch_bounds__(kCountThreads)
    wm_level_zeros_kernel(const int32_t* __restrict__ keys, int n,
                          long long key_stride, int lo, int width,
                          int chunks, int32_t* __restrict__ out) {
  __shared__ int s_ones[32];
  const int row = blockIdx.x / chunks;
  const int base = (blockIdx.x % chunks) * kCountChunk;
  const int32_t* krow = keys + static_cast<long long>(row) * key_stride;
  if (threadIdx.x < 32) s_ones[threadIdx.x] = 0;
  unsigned ones[32];
#pragma unroll
  for (int b = 0; b < 32; ++b) ones[b] = 0;
#pragma unroll
  for (int r = 0; r < kCountRounds; ++r) {
    unsigned acc[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int g = 0; g < kCountGroup; ++g) {
      int k[4];
      const int i =
          base + ((r * kCountGroup + g) * kCountThreads + threadIdx.x) * 4;
      zero_scan::load4<kVec>(krow, i, n, 0, k);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int f = 0; f < 4; ++f)
          acc[f] += (static_cast<uint32_t>(k[c]) >> f) & 0x11111111u;
      }
    }
#pragma unroll
    for (int f = 0; f < 4; ++f) {
#pragma unroll
      for (int j = 0; j < 8; ++j) ones[4 * j + f] += (acc[f] >> (4 * j)) & 15u;
    }
  }
  const int lane = threadIdx.x & 31;
  fold<16>(ones, lane);
  fold<8>(ones, lane);
  fold<4>(ones, lane);
  fold<2>(ones, lane);
  fold<1>(ones, lane);
  __syncthreads();
  atomicAdd(&s_ones[lane], static_cast<int>(ones[0]));
  __syncthreads();
  if (threadIdx.x < width) {
    const int real = min(n - base, kCountChunk);
    atomicAdd(out + static_cast<long long>(row) * width + threadIdx.x,
              real - s_ones[lo + width - 1 - threadIdx.x]);
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// keys: (rows, key_stride) int32, the first n of each row used;
// counts: (rows, nb) int32 with nb = ceil(n / 1024).
extern "C" int wm_counts(const void* keys, int rows, int n,
                         long long key_stride, int shift, void* counts,
                         int nb, void* stream) {
  const long long blocks = static_cast<long long>(rows) * nb;
  const long long grid = (blocks + kPhaseWarps - 1) / kPhaseWarps;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = reinterpret_cast<uintptr_t>(keys) % 16 == 0 &&
                   (rows == 1 || key_stride % 4 == 0);
  if (grid > 0) {
    const auto st = static_cast<cudaStream_t>(stream);
    const unsigned g = static_cast<unsigned>(grid);
    const auto* k = static_cast<const int32_t*>(keys);
    auto* c = static_cast<int32_t*>(counts);
    if (vec)
      wm_counts_kernel<true><<<g, kPhaseWarps * 32, 0, st>>>(
          k, n, key_stride, shift, nb, blocks, c);
    else
      wm_counts_kernel<false><<<g, kPhaseWarps * 32, 0, st>>>(
          k, n, key_stride, shift, nb, blocks, c);
  }
  return static_cast<int>(cudaGetLastError());
}

// zeros_excl: (rows, nb) exclusive per-block zero offsets; total_zeros:
// (rows,); dest: (rows, dest_stride) int32; bitmap: (rows, bitmap_stride)
// int32 with W = ceil(n / 32) words written per row.
extern "C" int wm_apply(const void* keys, int rows, int n,
                        long long key_stride, int shift, int nb,
                        const void* zeros_excl, const void* total_zeros,
                        void* dest, long long dest_stride, void* bitmap,
                        int W, long long bitmap_stride, void* stream) {
  const long long blocks = static_cast<long long>(rows) * nb;
  const long long grid = (blocks + kPhaseWarps - 1) / kPhaseWarps;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = reinterpret_cast<uintptr_t>(keys) % 16 == 0 &&
                   (rows == 1 || key_stride % 4 == 0) &&
                   reinterpret_cast<uintptr_t>(dest) % 16 == 0 &&
                   (rows == 1 || dest_stride % 4 == 0);
  if (grid > 0) {
    const auto st = static_cast<cudaStream_t>(stream);
    const unsigned g = static_cast<unsigned>(grid);
    const auto* k = static_cast<const int32_t*>(keys);
    const auto* ze = static_cast<const int32_t*>(zeros_excl);
    const auto* tz = static_cast<const int32_t*>(total_zeros);
    auto* d = static_cast<int32_t*>(dest);
    auto* b = static_cast<int32_t*>(bitmap);
    if (vec)
      wm_apply_kernel<true><<<g, kPhaseWarps * 32, 0, st>>>(
          k, n, key_stride, shift, nb, blocks, ze, tz, d, dest_stride, b, W,
          bitmap_stride);
    else
      wm_apply_kernel<false><<<g, kPhaseWarps * 32, 0, st>>>(
          k, n, key_stride, shift, nb, blocks, ze, tz, d, dest_stride, b, W,
          bitmap_stride);
  }
  return static_cast<int>(cudaGetLastError());
}

// keys: (rows, key_stride) int32, the first n of each row used; out: (rows,
// width) int32, zeroed; lo + width <= 32.
extern "C" int wm_level_zeros(const void* keys, int rows, int n,
                              long long key_stride, int lo, int width,
                              void* out, void* stream) {
  if (lo < 0 || width < 1 || lo + width > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (n + kCountChunk - 1) / kCountChunk;
  const long long grid = static_cast<long long>(rows) * chunks;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = reinterpret_cast<uintptr_t>(keys) % 16 == 0 &&
                   (rows == 1 || key_stride % 4 == 0);
  if (grid > 0) {
    const auto st = static_cast<cudaStream_t>(stream);
    const auto* k = static_cast<const int32_t*>(keys);
    auto* o = static_cast<int32_t*>(out);
    const unsigned g = static_cast<unsigned>(grid);
    if (vec)
      wm_level_zeros_kernel<true><<<g, kCountThreads, 0, st>>>(
          k, n, key_stride, lo, width, chunks, o);
    else
      wm_level_zeros_kernel<false><<<g, kCountThreads, 0, st>>>(
          k, n, key_stride, lo, width, chunks, o);
  }
  return static_cast<int>(cudaGetLastError());
}

namespace {

// One matrix level of zero_scan.cuh in one launch: destinations, or with
// kMove the moved keys, into out.
template <bool kMove>
int level_scan(const void* keys, int rows, int n, long long key_stride,
               int shift, const void* total_zeros, long long total_stride,
               void* zeros_out, void* out, long long out_stride, void* bitmap,
               int W, long long bitmap_stride, void* status, void* stream) {
  zero_scan::Params p{};
  p.keys = static_cast<const int32_t*>(keys);
  p.key_stride = key_stride;
  p.n = n;
  p.shift = shift;
  p.tiles_per_row = (n + zero_scan::kTile - 1) / zero_scan::kTile;
  p.total_zeros = static_cast<const int32_t*>(total_zeros);
  p.total_stride = total_stride;
  p.zeros_out = static_cast<int32_t*>(zeros_out);
  p.dest = static_cast<int32_t*>(out);
  p.dest_stride = out_stride;
  p.bitmap = static_cast<int32_t*>(bitmap);
  p.bitmap_stride = bitmap_stride;
  p.W = W;
  p.status = static_cast<unsigned long long*>(status);
  p.next_tile = reinterpret_cast<unsigned int*>(
      p.status + static_cast<long long>(rows) * p.tiles_per_row);
  // the moved keys are stored 4 bytes at a time: only the keys' rows need
  // 16-byte alignment then
  const bool vec = reinterpret_cast<uintptr_t>(keys) % 16 == 0 &&
                   (rows == 1 || key_stride % 4 == 0) &&
                   (kMove || (reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                              (rows == 1 || out_stride % 4 == 0)));
  return zero_scan::launch<false, kMove>(p, rows, vec,
                                         static_cast<cudaStream_t>(stream));
}

}  // namespace

// One level in one launch. total_zeros: (rows,) with stride total_stride,
// the zeros of each row's level bit; zeros_out: (rows,) the zeros the scan
// counted; status: rows * ceil(n / 8192) + 1 zeroed 64-bit words, the last
// of them the tile counter.
extern "C" int wm_level_scan(const void* keys, int rows, int n,
                             long long key_stride, int shift,
                             const void* total_zeros, long long total_stride,
                             void* zeros_out, void* dest,
                             long long dest_stride, void* bitmap, int W,
                             long long bitmap_stride, void* status,
                             void* stream) {
  return level_scan<false>(keys, rows, n, key_stride, shift, total_zeros,
                           total_stride, zeros_out, dest, dest_stride, bitmap,
                           W, bitmap_stride, status, stream);
}

// wm_level_scan's arguments, with moved: (rows, moved_stride) int32 that
// receives row r's first n keys in the level's stable partition order; it
// must not overlap keys.
extern "C" int wm_level_move(const void* keys, int rows, int n,
                             long long key_stride, int shift,
                             const void* total_zeros, long long total_stride,
                             void* zeros_out, void* moved,
                             long long moved_stride, void* bitmap, int W,
                             long long bitmap_stride, void* status,
                             void* stream) {
  return level_scan<true>(keys, rows, n, key_stride, shift, total_zeros,
                          total_stride, zeros_out, moved, moved_stride, bitmap,
                          W, bitmap_stride, status, stream);
}

// Registers, static shared bytes, local bytes and resident blocks per SM of
// wm_level_scan's kernel, into out[0..3].
extern "C" int wm_level_scan_info(void* out) {
  return zero_scan::info<false>(static_cast<int*>(out));
}

// The same of wm_level_move's kernel.
extern "C" int wm_level_move_info(void* out) {
  return zero_scan::info<false, true>(static_cast<int*>(out));
}
