// Pack R rows of 0/1 values (int32, any nonzero reads as 1) into LSB-first
// 32-bit words, zero past n.
//
// Replaces repro/kernels/bitpack.py:bitpack_pallas. The Pallas form takes
// the bits transposed to (32, W) so that the TPU reduces each word along its
// sublanes; on the H100 no transpose is needed: one warp packs one tile of 32
// words, and in round r lane j holds bit j of word r, so __ballot_sync of the
// 32 lanes is word r itself. Lane r keeps word r, and the warp stores its 32
// words in one coalesced write.
//
// Bound on the H100: bytes. Per bit 4 B are read and 1/8 B written.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;             // tiles per block, one per warp
constexpr int kTileBits = 32 * 32;    // bits per tile

__global__ void bitpack_kernel(const int32_t* __restrict__ bits, int rows,
                               int n, long long stride, int tiles,
                               int32_t* __restrict__ words, int W,
                               long long words_stride) {
  const int lane = threadIdx.x & 31;
  const long long t =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (t >= static_cast<long long>(rows) * tiles) return;  // whole warp leaves
  const long long row = t / tiles;
  const int tile = static_cast<int>(t % tiles);
  const int32_t* src = bits + row * stride;
  unsigned mine = 0;
#pragma unroll 8
  for (int r = 0; r < 32; ++r) {
    const long long i = static_cast<long long>(tile) * kTileBits + r * 32 + lane;
    const unsigned word = __ballot_sync(0xffffffffu, i < n && src[i] != 0);
    if (lane == r) mine = word;
  }
  const long long w = static_cast<long long>(tile) * 32 + lane;
  if (w < W) words[row * words_stride + w] = static_cast<int32_t>(mine);
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// bits: (rows, stride) int32, the first n of each row used; words: (rows,
// words_stride) int32 with W = ceil(n / 32) words written per row.
extern "C" int bitpack(const void* bits, int rows, int n, long long stride,
                       void* words, int W, long long words_stride,
                       void* stream) {
  const int tiles = (n + kTileBits - 1) / kTileBits;
  const long long grid =
      (static_cast<long long>(rows) * tiles + kWarps - 1) / kWarps;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (grid > 0) {
    bitpack_kernel<<<static_cast<unsigned>(grid), kWarps * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(bits), rows, n, stride, tiles,
        static_cast<int32_t*>(words), W, words_stride);
  }
  return static_cast<int>(cudaGetLastError());
}
