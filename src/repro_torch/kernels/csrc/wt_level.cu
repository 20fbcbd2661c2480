// One segmented wavelet-tree level over R rows of narrow keys: the level's
// bit, the LSB-first packed bitmap (zero past n), and every element's
// destination under the stable per-node 0/1 partition, i.e. the stable sort
// by bucket (nid << 1) | bit over nbkt = 2^(l+1) <= 512 buckets.
//
// Replaces repro/kernels/wt_level.py:wt_level_fused_pallas with one launch:
// wt_level_scan, the single-pass zero scan of zero_scan.cuh with a per-row
// node table. The Pallas form carries per-block (node, bit) histograms across
// a sequential (2, nblocks) grid. Here no histogram exists: the caller passes
// the level's bucket starts (the tree build knows them from its node offsets
// before the first level), node v's 0s start at s0 = start[2v] and its 1s at
// s1 = start[2v + 1], zs = the zeros of nodes before v, and one row-wide
// zero prefix places every key.
//
// Bound on the H100: bytes. Per key 4 B of key and 4 B of node id are read,
// 4 B of destination and 1/8 B of bitmap written; the table (3 ints a node)
// is read once per tile from L2.
#include "zero_scan.cuh"

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// sub, nid: (rows, *_stride) int32, the first n of each row used, node ids
// non-decreasing in [0, nodes); table: (rows, 3, nodes) int32, s0 | s1 | zs;
// dest: (rows, dest_stride) int32; bitmap: (rows, bitmap_stride) int32 with
// W = ceil(n / 32) words written per row; status: rows * ceil(n / 8192) + 1
// zeroed 64-bit words, the last of them the tile counter.
extern "C" int wt_level_scan(const void* sub, const void* nid, int rows,
                             int n, long long sub_stride,
                             long long nid_stride, int shift,
                             const void* table, int nodes, void* dest,
                             long long dest_stride, void* bitmap, int W,
                             long long bitmap_stride, void* status,
                             void* stream) {
  zero_scan::Params p{};
  p.keys = static_cast<const int32_t*>(sub);
  p.key_stride = sub_stride;
  p.n = n;
  p.shift = shift;
  p.tiles_per_row = (n + zero_scan::kTile - 1) / zero_scan::kTile;
  p.nid = static_cast<const int32_t*>(nid);
  p.nid_stride = nid_stride;
  p.table = static_cast<const int32_t*>(table);
  p.nodes = nodes;
  p.dest = static_cast<int32_t*>(dest);
  p.dest_stride = dest_stride;
  p.bitmap = static_cast<int32_t*>(bitmap);
  p.bitmap_stride = bitmap_stride;
  p.W = W;
  p.status = static_cast<unsigned long long*>(status);
  p.next_tile = reinterpret_cast<unsigned int*>(
      p.status + static_cast<long long>(rows) * p.tiles_per_row);
  const bool vec = reinterpret_cast<uintptr_t>(sub) % 16 == 0 &&
                   (rows == 1 || sub_stride % 4 == 0) &&
                   reinterpret_cast<uintptr_t>(nid) % 16 == 0 &&
                   (rows == 1 || nid_stride % 4 == 0) &&
                   reinterpret_cast<uintptr_t>(dest) % 16 == 0 &&
                   (rows == 1 || dest_stride % 4 == 0);
  return zero_scan::launch<true>(p, rows, vec,
                                 static_cast<cudaStream_t>(stream));
}

// Registers, static shared bytes, local bytes and resident blocks per SM of
// wt_level_scan's kernel, into out[0..3].
extern "C" int wt_level_scan_info(void* out) {
  return zero_scan::info<true>(static_cast<int*>(out));
}
