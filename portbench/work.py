"""The yardstick's work counts: the H100's peaks, the bound of a kernel's
work, and the bytes and int32 operations of each hand-written kernel of the
port at the shapes a cell gives it.

Frozen copies of ``chip_smoke.py``'s counts (``bound_ms``, the kernel and
phase rows, ``quantile_probes``' distinct-sector walk) and of
``launch/sweep_quantile.py``'s line width, so that a later change to the
program cannot change what its kernels are held to. Each input byte is
counted once and each output byte once, whatever a kernel reads again.
"""
from __future__ import annotations

import torch

from portbench.reference.wavelet import num_levels

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
INT32_OPS_PER_S = 16.7e12     # 132 SMs x 64 INT32 lanes x 1.98 GHz boost
#                               (H100 Tensor Core GPU Architecture whitepaper)
L2_LOAD_NS = 143.0            # one dependent load that hits in L2 (pointer
#                               chase on the card, chip_smoke run 8, PR 15)
SECTOR_BYTES = 32             # one 32-byte sector a rank probe, the least
LINE_BITS = 224               # positions a sector covers: seven words of
#                               bits after a count (sweep_quantile.LINE_BITS)
PROBE_OPS = 40                # int32 operations counted for a rank probe

#: the port's hand-written kernels by the symbol their launches carry in a
#: profiler trace (both level scans launch ``zero_scan_kernel``; the cells
#: here run no tree). Every other device operation is torch's.
KERNEL_SYMBOLS = {
    "wm_level_scan": "zero_scan_kernel",
    "wm_level_zeros": "wm_level_zeros_kernel",
    "wm_counts": "wm_counts_kernel",
    "wm_apply": "wm_apply_kernel",
    "rank_build_levels": "rank_build_levels_kernel",
    "radix_scan": "radix_scan_kernel",
    "radix_totals": "radix_totals_kernel",
    "radix_hist": "radix_hist_kernel",
    "radix_apply": "radix_apply_kernel",
    "bitpack": "bitpack_kernel",
    "wm_quantile": "wm_quantile_kernel",
    "wm_count": "wm_count_kernel",
    "topk_greedy": "topk_greedy_kernel",
}


def kernel_of(name: str) -> str | None:
    """The hand-written kernel a device operation's name belongs to, or
    None for torch's own operations."""
    for kernel, symbol in KERNEL_SYMBOLS.items():
        if symbol in name:
            return kernel
    return None


def bound_ms(nbytes: float, nops: float, latency_ms: float = 0.0) -> float:
    """The least time for the work: its bytes at the HBM rate, its int32
    operations at the peak rate, or its chain of dependent loads."""
    return max(nbytes / HBM_BYTES_PER_S * 1e3, nops / INT32_OPS_PER_S * 1e3,
               latency_ms)


def words_of(n: int) -> int:
    return (n + 31) // 32


# ---- construction kernels: (bytes, ops) of one launch ----------------------

def wm_level_zeros(rows: int, n: int, nbits: int) -> tuple[int, int]:
    """Every level's zeros of (rows, n) symbols, once a build."""
    return rows * n * 4 + rows * nbits * 4, rows * n * nbits


def wm_level_scan(rows: int, n: int) -> tuple[int, int]:
    """One level of (rows, n) narrow keys: keys in, destinations out, the
    level's bitmap words and zeros."""
    return rows * n * 8 + rows * words_of(n) * 4 + rows * 4, rows * n * 24


def rank_build_levels(rows: int, words: int) -> tuple[int, int]:
    """Rank directories of (rows, words) bitmaps: words in, an int32
    superblock a 32 words and an int16 block a 4 words out."""
    sb, blk = -(-words // 32), -(-words // 4)
    return rows * words * 4 + rows * sb * 4 + rows * blk * 2, rows * words * 8


def radix_totals(rows: int, n: int, buckets: int) -> tuple[int, int]:
    """Bucket totals of (rows, n) digits."""
    return rows * n * 4 + rows * buckets * 4, rows * n


def radix_scan(rows: int, n: int) -> tuple[int, int]:
    """Stable destinations of (rows, n) digits: digits in, ranks out."""
    return rows * n * 8, rows * n * 8


def bitpack(rows: int, n: int) -> tuple[int, int]:
    """(rows, n) int32 bits packed into words."""
    return rows * n * 4 + rows * words_of(n) * 4, rows * n * 2


def matrix_build(rows: int, n: int, sigma: int) -> dict[str, list]:
    """The hand-written launches of one fused wavelet-matrix build of
    (rows, n) symbols: kernel -> [(bytes, ops), ...]."""
    nbits = num_levels(sigma)
    return {"wm_level_zeros": [wm_level_zeros(rows, n, nbits)],
            "wm_level_scan": [wm_level_scan(rows, n)] * nbits,
            "rank_build_levels": [rank_build_levels(rows * nbits,
                                                    words_of(n))]}


def index_build(rows: int, n: int, sigma: int,
                radix_passes: int) -> dict[str, list]:
    """The hand-written launches of one sharded FM-index build over (rows,
    n) raw symbols in [0, sigma) (the tail padded with sigma): the suffix
    array's ``radix_passes`` kernel passes over (rows, n + 1) digits of 256
    buckets (a totals count and a scan each), the matrix of the BWT (its
    working alphabet sigma + 2), the mark bits' packing and directory."""
    m = n + 1
    out = matrix_build(rows, m, sigma + 2)
    out["radix_totals"] = [radix_totals(rows, m, 256)] * radix_passes
    out["radix_scan"] = [radix_scan(rows, m)] * radix_passes
    out["bitpack"] = [bitpack(rows, m)]
    out["rank_build_levels"].append(rank_build_levels(rows, words_of(m)))
    return out


def launches_bound_ms(launches: list) -> float:
    return sum(bound_ms(b, o) for b, o in launches)


# ---- the quantile kernel ----------------------------------------------------

def level_sectors(los: torch.Tensor, his: torch.Tensor, level: int,
                  nbits: int, shard_bits: int) -> tuple[int, int]:
    """(probes, distinct sectors) of one level of a batch's descent, given
    the (S, Q) local ranges (los, his) that it probes there. A probe is
    live where its range is not empty; probes that fall in one sector of
    ``LINE_BITS`` positions of one (shard, level) row need it from memory
    once. Rows differ between levels, so a batch's distinct sectors are
    the sum of its levels'."""
    per_row = (1 << shard_bits) // LINE_BITS + 1
    first = torch.arange(los.shape[0], device=los.device)[:, None] * nbits
    live = his > los
    row = (first + level).expand_as(los)[live].long() * per_row
    keys = torch.cat([row + los[live].long() // LINE_BITS,
                      row + his[live].long() // LINE_BITS])
    return 2 * int(live.sum()), int(torch.unique(keys).numel())


def quantile_bound_ms(queries: int, probes: int, sectors: int,
                      nbits: int) -> float:
    """The quantile batch's least time: each query's lo, hi, k and answer
    and each distinct sector once, ``PROBE_OPS`` a probe, or its chain of
    nbits dependent loads at the L2's latency (a shared top-level line
    hits in L2)."""
    return bound_ms(queries * 16 + sectors * SECTOR_BYTES,
                    probes * PROBE_OPS, nbits * L2_LOAD_NS * 1e-6)
