"""Plain-torch oracles of the kernels (port of ``repro.kernels.ref``).

Exact integer semantics, written without the kernels' blocking: the quantile
oracles rank from dense prefix sums over the unpacked bits, with no
directories involved, so they cross-check the directory walk.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import bitops
from repro_torch.core.rank_select import BLOCK_WORDS, SUPERBLOCK_WORDS
from repro_torch.core.scan import stable_partition_indices


def bitpack_ref(bits: torch.Tensor) -> torch.Tensor:
    """(n,) 0/1 → ceil(n/32) int32 words, LSB-first."""
    return bitops.pack_bits(bitops.pad_bits(bits.long()))


def _inverse_of_stable_argsort(keys: torch.Tensor) -> torch.Tensor:
    n = keys.shape[0]
    order = torch.argsort(keys, stable=True)
    return torch.empty_like(order).scatter_(
        0, order, torch.arange(n, device=keys.device)).to(torch.int32)


def radix_rank_ref(digits: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Stable counting-sort destinations: the inverse of a stable argsort
    by digit."""
    del num_buckets
    return _inverse_of_stable_argsort(digits.long())


def wt_level_step_ref(sub: torch.Tensor, nid: torch.Tensor, shift: int,
                      n: int):
    """(dest, bitmap) of one segmented wavelet-tree level: stable
    destinations under a sort by (node id, level bit)."""
    bit = (bitops.u32(sub[:n]) >> shift) & 1
    dest = _inverse_of_stable_argsort((nid[:n].long() << 1) | bit)
    return dest, bitops.pack_bits(bitops.pad_bits(bit))


def rank_build_ref(words: torch.Tensor, n: int):
    """(superblock int32, block int16) of one packed n-bit row."""
    words = words[:bitops.num_words(n)]
    prefix = bitops.word_prefix_popcount(words)
    superblock = prefix[::SUPERBLOCK_WORDS]
    blk_prefix = prefix[::BLOCK_WORDS]
    sb_of_blk = torch.arange(blk_prefix.shape[0], device=words.device) // (
        SUPERBLOCK_WORDS // BLOCK_WORDS)
    block = blk_prefix - superblock[sb_of_blk]
    return superblock.to(torch.int32), block.to(torch.int16)


def rank_build_levels_ref(words: torch.Tensor, n: int):
    """Row-wise :func:`rank_build_ref` over stacked (L, W) rows."""
    outs = [rank_build_ref(words[l], n) for l in range(words.shape[0])]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


def wm_level_step_ref(sub: torch.Tensor, shift: int, n: int):
    """(dest, bitmap, total_zeros) for one level of one key row."""
    bit = (bitops.u32(sub[:n]) >> shift) & 1
    dest = stable_partition_indices(bit).to(torch.int32)
    bitmap = bitops.pack_bits(bitops.pad_bits(bit))
    return dest, bitmap, (n - bit.sum()).to(torch.int32)


def _cum0(level_words: torch.Tensor, n: int) -> torch.Tensor:
    """cum0[..., l, i] = # of zero bits among the first i bits of level l."""
    bits = bitops.unpack_bits(level_words, n).long()
    return F.pad(torch.cumsum(1 - bits, -1), (1, 0))


def wm_quantile_ref(level_words: torch.Tensor, zeros: torch.Tensor, n: int,
                    lo, hi, k) -> torch.Tensor:
    """Range-quantile oracle from raw (nbits, W) level bitmaps and (nbits,)
    zero counts; empty ranges give -1, k clamps."""
    nbits = level_words.shape[0]
    cum0 = _cum0(level_words, n)
    dev = level_words.device
    lo = torch.as_tensor(lo, device=dev).long().clamp(0, n)
    hi = torch.maximum(torch.as_tensor(hi, device=dev).long().clamp(max=n),
                       lo)
    k = torch.minimum(torch.as_tensor(k, device=dev).long().clamp(min=0),
                      (hi - lo - 1).clamp(min=0))
    empty = hi <= lo
    sym = torch.zeros_like(lo)
    for l in range(nbits):
        lo0, hi0 = cum0[l][lo], cum0[l][hi]
        z = hi0 - lo0
        bit = k >= z
        sym = (sym << 1) | bit.long()
        k = torch.where(bit, k - z, k)
        zl = zeros[l].long()
        lo = torch.where(bit, zl + (lo - lo0), lo0)
        hi = torch.where(bit, zl + (hi - hi0), hi0)
    return torch.where(empty, -1, sym).to(torch.int32)


def wm_quantile_sharded_ref(level_words: torch.Tensor, zeros: torch.Tensor,
                            shard_bits: int, n: int, lo, hi,
                            k) -> torch.Tensor:
    """Global sharded range-quantile oracle from raw (S, nbits, W) per-shard
    bitmaps and (S, nbits) zero counts: count-then-refine with dense
    per-shard prefix sums."""
    S, nbits, _ = level_words.shape
    size = 1 << shard_bits
    cum0 = _cum0(level_words, size)                       # (S, nbits, size+1)
    dev = level_words.device
    lo = torch.as_tensor(lo, device=dev).long().clamp(0, n)
    hi = torch.maximum(torch.as_tensor(hi, device=dev).long().clamp(max=n),
                       lo)
    base = (torch.arange(S, device=dev) << shard_bits)[:, None]
    los = (lo[None] - base).clamp(0, size)
    his = (hi[None] - base).clamp(0, size)
    total = (his - los).sum(0)
    k = torch.minimum(torch.as_tensor(k, device=dev).long().clamp(min=0),
                      (total - 1).clamp(min=0))
    sym = torch.zeros_like(k)
    for l in range(nbits):
        lo0 = torch.gather(cum0[:, l], 1, los)
        hi0 = torch.gather(cum0[:, l], 1, his)
        z = (hi0 - lo0).sum(0)
        bit = k >= z
        sym = (sym << 1) | bit.long()
        k = torch.where(bit, k - z, k)
        zl = zeros[:, l].long()[:, None]
        los = torch.where(bit, zl + (los - lo0), lo0)
        his = torch.where(bit, zl + (his - hi0), hi0)
    return torch.where(total <= 0, -1, sym).to(torch.int32)
