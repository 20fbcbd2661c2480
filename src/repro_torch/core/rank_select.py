"""Binary rank/select directories (port of the binary half of
``repro.core.rank_select``, paper Section 5 / Theorem 5.1).

Jacobson rank: an absolute rank per ``SUPERBLOCK_WORDS`` words (``int32``)
plus a superblock-relative rank per ``BLOCK_WORDS`` words (``int16``; the
values are at most 28·32 = 896). Clark-style select: the block holding
every ``sample_rate``-th target bit, with a binary search between samples
over ranks read from the rank directory.

Every structure may carry leading batch axes (levels, shards): a leaf of
shape (*B, X) holds one directory per batch row, and queries take indices
of shape (*B, *Q) — the reference's ``vmap`` written out.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import bitops
from .scan import lift, take

SUPERBLOCK_WORDS = 32
BLOCK_WORDS = 4
_BLOCKS_PER_SB = SUPERBLOCK_WORDS // BLOCK_WORDS
BLOCK_BITS = BLOCK_WORDS * bitops.WORD_BITS          # 128


# --------------------------------------------------------------------------
# Binary rank (Jacobson)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class BinaryRank:
    """Two-level rank directory over a packed bit sequence.

    ``superblock[k]`` = # of 1s strictly before word ``k*SUPERBLOCK_WORDS``;
    ``block[b]`` = # of 1s in b's superblock strictly before word
    ``b*BLOCK_WORDS``.
    """
    words: torch.Tensor       # (*B, W) int32 packed bits
    superblock: torch.Tensor  # (*B, ceil(W/32)) int32
    block: torch.Tensor       # (*B, ceil(W/4)) int16
    n: int

    @property
    def num_blocks(self) -> int:
        return self.block.shape[-1]

    @property
    def total_ones(self) -> torch.Tensor:
        i = torch.full(self.words.shape[:-1], self.n, dtype=torch.long,
                       device=self.words.device)
        return rank1(self, i)


def build_binary_rank(words: torch.Tensor, n: int) -> BinaryRank:
    """One popcount per word, one prefix sum, one subtraction (Theorem
    5.1). ``words`` must be zero past bit n."""
    prefix = bitops.word_prefix_popcount(words)
    superblock = prefix[..., ::SUPERBLOCK_WORDS]
    blk_prefix = prefix[..., ::BLOCK_WORDS]
    sb_of_blk = torch.arange(blk_prefix.shape[-1],
                             device=words.device) // _BLOCKS_PER_SB
    block = blk_prefix - superblock[..., sb_of_blk]
    return BinaryRank(words=words, superblock=superblock.to(torch.int32),
                      block=block.to(torch.int16), n=n)


def _rank_at_block_fast(rs: BinaryRank, b: torch.Tensor) -> torch.Tensor:
    """rank1 at a block boundary, b < num_blocks: two gathers."""
    return (take(rs.superblock, b // _BLOCKS_PER_SB).long()
            + take(rs.block, b).long())


def _block_words(rs: BinaryRank, b: torch.Tensor) -> torch.Tensor:
    """The BLOCK_WORDS words of block b as uint32 values (zero past the
    end): shape b.shape + (4,), ``int64``."""
    idx = (b.long() * BLOCK_WORDS)[..., None] + torch.arange(
        BLOCK_WORDS, device=b.device)
    last = rs.words.shape[-1] - 1
    words = bitops.u32(take(rs.words, idx.clamp(max=last)))
    return torch.where(idx <= last, words, 0)


def rank1(rs: BinaryRank, i: torch.Tensor) -> torch.Tensor:
    """# of 1 bits in positions [0, i): superblock + block + at most three
    whole-word popcounts + one masked popcount. ``int64``."""
    i = i.long()
    w = i // bitops.WORD_BITS
    bc = (w // BLOCK_WORDS).clamp(max=rs.num_blocks - 1)
    base = _rank_at_block_fast(rs, bc)
    words4 = _block_words(rs, bc)
    wpos = bc[..., None] * BLOCK_WORDS + torch.arange(BLOCK_WORDS,
                                                      device=i.device)
    off = (i - w * bitops.WORD_BITS)[..., None]
    w = w[..., None]
    cnt = torch.where(wpos < w, bitops.popcount(words4),
                      torch.where(wpos == w,
                                  bitops.rank1_word(words4, off), 0))
    return base + cnt.sum(-1)


def rank0(rs: BinaryRank, i: torch.Tensor) -> torch.Tensor:
    i = i.long()
    return i - rank1(rs, i)


def access_bit(rs: BinaryRank, i: torch.Tensor) -> torch.Tensor:
    i = i.long()
    word = bitops.u32(take(rs.words, i // bitops.WORD_BITS))
    return (word >> (i % bitops.WORD_BITS)) & 1


# --------------------------------------------------------------------------
# Binary select (Clark-style sampling over the rank directory)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class BinarySelect:
    """``sample[j]`` = block holding the (j·sample_rate)-th target bit."""
    sample: torch.Tensor      # (*B, n // sample_rate + 2) int32
    n: int
    sample_rate: int
    zeros: bool               # select0 directory?


def build_binary_select(words: torch.Tensor, n: int, sample_rate: int = 512,
                        zeros: bool = False) -> BinarySelect:
    """Block popcounts, one prefix sum and a batched searchsorted per
    sample (Theorem 5.1)."""
    lead = words.shape[:-1]
    nblk = (words.shape[-1] + BLOCK_WORDS - 1) // BLOCK_WORDS
    wp = F.pad(words, (0, nblk * BLOCK_WORDS - words.shape[-1]))
    ones = bitops.popcount(wp.reshape(lead + (nblk, BLOCK_WORDS))).sum(-1)
    if zeros:
        valid = (n - torch.arange(nblk, device=words.device) * BLOCK_BITS
                 ).clamp(0, BLOCK_BITS)
        counts = valid - ones
    else:
        counts = ones
    cum = F.pad(torch.cumsum(counts, -1), (1, 0))
    # +2: any valid k has both bracketing samples
    num_samples = n // sample_rate + 2
    targets = (torch.arange(num_samples, device=words.device)
               * sample_rate).expand(lead + (num_samples,)).contiguous()
    sample = torch.searchsorted(cum.contiguous(), targets, right=True) - 1
    return BinarySelect(sample=sample.clamp(0, nblk - 1).to(torch.int32),
                        n=n, sample_rate=sample_rate, zeros=zeros)


def _zero_rank_at_block_fast(rs: BinaryRank, b: torch.Tensor) -> torch.Tensor:
    pos = (b * BLOCK_BITS).clamp(max=rs.n)
    return pos - _rank_at_block_fast(rs, b)


def _select_search(rs: BinaryRank, sel: BinarySelect,
                   k: torch.Tensor) -> torch.Tensor:
    """Largest block b in [sample[j], sample[j+1]] with rank(b) <= k; the
    search keeps mid < num_blocks, so every probe is two gathers."""
    last = sel.sample.shape[-1] - 1
    j = (k // sel.sample_rate).clamp(0, last)
    lo = take(sel.sample, j).long()
    hi = take(sel.sample, (j + 1).clamp(max=last)).long() + 1
    hi = torch.maximum(hi, lo + 1)
    steps = max(1, math.ceil(math.log2(rs.num_blocks + 1)))
    probe = _zero_rank_at_block_fast if sel.zeros else _rank_at_block_fast
    for _ in range(steps):
        mid = (lo + hi) // 2
        go_right = probe(rs, mid) <= k
        lo = torch.where(go_right, mid, lo)
        hi = torch.maximum(torch.where(go_right, hi, mid), lo)
    return lo


def _select_in_block(rs: BinaryRank, b: torch.Tensor, cnt: torch.Tensor,
                     zeros: bool) -> torch.Tensor:
    """Position of the cnt-th target bit inside block b."""
    words4 = _block_words(rs, b)
    if zeros:
        # padding turns to 1s: a valid target lies before the padding
        words4 = ~words4 & 0xFFFFFFFF
    pc = bitops.popcount(words4)
    excl = torch.cumsum(pc, -1) - pc
    c = cnt[..., None]
    in_this = (excl <= c) & (c < excl + pc)
    wsel = torch.argmax(in_this.to(torch.uint8), -1, keepdim=True)
    word = torch.gather(words4, -1, wsel)[..., 0]
    base = torch.gather(excl, -1, wsel)[..., 0]
    within = bitops.select_in_word(word, cnt - base)
    return (b * BLOCK_WORDS + wsel[..., 0]) * bitops.WORD_BITS + within


def select1(rs: BinaryRank, sel: BinarySelect, k: torch.Tensor) -> torch.Tensor:
    """Position of the k-th (0-based) 1 bit. ``int64``."""
    k = k.long()
    b = _select_search(rs, sel, k)
    return _select_in_block(rs, b, k - _rank_at_block_fast(rs, b), False)


def select0(rs: BinaryRank, sel0: BinarySelect,
            k: torch.Tensor) -> torch.Tensor:
    """Position of the k-th (0-based) 0 bit. ``int64``."""
    k = k.long()
    b = _select_search(rs, sel0, k)
    return _select_in_block(rs, b, k - _zero_rank_at_block_fast(rs, b), True)


@dataclass(frozen=True)
class BitVector:
    """Packed bits + rank + select1/select0 — what a wavelet level stores."""
    rank: BinaryRank
    sel1: BinarySelect
    sel0: BinarySelect


def build_bitvector(words: torch.Tensor, n: int,
                    sample_rate: int = 512) -> BitVector:
    return BitVector(rank=build_binary_rank(words, n),
                     sel1=build_binary_select(words, n, sample_rate, False),
                     sel0=build_binary_select(words, n, sample_rate, True))


def build_bitvector_levels(words: torch.Tensor, n: int,
                           sample_rate: int = 512,
                           use_kernels: bool = False) -> BitVector:
    """Directories of every row of stacked level bitmaps (*B, L, W) at once.

    ``use_kernels`` routes the rank tables through
    ``kernels.ops.rank_build_levels`` (one launch for all rows); the select
    samples stay plain torch, as they stay XLA in the reference.
    """
    if use_kernels:
        from repro_torch.kernels import ops
        superblock, block = ops.rank_build_levels(
            words.reshape(-1, words.shape[-1]), n)
        lead = words.shape[:-1]
        rank = BinaryRank(words=words,
                          superblock=superblock.reshape(lead + (-1,)),
                          block=block.reshape(lead + (-1,)), n=n)
    else:
        rank = build_binary_rank(words, n)
    return BitVector(rank=rank,
                     sel1=build_binary_select(words, n, sample_rate, False),
                     sel0=build_binary_select(words, n, sample_rate, True))


# --------------------------------------------------------------------------
# Partition by select (the construction-side use of Theorem 5.1)
# --------------------------------------------------------------------------

def _word_zero_one_prefixes(words: torch.Tensor, n: int):
    """Per-word exclusive zero/one counts of an n-bit bitmap and its total
    ones. Padding bits past n must be 0."""
    pc = bitops.popcount(words)
    valid = (n - torch.arange(words.shape[-1], device=words.device)
             * bitops.WORD_BITS).clamp(0, bitops.WORD_BITS)
    zc = valid - pc
    zcum = torch.cumsum(zc, -1) - zc
    ocum = torch.cumsum(pc, -1) - pc
    return zcum, ocum, ocum[..., -1] + pc[..., -1]


def partition_select_directory(words: torch.Tensor, n: int):
    """Word-granularity select directory ``(zcum, ocum, Z, cm)`` over a
    packed n-bit flag bitmap: word w's zero run starts at target
    ``zcum[w]`` with mark w, its one run at ``Z + ocum[w]`` with mark
    ``W + w``, and ``cm[t]`` is the largest mark at or below target t, the
    word that feeds t. The reference scatters the marks and takes a running
    max; since ``zcum`` and ``ocum`` are sorted, the same mark is the last
    word whose run starts at or below t, found by ``searchsorted`` (torch's
    running max walks one long row in sequence on the card)."""
    W = words.shape[-1]
    lead = words.shape[:-1]
    zcum, ocum, total_ones = _word_zero_one_prefixes(words, n)
    Z = n - total_ones
    t = torch.arange(n, device=words.device).expand(lead + (n,)).contiguous()
    in_ones = t >= lift(Z, t)
    zero_word = torch.searchsorted(zcum.contiguous(), t, right=True) - 1
    one_word = torch.searchsorted(ocum.contiguous(), t - lift(Z, t),
                                  right=True) - 1
    cm = torch.where(in_ones, W + one_word, zero_word)
    return zcum, ocum, Z, cm


def partition_select(words: torch.Tensor, directory, bit: torch.Tensor,
                     t: torch.Tensor) -> torch.Tensor:
    """Source index of the t-th ``bit``-valued flag, via the directory."""
    zcum, ocum, Z, cm = directory
    W = words.shape[-1]
    one = bit == 1
    m = take(cm, torch.where(one, lift(Z, t) + t, t))
    w = torch.where(one, m - W, m)
    r = t - torch.where(one, take(ocum, w), take(zcum, w))
    word = bitops.u32(take(words, w))
    wsel = torch.where(one, word, ~word & 0xFFFFFFFF)
    return w * bitops.WORD_BITS + bitops.select_in_word(wsel, r)


def stable_partition_gather(words: torch.Tensor, total_zeros: torch.Tensor,
                            n: int) -> torch.Tensor:
    """Gather permutation of the stable 0/1 partition, via select: ``g``
    with ``g[..., p]`` = source index of the element landing at p, so
    ``take(x, g)`` realizes the partition. ``total_zeros`` is derivable and
    kept for the reference's signature."""
    del total_zeros
    directory = partition_select_directory(words, n)
    Z = directory[2]
    p = torch.arange(n, device=words.device).expand(words.shape[:-1] + (n,))
    is_one = p >= lift(Z, p)
    t = torch.where(is_one, p - lift(Z, p), p)
    return partition_select(words, directory, is_one.long(), t)


def _rank1_at(words: torch.Tensor, ocum: torch.Tensor,
              total_ones: torch.Tensor, pos: torch.Tensor,
              n: int) -> torch.Tensor:
    """rank1 at positions ``pos`` (each in [0, n]) from the word directory:
    one word gather and one masked popcount per query. ``int64``."""
    W = words.shape[-1]
    pos = pos.long()
    w = pos // bitops.WORD_BITS
    wc = w.clamp(max=W - 1)
    part = take(ocum, wc) + bitops.rank1_word(take(words, wc),
                                              pos % bitops.WORD_BITS)
    # pos == n with n a word multiple walks past the last word: total ones
    return torch.where(w >= W, lift(total_ones, pos), part)


def segmented_partition_gather(words: torch.Tensor, nid: torch.Tensor,
                               node_start: torch.Tensor,
                               n: int) -> torch.Tensor:
    """Gather permutation of the stable *per-node* 0/1 partition.

    ``words``: packed n-bit flag bitmap (zero past n); ``nid``: node id of
    each element (grouped by node, non-decreasing); ``node_start``: (V,)
    start offset of every node (empty nodes repeat the next start). Returns
    ``g`` with ``g[..., p]`` = source index of the element landing at p, so
    ``take(x, g)`` turns every node's segment into [zeros | ones], both
    stably. A per-node split never crosses a node boundary, so position p
    takes ``select0(rank0(node_start) + offset)`` (or select1) on the global
    bitmap: one word-granularity select directory serves every node, and
    only the O(V) boundary ranks are per node.
    """
    directory = partition_select_directory(words, n)
    zcum, ocum, Z, _ = directory
    total_ones = n - Z
    ns = node_start.long()
    ones_at = _rank1_at(words, ocum, total_ones, ns, n)
    zeros_at = ns - ones_at                              # rank0(node start)
    znode = torch.cat([zeros_at[..., 1:], Z[..., None]], -1) - zeros_at
    p = torch.arange(n, device=words.device).expand(nid.shape)
    v = nid.long()
    start = take(ns, v)
    offp = p - start
    zeros_before = take(zeros_at, v)
    zn = take(znode, v)
    is_one = offp >= zn
    t = torch.where(is_one, (start - zeros_before) + offp - zn,
                    zeros_before + offp)
    return partition_select(words, directory, is_one.long(), t)
