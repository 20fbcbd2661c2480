"""Rank/select directories (port of ``repro.core.rank_select``, paper
Section 5): the binary ones of Theorem 5.1, the partition-by-select
gathers of the construction, and the generalized (σ-ary) ones of Section
5.2 with the d-way gathers of the multiary trees.

Jacobson rank: an absolute rank per ``SUPERBLOCK_WORDS`` words (``int32``)
plus a superblock-relative rank per ``BLOCK_WORDS`` words (``int16``; the
values are at most 28·32 = 896). Clark-style select: the block holding
every ``sample_rate``-th target bit, with a binary search between samples
over ranks read from the rank directory.

Generalized rank/select over ``width``-bit symbols keeps per-chunk symbol
counts and finishes a query inside one chunk by comparing packed fields
(XOR with the broadcast symbol, OR-fold each field onto its start bit).

Every binary structure may carry leading batch axes (levels, shards): a leaf of
shape (*B, X) holds one directory per batch row, and queries take indices
of shape (*B, *Q) — the reference's ``vmap`` written out.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .. import obs
from . import bitops
from .scan import lift, take
from ..tree import tree_leaves

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


def rank1_rows(rs: BinaryRank, row: torch.Tensor,
               i: torch.Tensor) -> torch.Tensor:
    """:func:`rank1` of lanes that each name their own row: ``rs`` holds
    (R, X) leaves, lane j probes row ``row[j]`` at position ``i[j]`` (any
    shapes that broadcast). The gathers read the flat leaves, so ragged
    lanes over many rows (a shard and a level each) cost no copy.
    ``int64``."""
    row, i = torch.broadcast_tensors(row.long(), i.long())
    W, nsb, nblk = (rs.words.shape[-1], rs.superblock.shape[-1],
                    rs.block.shape[-1])
    w = i // bitops.WORD_BITS
    bc = (w // BLOCK_WORDS).clamp(max=nblk - 1)
    base = (rs.superblock.reshape(-1)[row * nsb + bc // _BLOCKS_PER_SB].long()
            + rs.block.reshape(-1)[row * nblk + bc].long())
    wpos = bc[..., None] * BLOCK_WORDS + torch.arange(BLOCK_WORDS,
                                                      device=i.device)
    words4 = bitops.u32(rs.words.reshape(-1)[
        row[..., None] * W + wpos.clamp(max=W - 1)])
    words4 = torch.where(wpos < W, words4, 0)
    off = (i - w * bitops.WORD_BITS)[..., None]
    w = w[..., None]
    cnt = torch.where(wpos < w, bitops.popcount(words4),
                      torch.where(wpos == w,
                                  bitops.rank1_word(words4, off), 0))
    return base + cnt.sum(-1)


def rank_at_block(rs: BinaryRank, b) -> torch.Tensor:
    """# of 1 bits strictly before block b, b ≤ num_blocks (one past the
    end adds the last block's popcount). ``int64``."""
    b = torch.as_tensor(b, device=rs.words.device).long()
    bc = b.clamp(max=rs.num_blocks - 1)
    base = _rank_at_block_fast(rs, bc)
    over = bitops.popcount(_block_words(rs, bc)).sum(-1)
    return torch.where(b > bc, base + over, base)


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


def _zero_rank_at_block(rs: BinaryRank, b) -> torch.Tensor:
    b = torch.as_tensor(b, device=rs.words.device).long()
    return (b * BLOCK_BITS).clamp(max=rs.n) - rank_at_block(rs, b)


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


def invert_words(words: torch.Tensor, n: int) -> torch.Tensor:
    """~words along the last axis with the padding bits (≥ n) kept 0."""
    inv = ~words
    idx = torch.arange(words.shape[-1], device=words.device)
    last = bitops.num_words(n) - 1
    tail = bitops.to_i32(bitops.mask_below(
        torch.tensor(n - last * bitops.WORD_BITS)))
    inv = torch.where(idx == last, inv & tail.to(words.device), inv)
    return torch.where(idx > last, 0, inv)


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
    samples stay plain torch, as they stay XLA in the reference. Counts
    ``core.rank_build{impl=kernel|torch}`` (the reference's ``impl=xla``).
    """
    obs.counter("core.rank_build",
                impl="kernel" if use_kernels else "torch").inc()
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


# --------------------------------------------------------------------------
# d-way partitions by select (the multiary trees, paper Theorem 4.4)
# --------------------------------------------------------------------------

_FIELDS_SUPERWORD = 16      # words per run-start mark in the d-way select


def _column_exclusive_sum(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sums down each column of (R, C) counts, ``int64``.

    torch scans a dimension of a 2-D tensor with one thread (or half a
    warp) walking each column or row in sequence on the card, and only a
    1-D tensor through one parallel device-wide scan. So the columns are
    laid end to end, scanned once, and each column's offset (the sum of
    the columns before it) taken off again: exact, as counts never wrap.
    """
    rows, cols = x.shape
    flat = x.long().T.reshape(-1)
    excl = (torch.cumsum(flat, 0) - flat).reshape(cols, rows)
    return (excl - excl[:, :1]).T


def _field_start_mult(width: int) -> int:
    """A 1 at the start bit of every ``width``-bit field of a word."""
    return sum(1 << (j * width) for j in range(32 // width))


def _field_eq_mask(words: torch.Tensor, dv, width: int) -> torch.Tensor:
    """SWAR equality mask (``int64``): bit ``j*width`` set iff field j of
    the word equals ``dv``. XOR with the broadcast digit, OR-fold each
    field onto its start bit, invert: the packed-list form of the paper's
    count-symbol-in-word table."""
    mult = _field_start_mult(width)
    dv = torch.as_tensor(dv, device=words.device).long()
    x = bitops.u32(words) ^ ((dv * mult) & 0xFFFFFFFF)
    y = x
    for s in range(1, width):
        y = y | (x >> s)
    return ~y & mult


def packed_field_counts(digits: torch.Tensor, width: int, n: int):
    """(packed ``int32`` words, per-(word, digit) counts (Wf, d) ``int32``)
    of a digit sequence, padding excluded: the word directory that the
    d-way gather, the generalized directory build and the multiary node
    offsets share."""
    per = 32 // width
    packed = bitops.pack_fields(digits, width)
    Wf = packed.shape[0]
    vf = (n - torch.arange(Wf, device=packed.device) * per).clamp(0, per)
    vmask = bitops.mask_below(vf * width)
    cntwd = torch.stack(
        [bitops.popcount(_field_eq_mask(packed, dv, width) & vmask)
         for dv in range(1 << width)], 1)
    return packed, cntwd.to(torch.int32)


def field_node_counts(packed: torch.Tensor, cntwd: torch.Tensor, width: int,
                      node_start: torch.Tensor, n: int):
    """Per-node digit boundary ranks, both (V, d) ``int32``: ``rank_at[v,
    dv]`` = # of dv digits before node v's start, ``cnt_node[v, dv]`` = #
    inside node v (which is the next level's node-size table)."""
    per = 32 // width
    Wf = packed.shape[0]
    cw = cntwd.long()
    vcum = _column_exclusive_sum(cw)
    totals = vcum[-1] + cw[-1]
    ns = node_start.long()
    w0 = (ns // per).clamp(max=Wf - 1)
    words0 = packed[w0]
    below = bitops.mask_below((ns % per) * width)
    before = torch.stack(
        [bitops.popcount(_field_eq_mask(words0, dv, width) & below)
         for dv in range(1 << width)], 1)
    rank_at = torch.where((ns // per >= Wf)[:, None], totals[None, :],
                          vcum[w0] + before)
    cnt_node = torch.cat([rank_at[1:], totals[None, :]]) - rank_at
    return rank_at.to(torch.int32), cnt_node.to(torch.int32)


def segmented_partition_gather_fields(digits: torch.Tensor, width: int,
                                      nid: torch.Tensor,
                                      node_start: torch.Tensor, n: int,
                                      plan=None) -> torch.Tensor:
    """Gather permutation (``int32``) of the stable per-node d-way
    partition, d = 2^width: every node's segment becomes [digit-0 run |
    … | digit-(d−1) run], each run stable.

    Position p of node v takes the (t)-th digit dv of the sequence, dv and
    t from the node's digit counts; that digit is found by a run-start
    mark at superword granularity (``_FIELDS_SUPERWORD`` words) in the
    digit-major target space, a binary refine to the word, and an in-word
    select on the SWAR equality mask. The reference scatters the marks and
    takes a running max; the mark positions are sorted, so the same mark
    is the last one at or below the target, found by ``searchsorted``.
    ``plan``: the output of :func:`packed_field_counts` when already made.
    """
    d = 1 << width
    per = 32 // width
    packed, cntwd = (plan if plan is not None
                     else packed_field_counts(digits, width, n))
    Wf = packed.shape[0]
    cw = cntwd.long()
    vcum = _column_exclusive_sum(cw)                       # (Wf, d)
    vflat = vcum.reshape(-1)
    totals = vcum[-1] + cw[-1]
    dbase = torch.cumsum(totals, 0) - totals               # (d,) excl.
    rank_at, cnt_node = field_node_counts(packed, cntwd, width, node_start,
                                          n)
    cn = cnt_node.long()
    ndp = torch.cumsum(cn, 1) - cn                         # (V, d) excl.
    ns = node_start.long()
    v = nid.long()
    offp = torch.arange(n, device=packed.device) - ns[v]
    # the digit run of every position: runs ahead of it, less one
    dv = torch.full_like(offp, -1)
    for j in range(d):
        dv += offp >= ndp[:, j][v]
    vd = v * d + dv
    t = rank_at.reshape(-1).long()[vd] + offp - ndp.reshape(-1)[vd]
    # superword run-start marks, digit-major: mark dv·wsup + s at target
    # dbase[dv] + vcum[s·S, dv]
    S = _FIELDS_SUPERWORD
    wsup = (Wf + S - 1) // S
    mark_at = (dbase[:, None] + vcum[::S].T).reshape(-1)
    ws = (torch.searchsorted(mark_at, dbase[dv] + t, right=True) - 1
          - dv * wsup)
    # refine: the rightmost word of the superword with vcum[w, dv] <= t
    lo = ws * S
    hi = (lo + (S - 1)).clamp(max=Wf - 1)
    for _ in range(max(1, math.ceil(math.log2(S)))):
        mid = (lo + hi + 1) // 2
        go = vflat[mid * d + dv] <= t
        lo = torch.where(go, mid, lo)
        hi = torch.where(go, hi, mid - 1)
    r = t - vflat[lo * d + dv]
    eqb = _field_eq_mask(packed[lo], dv, width)
    return (lo * per + bitops.select_in_word(eqb, r) // width).to(
        torch.int32)


def bitvector_bits(bv) -> int:
    """Total storage in bits of a structure's tensors (bitmap and
    directories)."""
    return sum(x.numel() * x.element_size() * 8 for x in tree_leaves(bv))


# --------------------------------------------------------------------------
# Generalized rank/select for small alphabets (paper Section 5.2)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class GeneralizedRankSelect:
    """Rank/select over ``width``-bit symbols, σ = 2^width.

    ``chunk_cum[k, c]`` = # of symbol c strictly before chunk k (chunks of
    ``chunk_syms`` symbols); queries finish inside one chunk with field
    compares on the packed words.
    """
    packed: torch.Tensor      # (num_chunks · words a chunk,) int32 fields
    chunk_cum: torch.Tensor   # (num_chunks + 1, sigma) int32
    n: int
    width: int
    chunk_syms: int

    @property
    def sigma(self) -> int:
        return 1 << self.width


def _chunk_words(width: int, chunk_syms: int) -> int:
    per = 32 // width
    if chunk_syms % per:
        raise ValueError(f"chunk_syms {chunk_syms} is not a multiple of the "
                         f"{per} fields a word")
    return chunk_syms // per


def _chunk_cum(hist: torch.Tensor) -> torch.Tensor:
    """(chunks + 1, σ) ``int32``: row k the count of each symbol before
    chunk k, from the (chunks, σ) chunk histogram."""
    return _column_exclusive_sum(F.pad(hist, (0, 0, 0, 1))).to(torch.int32)


def build_generalized_from_counts(packed: torch.Tensor, cntwd: torch.Tensor,
                                  width: int, n: int, chunk_syms: int = 128
                                  ) -> GeneralizedRankSelect:
    """:func:`build_generalized` from the shared word directory of
    :func:`packed_field_counts`: the chunk histogram is a reshape-sum over
    the per-word counts. The same structure as ``build_generalized``."""
    wpc = _chunk_words(width, chunk_syms)
    sigma = 1 << width
    num_chunks = (n + chunk_syms - 1) // chunk_syms
    want = num_chunks * wpc
    packed = F.pad(packed, (0, max(0, want - packed.shape[0])))[:want]
    cntwd = F.pad(cntwd, (0, 0, 0, max(0, want - cntwd.shape[0])))[:want]
    hist = cntwd.long().reshape(num_chunks, wpc, sigma).sum(1)
    return GeneralizedRankSelect(packed=packed, chunk_cum=_chunk_cum(hist),
                                 n=n, width=width, chunk_syms=chunk_syms)


def build_generalized(seq: torch.Tensor, width: int, n: int,
                      chunk_syms: int = 128) -> GeneralizedRankSelect:
    """Paper Theorem 5.2: the prefix sum with the "add two σ-count vectors"
    operator is a cumsum over the (chunks × σ) histogram."""
    wpc = _chunk_words(width, chunk_syms)
    sigma = 1 << width
    packed = bitops.pack_fields(seq, width)
    num_chunks = (n + chunk_syms - 1) // chunk_syms
    packed = F.pad(packed, (0, max(0, num_chunks * wpc - packed.shape[0])))
    # padding counts as the sentinel symbol sigma, dropped after counting
    seq_p = F.pad(seq.to(torch.int32), (0, num_chunks * chunk_syms - n),
                  value=sigma)
    chunk_ids = torch.arange(seq_p.shape[0], device=seq.device) // chunk_syms
    bins = num_chunks * (sigma + 1)
    hist = torch.bincount(chunk_ids * (sigma + 1) + seq_p,
                          minlength=bins)[:bins]
    hist = hist.reshape(num_chunks, sigma + 1)[:, :sigma]
    return GeneralizedRankSelect(packed=packed, chunk_cum=_chunk_cum(hist),
                                 n=n, width=width, chunk_syms=chunk_syms)


def _count_symbol_in_words(words: torch.Tensor, c: torch.Tensor, width: int,
                           upto_fields: torch.Tensor) -> torch.Tensor:
    """# of fields equal to c among the first ``upto_fields`` fields of
    ``words`` (…, W), counted over the trailing word axis; ``int32``."""
    per = 32 // width
    W = words.shape[-1]
    shifts = torch.arange(per, device=words.device) * width
    fields = (bitops.u32(words)[..., :, None] >> shifts) & ((1 << width) - 1)
    eq = fields == c[..., None, None]
    pos = (torch.arange(W, device=words.device)[:, None] * per
           + torch.arange(per, device=words.device)[None, :])
    valid = pos < upto_fields[..., None, None]
    return (eq & valid).sum((-1, -2)).to(torch.int32)


def _gen_args(g: GeneralizedRankSelect, *xs) -> list:
    return list(torch.broadcast_tensors(
        *(torch.as_tensor(x, device=g.packed.device).long() for x in xs)))


def _chunk_window(g: GeneralizedRankSelect, chunk: torch.Tensor):
    """The packed words of each chunk (…, words a chunk); a window past
    the end slides back to the last whole one, as ``dynamic_slice``
    does."""
    wpc = g.chunk_syms // (32 // g.width)
    w0 = (chunk * wpc).clamp(0, g.packed.shape[0] - wpc)
    return g.packed[w0[..., None] + torch.arange(wpc, device=w0.device)]


def _cum_at(g: GeneralizedRankSelect, chunk: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """``chunk_cum[chunk, c]`` with the indices clamped into the table, as
    the reference's gathers clamp them."""
    return g.chunk_cum[chunk.clamp(0, g.chunk_cum.shape[0] - 1),
                       c.clamp(0, g.sigma - 1)].long()


def generalized_rank(g: GeneralizedRankSelect, c, i) -> torch.Tensor:
    """# of occurrences of symbol c in positions [0, i); ``int32``."""
    c, i = _gen_args(g, c, i)
    chunk = i // g.chunk_syms
    win = _chunk_window(g, chunk)
    return (_cum_at(g, chunk, c) + _count_symbol_in_words(
        win, c, g.width, i - chunk * g.chunk_syms)).to(torch.int32)


def generalized_access(g: GeneralizedRankSelect, i) -> torch.Tensor:
    """The symbol at position i; ``int32``."""
    (i,) = _gen_args(g, i)
    per = 32 // g.width
    w = (i // per).clamp(0, g.packed.shape[0] - 1)
    word = bitops.u32(g.packed[w])
    return ((word >> ((i % per) * g.width))
            & ((1 << g.width) - 1)).to(torch.int32)


def generalized_select(g: GeneralizedRankSelect, c, k) -> torch.Tensor:
    """Position of the k-th (0-based) occurrence of c; ``int32``.

    The chunk is the last whose count of c is at most k (the reference's
    ``searchsorted`` over the column, here a binary search over the table
    that gathers one entry a step, so a batch never holds its columns),
    then the within-chunk position of the residual occurrence. Out-of-range
    ``k`` gives a clamped position in [0, n), as in the reference.
    """
    c, k = _gen_args(g, c, k)
    rows = g.chunk_cum.shape[0]
    lo = torch.zeros_like(k)                   # count of entries <= k
    hi = torch.full_like(k, rows)
    for _ in range(rows.bit_length()):
        mid = (lo + hi) // 2
        live = lo < hi
        le = _cum_at(g, mid, c) <= k
        lo = torch.where(live & le, mid + 1, lo)
        hi = torch.where(live & ~le, mid, hi)
    chunk = (lo - 1).clamp(0, rows - 2)
    residual = k - _cum_at(g, chunk, c)
    per = 32 // g.width
    win = _chunk_window(g, chunk)
    shifts = torch.arange(per, device=win.device) * g.width
    fields = (bitops.u32(win)[..., :, None] >> shifts) & ((1 << g.width) - 1)
    eq = (fields == c[..., None, None]).flatten(-2)
    hit = torch.cumsum(eq, -1) == (residual + 1)[..., None]
    pos = torch.argmax(hit.to(torch.uint8), -1)
    return (chunk * g.chunk_syms + pos).clamp(0, g.n - 1).to(torch.int32)
