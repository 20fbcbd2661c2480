"""Parallel wavelet tree construction (paper Section 4, Theorems 4.1–4.2)
and queries (port of ``repro.core.wavelet_tree``).

Levelwise layout: level l stores one n-bit bitmap, the concatenation of all
node bitmaps at depth l, with the sequence stably sorted by the top l bits
of each symbol; ``node_starts[l][v]`` is the offset of node v in it.

``build_wavelet_tree`` is the τ-chunked sort-based construction: every τ
levels a big step regroups the full-width symbols by their top bits, and
the levels in between split narrow τ-bit keys ("short lists") per node.
On CUDA tensors the shallow levels (2^(l+1) ≤ 512 (node, bit) buckets) go
through the ``wt_level`` kernel, one launch a level given the level's
bucket starts from ``node_starts``; the deeper ones through the segmented
select-gather (``rank_select.segmented_partition_gather``) with their
bitmaps packed by the ``bitpack`` kernel; the radix big step through the
``radix_rank`` kernel where its bucket count allows, one launch given the
bucket starts from ``node_starts``; and all directories through
``rank_build_levels``. Every route gives the same bits.

The reference's other constructions, all giving the same tree:
``build_wavelet_tree(fused=False)`` (the step-by-step scatter form of
Theorem 4.1: histogram + segmented scans + inverse-permutation scatters),
``build_wavelet_tree_levelwise`` (the O(n logσ) prior-work baseline) and
``build_wavelet_tree_dd`` (the domain decomposition of Theorem 4.2). On a
CUDA device their level bitmaps pack through ``bitpack`` and the
unfused radix big step ranks through ``radix_rank`` where
``core.sort.counting_rank`` routes it; their directories are plain torch,
as the reference builds them without kernels.

Counters (the reference's): ``core.build{builder, path}`` a build,
``core.level_step{builder=wt, impl=kernel|torch}`` a moving level of the
fused build (the reference's ``impl=xla``) and ``core.wt_deep_fallback
{level}`` a level too deep for the ``wt_level`` kernel on the kernel
route.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch

from .. import obs
from . import bitops
from .rank_select import (BitVector, access_bit, build_bitvector,
                          build_bitvector_levels, rank0, rank1,
                          segmented_partition_gather, select0, select1)
from .scan import (apply_permutation_dest, exclusive_sum,
                   segment_ids_from_starts, segmented_exclusive_sum, take)
from .sort import _invert_permutation, sort_pass
from .wavelet_matrix import _pack_level, num_levels
from ..device import resolve_device
from ..tree import tree_map


@dataclass(frozen=True)
class WaveletTree:
    """Levelwise wavelet tree: per-level bitvectors (every leaf carries a
    leading (nbits,) axis) and ``node_starts`` (nbits+1, 2^nbits) int32,
    whose row l holds the start of every depth-l node (the first 2^l
    entries mean something) and whose row nbits is the symbol offset
    table."""
    bitvectors: BitVector
    node_starts: torch.Tensor
    n: int
    nbits: int

    def level(self, l: int) -> BitVector:
        return tree_map(lambda x: x[l], self.bitvectors)


def _node_starts_from_symbols(seq: torch.Tensor, nbits: int) -> torch.Tensor:
    """Offsets of every node at every level from the symbol histogram and
    one prefix sum: node v at level l starts at the count of symbols below
    v << (nbits - l)."""
    size = 1 << nbits
    hist = torch.bincount(seq.long(), minlength=size)[:size]
    leaf_starts = exclusive_sum(hist).to(torch.int32)
    rows = torch.zeros((nbits + 1, size), dtype=torch.int32,
                       device=seq.device)
    for l in range(nbits + 1):
        starts = leaf_starts[::1 << (nbits - l)]
        rows[l, :starts.shape[0]] = starts
    return rows


def _level_nid(node_starts: torch.Tensor, l: int, n: int) -> torch.Tensor:
    """Node id of every position at level l, from the offset table alone:
    after the split of level l-1 the sequence is grouped by its top l
    bits. ``int32``."""
    if l == 0:
        return torch.zeros(n, dtype=torch.int32, device=node_starts.device)
    return segment_ids_from_starts(node_starts[l, :1 << l], n)


def _wt_kernel_fits(l: int) -> bool:
    from repro_torch.kernels.wt_level import MAX_KEYS
    return (1 << (l + 1)) <= MAX_KEYS


def _finalize(level_words: List[torch.Tensor], node_starts: torch.Tensor,
              n: int, nbits: int, sample_rate: int) -> WaveletTree:
    """One ``build_bitvector`` a level, stacked: the unfused builds'
    directories (the same leaves as :func:`_finalize_fused`)."""
    bvs = [build_bitvector(w, n, sample_rate) for w in level_words]
    return WaveletTree(bitvectors=tree_map(lambda *xs: torch.stack(xs), *bvs),
                       node_starts=node_starts, n=n, nbits=nbits)


def _finalize_fused(level_words: List[torch.Tensor],
                    node_starts: torch.Tensor, n: int, nbits: int,
                    sample_rate: int, use_kernels: bool) -> WaveletTree:
    """All nbits rank/select directories at once."""
    bvs = build_bitvector_levels(torch.stack(level_words), n, sample_rate,
                                 use_kernels=use_kernels)
    return WaveletTree(bitvectors=bvs, node_starts=node_starts, n=n,
                       nbits=nbits)


def _segmented_partition_dest(nid: torch.Tensor, bit: torch.Tensor,
                              level_plus1_bits: int) -> torch.Tensor:
    """Destination of each element under a stable per-node 0/1 partition
    (``int32``): ``nid`` the node id of each element (grouped by node),
    ``bit`` the partition bit. The start of its (node, bit) bucket, from a
    histogram of 2^level_plus1_bits buckets and one prefix sum, plus its
    rank among the node's equal bits, from two segmented prefix sums."""
    n = nid.shape[0]
    bit = bit.to(torch.int32)
    key = (nid.long() << 1) | bit
    hist = torch.bincount(key, minlength=1 << level_plus1_bits)
    key_start = exclusive_sum(hist)
    seg_start = torch.ones(n, dtype=torch.bool, device=nid.device)
    seg_start[1:] = nid[1:] != nid[:-1]
    zeros_before = segmented_exclusive_sum(1 - bit, seg_start)
    ones_before = segmented_exclusive_sum(bit, seg_start)
    rank_within = torch.where(bit == 0, zeros_before, ones_before)
    return (key_start[key] + rank_within).to(torch.int32)


def _input(seq, device):
    """(device, (n,) int32 symbols on it) of a build's input."""
    dev = resolve_device(device)
    seq = torch.as_tensor(seq, device=dev)
    if seq.dim() != 1:
        raise ValueError(f"seq must be 1-D, got shape {tuple(seq.shape)}")
    return dev, seq.to(torch.int32)


def _tree_big_step(order: torch.Tensor, nbits: int, consumed: int,
                   big_step: str, use_kernels: bool,
                   node_starts: torch.Tensor) -> torch.Tensor:
    """One stable sort keyed on the top ``consumed`` bits: globally a sort
    by (node, next τ bits). Bucket v of that sort is the depth-``consumed``
    node v, so its start is ``node_starts[consumed, v]``."""
    key = (bitops.u32(order) >> (nbits - consumed)).to(torch.int32)
    backend = "counting" if big_step == "radix" else "xla"
    return sort_pass(order, key, 1 << consumed, backend=backend,
                     use_kernel=use_kernels,
                     bucket_starts=node_starts[consumed, :1 << consumed])[0]


def build_wavelet_tree(seq, sigma: int, tau: int = 8,
                       big_step: str = "compose", sample_rate: int = 512,
                       fused: bool = True, use_kernels: bool | None = None,
                       device: str | torch.device = "cuda") -> WaveletTree:
    """τ-chunked sort-based construction (paper Theorem 4.1).

    ``seq``: (n,) symbols in [0, sigma), moved to ``device``. Each
    node-segmented stable partition is applied as a gather (or, through the
    ``wt_level`` kernel, as the scatter of its destinations); node
    membership is re-derived per level from ``node_starts``; the composed
    permutation exists only when a compose big step consumes it.
    ``use_kernels`` (``None``: on a CUDA device) routes the shallow levels,
    the level bitmaps, the radix big step and the rank tables through the
    kernels. ``fused=False`` is the reference's scatter baseline
    (:func:`_build_wavelet_tree_steps`), whose ``use_kernels`` covers the
    bitmaps and the radix big step; both give the same tree.
    """
    if big_step not in ("compose", "radix", "xla"):
        raise ValueError(f"unknown big_step {big_step!r}")
    dev, order = _input(seq, device)
    if use_kernels is None:
        use_kernels = dev.type == "cuda"
    obs.counter("core.build", builder="wt",
                path="fused" if fused else "scatter").inc()
    if not fused:
        return _build_wavelet_tree_steps(order, sigma, tau, big_step,
                                         sample_rate, use_kernels)
    n = order.shape[0]
    nbits = num_levels(sigma)
    node_starts = _node_starts_from_symbols(order, nbits)
    level_words: List[torch.Tensor] = []

    for alpha0 in range(0, nbits, tau):
        width = min(tau, nbits - alpha0)
        sub = bitops.extract_field(order, nbits - alpha0 - width,
                                   width).to(torch.int32)
        last_chunk = alpha0 + width >= nbits
        need_idx = not last_chunk and big_step == "compose"
        idx = (torch.arange(n, dtype=torch.int32, device=dev)
               if need_idx else None)
        for t in range(width):
            l = alpha0 + t
            shift = width - 1 - t
            # movement arranges the next level; at the chunk's last level
            # only a compose big step still consumes the permutation
            move = l < nbits - 1 and (t < width - 1 or need_idx)
            if move:
                kernel_ok = _wt_kernel_fits(l)
                if use_kernels and not kernel_ok:
                    # 2^(l+1) buckets exceed the wt_level kernel's bound:
                    # the deep levels are plain torch, counted so profiles
                    # show the fallback
                    obs.counter("core.wt_deep_fallback", level=l).inc()
                obs.counter("core.level_step", builder="wt",
                            impl="kernel" if use_kernels and kernel_ok
                            else "torch").inc()
            if move and use_kernels and _wt_kernel_fits(l):
                from repro_torch.kernels import ops
                nid = _level_nid(node_starts, l, n)
                nbkt = 1 << (l + 1)
                # bucket (v, b) starts where child 2v + b does
                dest, words = ops.wt_level_step_fused(
                    sub, nid, shift, nbkt, n, node_starts[l + 1, :nbkt])
                if t < width - 1:
                    sub = apply_permutation_dest(sub, dest)
                if need_idx:
                    idx = apply_permutation_dest(idx, dest)
            else:
                words = _pack_level((sub >> shift) & 1, use_kernels)
                if move:
                    nid = _level_nid(node_starts, l, n)
                    g = segmented_partition_gather(
                        words, nid, node_starts[l, :1 << l], n)
                    if t < width - 1:
                        sub = sub[g]
                    if need_idx:
                        idx = idx[g]
            level_words.append(words)
        if not last_chunk:
            if big_step == "compose":
                order = order[idx.long()]
            else:
                order = _tree_big_step(order, nbits, alpha0 + width,
                                       big_step, use_kernels, node_starts)

    return _finalize_fused(level_words, node_starts, n, nbits, sample_rate,
                           use_kernels)


def _build_wavelet_tree_steps(order: torch.Tensor, sigma: int, tau: int,
                              big_step: str, sample_rate: int,
                              use_kernels: bool) -> WaveletTree:
    """The reference's step-by-step scatter form of Theorem 4.1 on (n,)
    int32 symbols: node ids carried along, each level's per-node split
    applied as the inverse of :func:`_segmented_partition_dest`, the
    composed permutation always kept, one directory build a level. The
    radix big step ranks by ``core.sort.counting_rank`` without bucket
    starts (through ``radix_rank`` where its route allows)."""
    n = order.shape[0]
    nbits = num_levels(sigma)
    node_starts = _node_starts_from_symbols(order, nbits)
    level_words: List[torch.Tensor] = []
    for alpha0 in range(0, nbits, tau):
        width = min(tau, nbits - alpha0)
        sub = bitops.extract_field(order, nbits - alpha0 - width,
                                   width).to(torch.int32)
        nid = (order >> (nbits - alpha0) if alpha0
               else torch.zeros_like(order))
        perm = None
        for t in range(width):
            bit = (sub >> (width - 1 - t)) & 1
            level_words.append(_pack_level(bit, use_kernels))
            if alpha0 + t < nbits - 1:
                g = _invert_permutation(_segmented_partition_dest(
                    nid, bit, alpha0 + t + 1)).long()
                sub = sub[g]
                nid = ((nid << 1) | bit)[g]
                perm = g if perm is None else perm[g]
        if alpha0 + width < nbits:
            if big_step == "compose":
                order = order[perm]
            else:
                # one stable sort keyed on (node, next τ bits): globally a
                # sort by the top alpha0 + width bits
                consumed = alpha0 + width
                order = sort_pass(
                    order, order >> (nbits - consumed), 1 << consumed,
                    backend="counting" if big_step == "radix" else "xla",
                    use_kernel=use_kernels)[0]
    return _finalize(level_words, node_starts, n, nbits, sample_rate)


def build_wavelet_tree_levelwise(seq, sigma: int, sample_rate: int = 512,
                                 fused: bool = True,
                                 device: str | torch.device = "cuda"
                                 ) -> WaveletTree:
    """Prior-work baseline [Shun'15]: O(n·logσ) work, the full-width
    symbols split per node at every level. ``fused=True`` applies each
    split as a segmented select-gather, ``fused=False`` as the inverse of
    its scatter destinations; the same tree either way."""
    obs.counter("core.build", builder="wt_levelwise",
                path="fused" if fused else "scatter").inc()
    dev, order = _input(seq, device)
    on_card = dev.type == "cuda"
    n = order.shape[0]
    nbits = num_levels(sigma)
    node_starts = _node_starts_from_symbols(order, nbits)
    level_words: List[torch.Tensor] = []
    for l in range(nbits):
        bit = (order >> (nbits - 1 - l)) & 1
        words = _pack_level(bit, on_card)
        level_words.append(words)
        if l == nbits - 1:
            break
        if fused:
            g = segmented_partition_gather(
                words, _level_nid(node_starts, l, n),
                node_starts[l, :1 << l], n)
        else:
            nid = order >> (nbits - l) if l else torch.zeros_like(order)
            g = _invert_permutation(_segmented_partition_dest(nid, bit, l + 1))
        order = order[g.long()]
    if fused:
        return _finalize_fused(level_words, node_starts, n, nbits,
                               sample_rate, use_kernels=False)
    return _finalize(level_words, node_starts, n, nbits, sample_rate)


# --------------------------------------------------------------------------
# Domain decomposition (paper Theorem 4.2)
# --------------------------------------------------------------------------

def build_wavelet_tree_dd(seq, sigma: int, num_chunks: int,
                          sample_rate: int = 512, fused: bool = True,
                          device: str | torch.device = "cuda"
                          ) -> WaveletTree:
    """Domain-decomposition construction (Theorem 4.2): P = ``num_chunks``
    chunks of m = n / P symbols each build their levelwise tree, and every
    level's bits merge into the global bitmap, node v's run of chunk c
    landing at ``node_start[v] + Σ_{c' < c} len(c', v)``.

    The reference runs the P chunk builds under ``vmap``; here they run as
    one flat pass over all n symbols with node id ``c · 2^l + v`` (chunk c,
    node v), the same arithmetic: a chunk's elements stay in its m
    positions, and every per-node split is one per-(chunk, node) split.
    The flat layout keeps every tensor int32 (flat node ids stay below
    P · 2^l, 2^24 at 128 chunks of an 18-level tree) and lets the 1-D
    primitives serve unchanged. The chunks' levels are merged level by
    level as they are built, instead of all built first and then merged:
    the same outputs without holding (P, nbits, m) bits and node ids.

    ``fused=True`` splits by segmented select-gathers and merges by a
    gather (every (node, chunk) pair is one output run; a position's run
    comes from the sorted run starts); ``fused=False`` splits by the
    inverse of the scatter destinations and merges by an element scatter.
    The same tree either way.
    """
    obs.counter("core.build", builder="wt_dd",
                path="fused" if fused else "scatter").inc()
    dev, order = _input(seq, device)
    on_card = dev.type == "cuda"
    n = order.shape[0]
    if n % num_chunks:
        raise ValueError(f"n = {n} is not a multiple of num_chunks = "
                         f"{num_chunks}: pad the sequence")
    m = n // num_chunks
    nbits = num_levels(sigma)
    size = 1 << nbits
    node_starts = _node_starts_from_symbols(order, nbits)
    pos = torch.arange(n, device=dev)
    chunk = (pos // m).to(torch.int32)          # a position's chunk, fixed
    level_words: List[torch.Tensor] = []

    if fused:
        # every chunk's symbol histogram; its exclusive scan is the chunk's
        # leaf starts, and every level's node starts are a stride of it
        hist = torch.bincount(chunk.long() * size + order.long(),
                              minlength=num_chunks * size)
        csum = exclusive_sum(hist.reshape(num_chunks, size)).to(torch.int32)
        chunk_base = torch.arange(num_chunks, device=dev,
                                  dtype=torch.int32)[:, None] * m
        for l in range(nbits):
            bit = (order >> (nbits - 1 - l)) & 1
            sc = csum[:, ::1 << (nbits - l)]                 # (P, 2^l)
            cnt = torch.cat([sc[:, 1:], torch.full_like(sc[:, :1], m)],
                            1) - sc                          # per-chunk len
            across = exclusive_sum(cnt.T)                    # (2^l, P)
            # output runs in (node-major, chunk-minor) order; run (v, c)
            # starts at node_start[v] + across[v, c], non-decreasing
            run_start = (node_starts[l, :1 << l, None] + across).reshape(-1)
            rid = segment_ids_from_starts(run_start, n).long()
            src = (chunk_base.reshape(-1)[rid % num_chunks]
                   + sc.T.reshape(-1)[rid] + (pos - run_start[rid]))
            level_words.append(_pack_level(bit[src], on_card))
            if l < nbits - 1:
                # node (c, v) starts at c·m + sc[c, v]
                starts = (chunk_base + sc).reshape(-1)
                g = segmented_partition_gather(
                    _pack_level(bit, on_card),
                    segment_ids_from_starts(starts, n), starts, n)
                order = order[g.long()]
        return _finalize_fused(level_words, node_starts, n, nbits,
                               sample_rate, use_kernels=False)

    chunk_bits = (num_chunks - 1).bit_length()
    pos_in_chunk = pos - chunk.long() * m
    for l in range(nbits):
        bit = (order >> (nbits - 1 - l)) & 1
        nid = order >> (nbits - l) if l else torch.zeros_like(order)
        nodes_l = 1 << l
        flat = chunk * nodes_l + nid                         # (chunk, node)
        cnt = torch.bincount(flat, minlength=num_chunks * nodes_l).reshape(
            num_chunks, nodes_l)
        across = exclusive_sum(cnt.T).T.reshape(-1)          # earlier chunks
        chunk_node_start = exclusive_sum(cnt).reshape(-1)    # within chunk
        fl = flat.long()
        dest = (node_starts[l, nid.long()].long() + across[fl]
                + pos_in_chunk - chunk_node_start[fl])
        merged = torch.zeros_like(bit).scatter_(0, dest, bit)
        level_words.append(_pack_level(merged, on_card))
        if l < nbits - 1:
            g = _invert_permutation(_segmented_partition_dest(
                flat, bit, l + 1 + chunk_bits))
            order = order[g.long()]
    return _finalize(level_words, node_starts, n, nbits, sample_rate)


# --------------------------------------------------------------------------
# Queries (levelwise layout; int32 results, like the reference)
# --------------------------------------------------------------------------

def _arg(x, wt: WaveletTree) -> torch.Tensor:
    return torch.as_tensor(x, device=wt.node_starts.device).long()


def _starts(wt: WaveletTree, l: int, v: torch.Tensor) -> torch.Tensor:
    return take(wt.node_starts[l], v).long()


def _rank_in_node(rs, bit: torch.Tensor, p: torch.Tensor,
                  s: torch.Tensor) -> torch.Tensor:
    """Occurrences of ``bit`` in [s, p) of a level."""
    return torch.where(bit == 0, rank0(rs, p) - rank0(rs, s),
                       rank1(rs, p) - rank1(rs, s))


def wt_access(wt: WaveletTree, i) -> torch.Tensor:
    """Symbol at position i."""
    p = _arg(i, wt)
    c = torch.zeros_like(p)
    v = torch.zeros_like(p)
    for l in range(wt.nbits):
        rs = wt.level(l).rank
        s = _starts(wt, l, v)
        bit = access_bit(rs, p)
        rb = _rank_in_node(rs, bit, p, s)
        v = (v << 1) | bit
        c = (c << 1) | bit
        p = _starts(wt, l + 1, v) + rb
    return c.to(torch.int32)


def _next_start(wt: WaveletTree, l: int, v: torch.Tensor) -> torch.Tensor:
    """End offset of node v at level l (the next node's start, or n)."""
    nodes_l = 1 << l
    nxt = v + 1
    return torch.where(nxt >= nodes_l, wt.n,
                       _starts(wt, l, nxt.clamp(max=nodes_l - 1)))


def wt_rank(wt: WaveletTree, c, i) -> torch.Tensor:
    """# of occurrences of c in [0, i)."""
    c, p = torch.broadcast_tensors(_arg(c, wt), _arg(i, wt))
    v = torch.zeros_like(p)
    for l in range(wt.nbits):
        rs = wt.level(l).rank
        s = _starts(wt, l, v)
        p = torch.minimum(p, _next_start(wt, l, v))
        bit = (c >> (wt.nbits - 1 - l)) & 1
        rb = _rank_in_node(rs, bit, p, s)
        v = (v << 1) | bit
        p = _starts(wt, l + 1, v) + rb
    return (p - _starts(wt, wt.nbits, c)).to(torch.int32)


def wt_select(wt: WaveletTree, c, k) -> torch.Tensor:
    """Position of the k-th (0-based) occurrence of c."""
    c, pos = torch.broadcast_tensors(_arg(c, wt), _arg(k, wt))
    for l in range(wt.nbits - 1, -1, -1):
        bv = wt.level(l)
        s = _starts(wt, l, c >> (wt.nbits - l))
        bit = (c >> (wt.nbits - 1 - l)) & 1
        p_abs = torch.where(bit == 0,
                            select0(bv.rank, bv.sel0, rank0(bv.rank, s) + pos),
                            select1(bv.rank, bv.sel1, rank1(bv.rank, s) + pos))
        pos = p_abs - s
    return pos.to(torch.int32)
