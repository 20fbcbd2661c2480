"""Parallel wavelet tree construction (paper Section 4, Theorem 4.1) and
queries (port of ``repro.core.wavelet_tree``).

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
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch

from . import bitops
from .rank_select import (BitVector, access_bit, build_bitvector_levels,
                          rank0, rank1, segmented_partition_gather, select0,
                          select1)
from .scan import (apply_permutation_dest, exclusive_sum,
                   segment_ids_from_starts, take)
from .sort import sort_pass
from .wavelet_matrix import num_levels
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


def _pack_level(bit: torch.Tensor, use_kernels: bool) -> torch.Tensor:
    """LSB-first words of a level's bits: the ``bitpack`` kernel when
    ``use_kernels`` (its plain version for a CPU tensor), else
    ``bitops.pack_bits``. The same words either way."""
    if use_kernels:
        from repro_torch.kernels import ops
        return ops.bitpack(bit)
    return bitops.pack_bits(bitops.pad_bits(bit))


def _wt_kernel_fits(l: int) -> bool:
    from repro_torch.kernels.wt_level import MAX_KEYS
    return (1 << (l + 1)) <= MAX_KEYS


def _finalize_fused(level_words: List[torch.Tensor],
                    node_starts: torch.Tensor, n: int, nbits: int,
                    sample_rate: int, use_kernels: bool) -> WaveletTree:
    """All nbits rank/select directories at once."""
    bvs = build_bitvector_levels(torch.stack(level_words), n, sample_rate,
                                 use_kernels=use_kernels)
    return WaveletTree(bitvectors=bvs, node_starts=node_starts, n=n,
                       nbits=nbits)


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
    kernels. Only the fused build is ported.
    """
    if big_step not in ("compose", "radix", "xla"):
        raise ValueError(f"unknown big_step {big_step!r}")
    if not fused:
        raise NotImplementedError("the fused=False baseline is not ported")
    dev = resolve_device(device)
    seq = torch.as_tensor(seq, device=dev)
    if seq.dim() != 1:
        raise ValueError(f"seq must be 1-D, got shape {tuple(seq.shape)}")
    if use_kernels is None:
        use_kernels = dev.type == "cuda"
    n = seq.shape[0]
    nbits = num_levels(sigma)
    order = seq.to(torch.int32)
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
