"""Multiary (degree d = 2^b) wavelet trees (paper Theorem 4.4; port of
``repro.core.multiary``).

Each level stores a sequence of b-bit digits, the elements stably sorted by
their top l·b symbol bits, with a generalized rank/select structure
(Section 5.2) on it; b ∈ {1, 2, 4}. The construction is the binary
levelwise one with the 0/1 split generalized to a d-way node-segmented
stable split. No kernel: the reference sends none of it through Pallas.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import torch

from .. import obs
from .rank_select import (GeneralizedRankSelect, build_generalized,
                          build_generalized_from_counts, field_node_counts,
                          generalized_access, generalized_rank,
                          generalized_select, packed_field_counts,
                          segmented_partition_gather_fields)
from .scan import (exclusive_sum, segment_ids_from_starts,
                   segmented_exclusive_sum)
from .sort import _invert_permutation
from ..device import resolve_device
from ..tree import tree_map


@dataclass(frozen=True)
class MultiaryWaveletTree:
    """Levelwise multiary tree: per-level digit sequences with rank/select
    (every leaf of ``levels`` carries a leading (nlevels,) axis) and
    ``node_starts`` (nlevels+1, d^nlevels) int32, row l the start of every
    depth-l node (the first d^l entries mean something), the last row the
    symbol offset table."""
    levels: GeneralizedRankSelect
    node_starts: torch.Tensor
    n: int
    width: int                # b: bits a digit
    nlevels: int

    @property
    def degree(self) -> int:
        return 1 << self.width

    def level(self, l: int) -> GeneralizedRankSelect:
        return tree_map(lambda x: x[l], self.levels)


def _stack_levels(grs: List[GeneralizedRankSelect]) -> GeneralizedRankSelect:
    return tree_map(lambda *xs: torch.stack(xs), *grs)


def _node_starts_multiary(seq: torch.Tensor, width: int,
                          nlevels: int) -> torch.Tensor:
    """Every node's start at every level from one symbol histogram and one
    prefix sum."""
    total_bits = width * nlevels
    size = 1 << total_bits
    hist = torch.bincount(seq.long(), minlength=size)[:size]
    leaf_starts = exclusive_sum(hist).to(torch.int32)
    rows = torch.zeros((nlevels + 1, size), dtype=torch.int32,
                       device=seq.device)
    for l in range(nlevels + 1):
        starts = leaf_starts[::1 << (total_bits - l * width)]
        rows[l, :starts.shape[0]] = starts
    return rows


def build_multiary_wavelet_tree(seq, sigma: int, width: int = 2,
                                chunk_syms: int = 128, fused: bool = True,
                                device: str | torch.device = "cuda"
                                ) -> MultiaryWaveletTree:
    """Theorem 4.4 construction for degree d = 2^width.

    ``seq``: (n,) symbols in [0, sigma), moved to ``device``, read as
    (nlevels·width)-bit numbers (zero-extended at the top). ``fused=True``
    splits each level by one histogram-offset select-gather
    (``rank_select.segmented_partition_gather_fields``), builds the
    generalized directories from the gather's shared word counts and
    chains ``node_starts`` level to level through its per-node digit
    counts; ``fused=False`` is the scatter baseline (a (node, digit)
    histogram, d segmented prefix sums, an inverse-permutation scatter).
    The same tree either way.
    """
    dev = resolve_device(device)
    order = torch.as_tensor(seq, device=dev).to(torch.int32)
    n = order.shape[0]
    nbits = max(1, math.ceil(math.log2(max(2, sigma))))
    nlevels = (nbits + width - 1) // width
    obs.counter("core.build", builder="multiary",
                path="fused" if fused else "scatter").inc()
    if fused:
        return _build_multiary_fused(order, width, nlevels, n, chunk_syms)
    total_bits = width * nlevels
    d = 1 << width
    node_starts = _node_starts_multiary(order, width, nlevels)
    grs: List[GeneralizedRankSelect] = []
    for l in range(nlevels):
        digit = (order >> (total_bits - (l + 1) * width)) & (d - 1)
        grs.append(build_generalized(digit, width, n, chunk_syms))
        if l == nlevels - 1:
            break
        nid = (order >> (total_bits - l * width) if l
               else torch.zeros_like(order))
        key = nid.long() * d + digit
        hist = torch.bincount(key, minlength=1 << ((l + 1) * width))
        key_start = exclusive_sum(hist)
        seg_start = torch.ones(n, dtype=torch.bool, device=dev)
        seg_start[1:] = nid[1:] != nid[:-1]
        rank_within = torch.zeros_like(digit)
        for v in range(d):
            rv = segmented_exclusive_sum((digit == v).to(torch.int32),
                                         seg_start)
            rank_within = torch.where(digit == v, rv, rank_within)
        dest = key_start[key] + rank_within
        order = order[_invert_permutation(dest).long()]
    return MultiaryWaveletTree(levels=_stack_levels(grs),
                               node_starts=node_starts, n=n, width=width,
                               nlevels=nlevels)


def _build_multiary_fused(order: torch.Tensor, width: int, nlevels: int,
                          n: int, chunk_syms: int) -> MultiaryWaveletTree:
    """Scatter-free form of the Theorem 4.4 build (see
    :func:`build_multiary_wavelet_tree`)."""
    total_bits = width * nlevels
    size = 1 << total_bits
    starts = torch.zeros(1, dtype=torch.int32, device=order.device)
    start_rows: List[torch.Tensor] = []
    grs: List[GeneralizedRankSelect] = []
    for l in range(nlevels):
        digit = (order >> (total_bits - (l + 1) * width)) & ((1 << width) - 1)
        plan = packed_field_counts(digit, width, n)
        grs.append(build_generalized_from_counts(*plan, width=width, n=n,
                                                 chunk_syms=chunk_syms))
        _, cnt_node = field_node_counts(*plan, width=width,
                                        node_start=starts, n=n)
        start_rows.append(starts)
        if l < nlevels - 1:
            nid = (segment_ids_from_starts(starts, n) if l
                   else torch.zeros_like(order))
            g = segmented_partition_gather_fields(digit, width, nid, starts,
                                                  n, plan=plan)
            order = order[g.long()]
        # a (node, digit) pair of level l is a node of level l + 1
        starts = exclusive_sum(cnt_node.reshape(-1))
    start_rows.append(starts)                    # the symbol offsets
    node_starts = torch.zeros((nlevels + 1, size), dtype=torch.int32,
                              device=order.device)
    for l, row in enumerate(start_rows):
        node_starts[l, :row.shape[0]] = row
    return MultiaryWaveletTree(levels=_stack_levels(grs),
                               node_starts=node_starts, n=n, width=width,
                               nlevels=nlevels)


# --------------------------------------------------------------------------
# Queries (int32 results, like the reference)
# --------------------------------------------------------------------------

def _arg(x, mwt: MultiaryWaveletTree) -> torch.Tensor:
    return torch.as_tensor(x, device=mwt.node_starts.device).long()


def _starts(mwt: MultiaryWaveletTree, l: int, v: torch.Tensor):
    return mwt.node_starts[l][v].long()


def mwt_access(mwt: MultiaryWaveletTree, i) -> torch.Tensor:
    """Symbol at position i."""
    p = _arg(i, mwt)
    v = torch.zeros_like(p)
    c = torch.zeros_like(p)
    for l in range(mwt.nlevels):
        g = mwt.level(l)
        s = _starts(mwt, l, v)
        digit = generalized_access(g, p).long()
        rb = generalized_rank(g, digit, p) - generalized_rank(g, digit, s)
        v = v * mwt.degree + digit
        c = (c << mwt.width) | digit
        p = _starts(mwt, l + 1, v) + rb
    return c.to(torch.int32)


def _node_end(mwt: MultiaryWaveletTree, l: int, v: torch.Tensor):
    """End offset of node v at level l (the next node's start, or n)."""
    nodes_l = mwt.degree ** l
    nxt = v + 1
    return torch.where(nxt >= nodes_l, mwt.n,
                       _starts(mwt, l, nxt.clamp(max=nodes_l - 1)))


def mwt_rank(mwt: MultiaryWaveletTree, c, i) -> torch.Tensor:
    """# of occurrences of symbol c in [0, i)."""
    c, p = torch.broadcast_tensors(_arg(c, mwt), _arg(i, mwt))
    total_bits = mwt.width * mwt.nlevels
    v = torch.zeros_like(p)
    for l in range(mwt.nlevels):
        g = mwt.level(l)
        s = _starts(mwt, l, v)
        p = torch.minimum(p, _node_end(mwt, l, v))
        digit = (c >> (total_bits - (l + 1) * mwt.width)) & (mwt.degree - 1)
        rb = generalized_rank(g, digit, p) - generalized_rank(g, digit, s)
        v = v * mwt.degree + digit
        p = _starts(mwt, l + 1, v) + rb
    return (p - _starts(mwt, mwt.nlevels, c)).to(torch.int32)


def mwt_select(mwt: MultiaryWaveletTree, c, k) -> torch.Tensor:
    """Position of the k-th (0-based) occurrence of c."""
    c, pos = torch.broadcast_tensors(_arg(c, mwt), _arg(k, mwt))
    total_bits = mwt.width * mwt.nlevels
    for l in range(mwt.nlevels - 1, -1, -1):
        g = mwt.level(l)
        v = c >> (total_bits - l * mwt.width) if l else torch.zeros_like(c)
        s = _starts(mwt, l, v)
        digit = (c >> (total_bits - (l + 1) * mwt.width)) & (mwt.degree - 1)
        abs_rank = generalized_rank(g, digit, s) + pos
        pos = generalized_select(g, digit, abs_rank).long() - s
    return pos.to(torch.int32)
