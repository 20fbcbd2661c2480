"""Arbitrary-shaped (Huffman) binary wavelet trees (paper Theorem 4.3;
port of ``repro.core.huffman``).

Codewords are made on the host (numpy, as in the reference: the paper
takes them as given input). An element with a codeword of L bits gives one
bit at levels 0..L-1 and then leaves the sequence; the invariant is

    [ active elements, stably sorted by their top-l code bits | retired ]

Each level splits the active prefix stably per node; elements whose code
ends sink stably to the retired tail. No kernel: the reference sends none
of it through Pallas. On a CUDA device the level bitmaps pack through the
``bitpack`` kernel; the rank directories are plain torch, as the
reference builds them without kernels.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from .. import obs
from .rank_select import (BinaryRank, _rank1_at, build_binary_rank,
                          partition_select, partition_select_directory)
from .scan import (exclusive_sum, segment_ids_from_starts,
                   segmented_exclusive_sum)
from .sort import _invert_permutation
from .wavelet_matrix import _pack_level
from ..device import resolve_device
from ..tree import tree_map

# --------------------------------------------------------------------------
# Host-side codebook generation (numpy, the reference's own code)
# --------------------------------------------------------------------------


def huffman_code_lengths(freqs: np.ndarray) -> np.ndarray:
    """Classic heap Huffman over symbol frequencies (host-side)."""
    sigma = len(freqs)
    if sigma == 1:
        return np.ones(1, np.int32)
    heap = [(int(f), i) for i, f in enumerate(freqs)]
    heapq.heapify(heap)
    parent = {}
    next_id = sigma
    while len(heap) > 1:
        fa, ia = heapq.heappop(heap)
        fb, ib = heapq.heappop(heap)
        parent[ia] = next_id
        parent[ib] = next_id
        heapq.heappush(heap, (fa + fb, next_id))
        next_id += 1
    lengths = np.zeros(sigma, np.int32)
    for s in range(sigma):
        d, node = 0, s
        while node in parent:
            node = parent[node]
            d += 1
        lengths[s] = max(d, 1)
    return lengths


def canonical_codes(lengths: np.ndarray) -> Tuple[np.ndarray, int]:
    """Canonical (prefix-free, MSB-first) codes from code lengths."""
    sigma = len(lengths)
    max_len = int(lengths.max())
    order = np.lexsort((np.arange(sigma), lengths))
    codes = np.zeros(sigma, np.uint64)
    code = 0
    prev_len = int(lengths[order[0]])
    for s in order:
        L = int(lengths[s])
        code <<= (L - prev_len)
        codes[s] = code
        code += 1
        prev_len = L
    return codes.astype(np.uint32), max_len


def huffman_codebook(freqs: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
    """(codes, lengths, max_len) for a frequency table."""
    lengths = huffman_code_lengths(np.asarray(freqs))
    codes, max_len = canonical_codes(lengths)
    return codes, lengths, max_len


# --------------------------------------------------------------------------
# Construction
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class HuffmanWaveletTree:
    """Levelwise arbitrary-shape wavelet tree: ``ranks`` stacks per-level
    rank directories (leaves with a leading (max_len,) axis); the level-l
    bitmap means ``active[l]`` bits (``int32``), the rest is padding."""
    ranks: BinaryRank
    active: torch.Tensor
    n: int
    max_len: int

    def level(self, l: int) -> BinaryRank:
        return tree_map(lambda x: x[l], self.ranks)

    @property
    def total_bits(self) -> torch.Tensor:
        """Compressed size in bits = Σ code lengths."""
        return self.active.sum()


def _huffman_level_plans(codes: np.ndarray, lengths: np.ndarray,
                         max_len: int):
    """Static per-level run tables for the fused (select-gather) build.

    A level-l reorder moves each (l+1)-bit code prefix as one *run*:
    prefix-freedom means a child prefix is either a complete codeword
    (every element retires) or a proper prefix (every element survives),
    so survivorship is a static property of the run. Runs are contiguous
    symbol ranges in code order; their element counts come from the symbol
    histogram at build time. Returns ``(sym_order, plans)`` with one dict
    per level: symbol-range bounds ``a``/``b`` per run (dst order:
    survivors ascending, then retirees ascending), the run's partition
    ``bit``, the first symbol index ``pa`` of its parent's level-l
    segment, and the survivor run count ``n_internal``.
    """
    codes = np.asarray(codes, np.uint64)
    lengths = np.asarray(lengths, np.int64)
    sigma = len(codes)
    code_lj = codes << (np.uint64(max_len) - lengths.astype(np.uint64))
    sym_order = np.argsort(code_lj, kind="stable")
    lj_s = code_lj[sym_order]
    len_s = lengths[sym_order]
    plans = []
    for l in range(max_len - 1):
        act = len_s > l
        pfx = lj_s >> np.uint64(max_len - l - 1)
        runs = []                                   # (a, b, pfx, is_leaf)
        i = 0
        while i < sigma:
            if not act[i]:
                i += 1
                continue
            j = i
            while j < sigma and act[j] and pfx[j] == pfx[i]:
                j += 1
            runs.append((i, j, int(pfx[i]), bool(len_s[i] == l + 1)))
            i = j
        first_of_parent = {}
        for a, _, q, _ in runs:
            first_of_parent.setdefault(q >> 1, a)   # runs are ascending
        dst = [r for r in runs if not r[3]] + [r for r in runs if r[3]]
        plans.append(dict(
            a=np.array([r[0] for r in dst], np.int32),
            b=np.array([r[1] for r in dst], np.int32),
            bit=np.array([r[2] & 1 for r in dst], np.int32),
            pa=np.array([first_of_parent[r[2] >> 1] for r in dst],
                        np.int32),
            n_internal=sum(1 for r in runs if not r[3]),
            retired=(len_s <= l).astype(np.int32),
        ))
    return sym_order, plans


def build_huffman_wavelet_tree(seq, codes, lengths, max_len: int,
                               fused: bool = True,
                               device: str | torch.device = "cuda"
                               ) -> HuffmanWaveletTree:
    """Theorem 4.3 construction, codewords given.

    ``seq``: (n,) symbols, moved to ``device``; ``codes``/``lengths``: the
    codebook (numpy or tensors, read on the host). Per level, survivors
    (code longer than l+1 bits) are stably reordered by (segment, bit);
    everyone else retires to the tail. ``fused=True`` applies each reorder
    as a select-gather whose runs and survivorship come from the codebook
    (:func:`_huffman_level_plans`); ``fused=False`` is the scatter baseline
    (a (segment, bit) histogram over 2n+1 keys, segmented prefix sums, an
    inverse-permutation scatter). Level bitmaps, rank directories and
    ``active`` are the same either way; only the order inside the retired
    tail differs, which gives no further bit.

    The reference takes the scatter path for a traced codebook; a torch
    codebook is always concrete, so here ``fused=True`` with ``max_len >
    1`` always takes the fused path, and the reference's
    ``core.huffman_traced_codebook_fallback`` counter has no counterpart.
    Codewords are left-justified in 32 bits, as the reference's uint32
    does: ``max_len`` above 32 raises. Counts ``core.build{builder=huffman,
    path}``.
    """
    if max_len > 32:
        raise ValueError(f"max_len {max_len} > 32: codewords are "
                         f"left-justified in 32 bits")
    dev = resolve_device(device)
    sidx = torch.as_tensor(seq, device=dev).long()
    codes_np, lengths_np = (np.asarray(
        x.cpu() if isinstance(x, torch.Tensor) else x).astype(np.int64)
        for x in (codes, lengths))
    take_fused = fused and max_len > 1
    obs.counter("core.build", builder="huffman",
                path="fused" if take_fused else "scatter").inc()
    if take_fused:
        return _build_huffman_fused(sidx, codes_np, lengths_np, max_len)
    n = sidx.shape[0]
    on_card = dev.type == "cuda"
    elen = torch.from_numpy(lengths_np).to(dev)[sidx]
    cw = torch.from_numpy(codes_np).to(dev)[sidx] << (max_len - elen)
    level_words: List[torch.Tensor] = []
    active: List[torch.Tensor] = []
    for l in range(max_len):
        act = elen > l
        bit = torch.where(act, (cw >> (max_len - 1 - l)) & 1, 0)
        level_words.append(_pack_level(bit, on_card))
        active.append(act.sum().to(torch.int32))
        if l == max_len - 1:
            break
        # ---- reorder for level l+1 -----------------------------------
        surv = elen > l + 1
        # positional segments over the active prefix (node = top-l bits)
        nid = cw >> (max_len - l) if l else torch.zeros_like(cw)
        seg_start = torch.ones(n, dtype=torch.bool, device=dev)
        seg_start[1:] = (nid[1:] != nid[:-1]) | (act[1:] != act[:-1])
        seg_idx = torch.cumsum(seg_start, 0) - 1             # compact ids
        # survivors: stable order by (segment, bit), sentinel last
        key = torch.where(surv, seg_idx * 2 + bit, 2 * n)
        key_start = exclusive_sum(torch.bincount(key, minlength=2 * n + 1))
        s0 = segmented_exclusive_sum(surv & (bit == 0), seg_start)
        s1 = segmented_exclusive_sum(surv & (bit == 1), seg_start)
        dest = key_start[key] + torch.where(bit == 0, s0, s1)
        # non-survivors: stable tail
        tail_rank = exclusive_sum((~surv).long())
        dest = torch.where(surv, dest, surv.sum() + tail_rank)
        g = _invert_permutation(dest).long()
        cw, elen = cw[g], elen[g]
    return HuffmanWaveletTree(ranks=build_binary_rank(
        torch.stack(level_words), n), active=torch.stack(active), n=n,
        max_len=max_len)


def _build_huffman_fused(sidx: torch.Tensor, codes: np.ndarray,
                         lengths: np.ndarray,
                         max_len: int) -> HuffmanWaveletTree:
    """Select-gather form of the Theorem 4.3 build (see
    :func:`build_huffman_wavelet_tree`). The element landing at offset q of
    a run is ``select_bit(rank_bit(parent segment start) + q)`` on the
    level bitmap. Each level's active count is read on the host from the
    symbol histogram (one copy of σ counts a build), so only the active
    prefix is gathered: the reference computes the tail's sources too and
    then keeps the tail in place."""
    dev = sidx.device
    n = sidx.shape[0]
    sigma = lengths.shape[0]
    on_card = dev.type == "cuda"
    sym_order, plans = _huffman_level_plans(codes, lengths, max_len)
    elen = torch.from_numpy(lengths).to(dev)[sidx]
    cw = torch.from_numpy(codes).to(dev)[sidx] << (max_len - elen)
    # one symbol histogram (code order) feeds every level's run offsets
    hist = torch.bincount(sidx, minlength=sigma)[:sigma]
    hist_s = hist[torch.from_numpy(sym_order).to(dev)]
    H = torch.cat([hist_s.new_zeros(1), torch.cumsum(hist_s, 0)])
    hist_np = hist.cpu().numpy()
    pos = torch.arange(n, device=dev)
    level_words: List[torch.Tensor] = []
    active: List[torch.Tensor] = []
    for l in range(max_len):
        act = elen > l
        bit = torch.where(act, (cw >> (max_len - 1 - l)) & 1, 0)
        words = _pack_level(bit, on_card)
        level_words.append(words)
        active.append(act.sum().to(torch.int32))
        if l == max_len - 1:
            break
        # ---- reorder for level l+1 (all gathers) ---------------------
        pl = plans[l]
        a_l = int(hist_np[lengths > l].sum())        # active elements
        retired = torch.from_numpy(pl["retired"]).to(dev)
        ret = torch.cat([H.new_zeros(1), torch.cumsum(hist_s * retired, 0)])
        cnt = (H[torch.from_numpy(pl["b"]).to(dev).long()]
               - H[torch.from_numpy(pl["a"]).to(dev).long()])
        dst_start = torch.cumsum(cnt, 0) - cnt
        pa = torch.from_numpy(pl["pa"]).to(dev).long()
        ps = H[pa] - ret[pa]                         # parent segment start
        directory = partition_select_directory(words, n)
        _, ocum, Z, _ = directory
        ones_at = _rank1_at(words, ocum, n - Z, ps, n)
        run_bit = torch.from_numpy(pl["bit"]).to(dev).long()
        base = torch.where(run_bit == 1, ones_at, ps - ones_at)
        # the run of every active output position (run starts ascending)
        r = segment_ids_from_starts(dst_start, a_l).long()
        p = pos[:a_l]
        t = base[r] + (p - dst_start[r])
        src = partition_select(words, directory, run_bit[r], t)
        g = torch.cat([src, pos[a_l:]])              # the tail stays put
        cw, elen = cw[g], elen[g]
    return HuffmanWaveletTree(ranks=build_binary_rank(
        torch.stack(level_words), n), active=torch.stack(active), n=n,
        max_len=max_len)


# --------------------------------------------------------------------------
# Oracle (numpy) for tests and checks
# --------------------------------------------------------------------------

def reference_huffman_levels(seq: np.ndarray, codes: np.ndarray,
                             lengths: np.ndarray,
                             max_len: int) -> List[np.ndarray]:
    """Pure-numpy oracle: the level bitmaps of the arbitrary-shape tree."""
    n = len(seq)
    elen = lengths[seq]
    cw_lj = codes[seq].astype(np.uint64) << (max_len - elen).astype(np.uint64)
    cur = np.arange(n)                       # active elements, level order
    out = []
    for l in range(max_len):
        bits = ((cw_lj[cur] >> np.uint64(max_len - 1 - l))
                & 1).astype(np.int32)
        out.append(bits)
        if l == max_len - 1:
            break
        key = cw_lj[cur] >> np.uint64(max_len - 1 - l)   # top l+1 bits
        cur = cur[np.argsort(key, kind="stable")]
        cur = cur[elen[cur] > l + 1]
    return out
