"""Range queries over a wavelet matrix (port of
``repro.analytics.range_ops``).

``range_quantile`` and ``range_count`` descend the ``nbits`` levels with
two rank0 probes per level, so a query costs O(logσ) directory lookups
whatever the range width; a matrix with leading batch axes (stacked
shards) takes per-row query arrays of shape (*B, *Q).

``range_histogram`` (and ``range_distinct`` and the exact ``range_topk``
on it) is the reference's breadth-first descent, kept sparse: every
(shard, query) pair with a non-empty range is one lane, a lane splits in
two at each level and empty intervals are dropped, so the work is the
non-empty intervals, at most min(2^l, width) at level l, rather than 2^l.
Lanes name their own shard and level (``rank1_rows``), so all of them are
one batch a level. ``range_topk_greedy`` is the reference's greedy frontier
with a pop budget, one frontier a query and all queries popped at once,
each pop at its own node's level.

Position ranges ``[lo, hi)`` and symbol ranges ``[sym_lo, sym_hi)`` are
half-open. Ties in the top-k break toward the smaller symbol, as
``jax.lax.top_k`` breaks them.
"""
from __future__ import annotations

import torch

from repro_torch.core.rank_select import BinaryRank, rank1_rows
from repro_torch.core.wavelet_matrix import (WaveletMatrix, wm_child_interval,
                                             wm_interval_zeros)

#: intervals of one histogram chunk: the pairs of a chunk are chosen so
#: that their intervals at every level, at most min(width, 2^nbits) a
#: pair, stay within it
HISTOGRAM_CHUNK = 1 << 25

#: greedy top-k rounds between two looks for every query having stopped
_STOP_EVERY = 8


def _arg(x, wm: WaveletMatrix) -> torch.Tensor:
    return torch.as_tensor(x, device=wm.zeros.device).long()


def _clip_range(wm: WaveletMatrix, lo, hi):
    lo = _arg(lo, wm).clamp(0, wm.n)
    hi = torch.maximum(_arg(hi, wm).clamp(0, wm.n), lo)
    return lo, hi


def range_quantile(wm: WaveletMatrix, lo, hi, k) -> torch.Tensor:
    """k-th smallest symbol (0-based) among positions [lo, hi); k clamps
    into [0, hi-lo), an empty range gives -1. int32."""
    lo, hi = _clip_range(wm, lo, hi)
    lo, hi, k = torch.broadcast_tensors(lo, hi, _arg(k, wm))
    k = torch.minimum(k.clamp(min=0), (hi - lo - 1).clamp(min=0))
    empty = hi <= lo
    sym = torch.zeros_like(lo)
    for l in range(wm.nbits):
        lo0, hi0 = wm_interval_zeros(wm, l, lo, hi)
        z = hi0 - lo0
        bit = (k >= z).long()
        sym = (sym << 1) | bit
        k = torch.where(bit == 1, k - z, k)
        lo, hi = wm_child_interval(wm, l, lo, hi, bit, lo0, hi0)
    return torch.where(empty, -1, sym).to(torch.int32)


def _count_below(wm: WaveletMatrix, lo: torch.Tensor, hi: torch.Tensor,
                 sym) -> torch.Tensor:
    """# of positions in [lo, hi) whose symbol is < sym (sym clamped to
    [0, 2^nbits]): where sym's bit is 1, the zero branch is all smaller."""
    top = 1 << wm.nbits
    s = _arg(sym, wm).clamp(0, top)
    full = s >= top
    total = hi - lo
    acc = torch.zeros_like(lo)
    for l in range(wm.nbits):
        bit = (s >> (wm.nbits - 1 - l)) & 1
        lo0, hi0 = wm_interval_zeros(wm, l, lo, hi)
        acc = acc + torch.where(bit == 1, hi0 - lo0, 0)
        lo, hi = wm_child_interval(wm, l, lo, hi, bit, lo0, hi0)
    return torch.where(full, total, acc)


def range_count(wm: WaveletMatrix, lo, hi, sym_lo, sym_hi) -> torch.Tensor:
    """# of positions in [lo, hi) whose symbol lies in [sym_lo, sym_hi).
    int32."""
    lo, hi = _clip_range(wm, lo, hi)
    below_hi = _count_below(wm, lo, hi, sym_hi)
    below_lo = _count_below(wm, lo, hi, sym_lo)
    return (below_hi - below_lo).clamp(min=0).to(torch.int32)


# --------------------------------------------------------------------------
# lanes over (shard, level) rows
# --------------------------------------------------------------------------

def level_rows(wm: WaveletMatrix):
    """(rank directory with (S·nbits, X) leaves, zeros (S·nbits,) int64) of
    a matrix with leaves (nbits, X) or stacked (S, nbits, X): row
    ``s·nbits + l`` is level l of shard s (views, no copy)."""
    rs = wm.bitvectors.rank
    rows = BinaryRank(words=rs.words.reshape(-1, rs.words.shape[-1]),
                      superblock=rs.superblock.reshape(
                          -1, rs.superblock.shape[-1]),
                      block=rs.block.reshape(-1, rs.block.shape[-1]),
                      n=rs.n)
    return rows, wm.zeros.reshape(-1).long()


def split_rows(rows, row: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """The two children of intervals [lo, hi) on their rows: (lo0, hi0)
    under bit 0 and (lo1, hi1) under bit 1."""
    rank, zeros = rows
    lo0 = lo - rank1_rows(rank, row, lo)
    hi0 = hi - rank1_rows(rank, row, hi)
    z = zeros[row]
    return lo0, hi0, z + (lo - lo0), z + (hi - hi0)


# --------------------------------------------------------------------------
# range top-k (greedy frontier expansion)
# --------------------------------------------------------------------------

def topk_slot_budget(nbits: int, k: int) -> tuple[int, int]:
    """Default (pop budget, slot capacity) of the greedy expansion: about
    k·logσ pops surface the k answers on skewed distributions; each
    internal pop appends two children, so capacity is 1 + 2·pops."""
    iters = k * (nbits + 1)
    return iters, 2 * iters + 1


def topk_from_histogram(hist: torch.Tensor, k: int):
    """(syms, counts) of the k largest entries of ``hist`` (…, σ) along the
    last axis, descending, (-1, 0)-padded past the non-zero entries. A
    stable descending sort breaks ties toward the smaller symbol, as the
    reference's ``lax.top_k``. int32."""
    kk = min(k, hist.shape[-1])
    cnts, syms = torch.sort(hist, dim=-1, descending=True, stable=True)
    cnts, syms = cnts[..., :kk], syms[..., :kk]
    syms = torch.where(cnts > 0, syms, -1).to(torch.int32)
    cnts = cnts.to(torch.int32)
    if kk < k:
        pad = hist.shape[:-1] + (k - kk,)
        syms = torch.cat([syms, syms.new_full(pad, -1)], -1)
        cnts = torch.cat([cnts, cnts.new_zeros(pad)], -1)
    return syms, cnts


def range_topk(wm: WaveletMatrix, lo, hi, k: int):
    """The k most frequent symbols in [lo, hi) with their counts, exact:
    ``(syms, counts)`` (*Q, k) int32 by descending count, (-1, 0) past the
    distinct symbols of the range."""
    return topk_from_histogram(range_histogram(wm, lo, hi), k)


def range_topk_greedy(wm: WaveletMatrix, lo, hi, k: int,
                      budget: int | None = None, prune: bool = True):
    """Greedy best-first top-k with a fixed pop budget; the contract of
    :func:`range_topk`, exact when the budget covers every node heavier
    than the k-th answer (always at ``budget ≥ 2^(nbits+1)``).
    ``prune`` retires nodes whose weight is beaten by the lower bounds of
    others; it never changes an exact result."""
    lo, hi = _clip_range(wm, lo, hi)
    lo, hi = torch.broadcast_tensors(lo, hi)
    syms, counts, _ = topk_frontier(
        level_rows(wm), wm.nbits, lo.reshape(-1, 1), hi.reshape(-1, 1), k,
        budget, prune)
    return (syms.reshape(lo.shape + (k,)), counts.reshape(lo.shape + (k,)))


def _put(arr: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
         on: torch.Tensor) -> None:
    """arr[q, idx[q]] = val[q] where on[q], per query row q, in place
    (the reference's ``arr.at[idx].set(where(on, val, arr[idx]))``)."""
    q = torch.arange(arr.shape[0], device=arr.device)
    old = arr[q, idx]
    on = on.reshape(on.shape + (1,) * (old.dim() - 1))
    arr[q, idx] = torch.where(on, val.to(arr.dtype), old)


def topk_frontier(rows, nbits: int, los: torch.Tensor, his: torch.Tensor,
                  k: int, budget: int | None = None, prune: bool = True,
                  pops: torch.Tensor | None = None):
    """The greedy top-k engine over per-shard intervals: ``los``/``his``
    (Q, S) local ranges of Q queries on the S shards of ``rows``
    (:func:`level_rows`); a node's weight is its summed width over the
    shards, so the frontier is global, not a merge. Every query pops its
    heaviest node (the first, by slot, among equals) in each of ``budget``
    rounds: a leaf is the next answer, an internal node's shard intervals
    split on its level's rows into two children. Returns (syms (Q, k),
    counts (Q, k), found (Q,)) int32.

    ``pops``, a (Q,) int64 tensor if given, gains each query's pops (the
    rounds before it stopped): the measure of a kernel's chain of
    dependent loads.

    The reference's clamped slot and output indices (``min(nslots,
    cap - 2)``, ``min(found, k - 1)``) are explicit clamps here. A round in
    which every query has stopped changes nothing, so the rounds end at the
    first such round seen (looked for every ``_STOP_EVERY`` rounds, each
    look a host sync).
    """
    Q, S = los.shape
    dev = los.device
    iters, cap = topk_slot_budget(nbits, k)
    if budget is not None:
        iters, cap = budget, 2 * budget + 1
    slot_lo = torch.zeros((Q, cap, S), dtype=torch.int32, device=dev)
    slot_hi = torch.zeros((Q, cap, S), dtype=torch.int32, device=dev)
    slot_lo[:, 0], slot_hi[:, 0] = los, his
    slot_w = torch.zeros((Q, cap), dtype=torch.long, device=dev)
    slot_w[:, 0] = (his - los).sum(1)
    slot_sym = torch.zeros((Q, cap), dtype=torch.long, device=dev)
    slot_level = torch.zeros((Q, cap), dtype=torch.long, device=dev)
    alive = torch.zeros((Q, cap), dtype=torch.bool, device=dev)
    alive[:, 0] = True
    nslots = torch.ones(Q, dtype=torch.long, device=dev)
    out_syms = torch.full((Q, k), -1, dtype=torch.long, device=dev)
    out_cnts = torch.zeros((Q, k), dtype=torch.long, device=dev)
    nout = torch.zeros(Q, dtype=torch.long, device=dev)
    q = torch.arange(Q, device=dev)
    shard_row = torch.arange(S, device=dev) * nbits
    kk = min(k, cap)

    for it in range(iters):
        weight = torch.where(alive, slot_w, -1)
        best = torch.argmax(weight, 1)                  # first maximum
        w = weight[q, best]
        stop = (w <= 0) | (nout >= k)
        if it % _STOP_EVERY == 0 and bool(stop.all()):
            break
        if pops is not None:
            pops += (~stop).long()
        level = slot_level[q, best]
        sym = slot_sym[q, best]
        is_leaf = level == nbits

        # leaf: emit the symbol
        emit = ~stop & is_leaf
        oidx = nout.clamp(max=k - 1)
        _put(out_syms, oidx, sym, emit)
        _put(out_cnts, oidx, w, emit)
        nout = nout + emit.long()

        # internal: two children on the popped node's level
        expand = ~stop & ~is_leaf
        row = shard_row[None, :] + level.clamp(0, nbits - 1)[:, None]
        lo0, hi0, lo1, hi1 = split_rows(rows, row, slot_lo[q, best].long(),
                                        slot_hi[q, best].long())
        a = nslots.clamp(max=cap - 2)
        b = a + 1
        for idx, clo, chi, bit in ((a, lo0, hi0, 0), (b, lo1, hi1, 1)):
            _put(slot_lo, idx, clo, expand)
            _put(slot_hi, idx, chi, expand)
            _put(slot_w, idx, (chi - clo).sum(1), expand)
            _put(slot_sym, idx, (sym << 1) | bit, expand)
            _put(slot_level, idx, level + 1, expand)
            _put(alive, idx, torch.ones_like(expand), expand)
        nslots = nslots + 2 * expand.long()

        # the popped slot retires (unless the query has stopped)
        _put(alive, best, torch.zeros_like(stop), ~stop)

        if prune:
            # a node whose weight is beaten by the (k - found) largest
            # lower bounds ceil(weight / leaves below) of the frontier holds
            # no answer: retire it
            w_all = torch.where(alive, slot_w, 0)
            leaves = 1 << (nbits - slot_level).clamp(min=0)
            lb = torch.where(alive, (w_all + leaves - 1) // leaves, -1)
            need = k - nout
            kth = torch.topk(lb, kk, dim=1).values          # descending
            thresh = kth[q, (need - 1).clamp(0, kk - 1)]
            kill = (alive & (w_all < thresh[:, None])
                    & ((need > 0) & (need <= kk) & ~stop)[:, None])
            alive = alive & ~kill

    return (out_syms.to(torch.int32), out_cnts.to(torch.int32),
            nout.to(torch.int32))


# --------------------------------------------------------------------------
# histogram / distinct (breadth-first descent over the non-empty intervals)
# --------------------------------------------------------------------------

def histogram_descent(rows, nbits: int, los: torch.Tensor,
                      his: torch.Tensor) -> torch.Tensor:
    """Per-symbol counts (Q, 2^nbits) int32 over the local ranges ``los``/
    ``his`` (S, Q) of the shards of ``rows`` (:func:`level_rows`), summed
    over the shards.

    Every (shard, query) pair with a non-empty range is a lane; at each
    level a lane's interval splits into its zero and one children (the
    symbol prefix gains the level's bit) and the empty ones are dropped, so
    after ``nbits`` levels each lane is one symbol of one pair, and its
    width is that symbol's count there. The widths scatter-add into the
    output. Pairs go in chunks of at most ``HISTOGRAM_CHUNK`` intervals."""
    S, Q = los.shape
    dev = los.device
    top = 1 << nbits
    out = torch.zeros(Q * top, dtype=torch.int32, device=dev)
    s, qi = torch.nonzero(his > los, as_tuple=True)
    if s.numel() == 0:
        return out.reshape(Q, top)
    lo_all, hi_all = los[s, qi].long(), his[s, qi].long()
    bound = torch.cumsum((hi_all - lo_all).clamp(max=top), 0)
    ends = torch.searchsorted(
        bound, torch.arange(1, int(bound[-1]) // HISTOGRAM_CHUNK + 2,
                            device=dev) * HISTOGRAM_CHUNK, right=True)
    starts = 0
    for end in sorted(set(ends.clamp(min=1).tolist())):
        if end <= starts:
            continue
        sl = slice(starts, end)
        starts = end
        ls, lq = s[sl], qi[sl]
        lo, hi = lo_all[sl], hi_all[sl]
        sym = torch.zeros_like(lo)
        for l in range(nbits):
            lo0, hi0, lo1, hi1 = split_rows(rows, ls * nbits + l, lo, hi)
            lo, hi = torch.cat([lo0, lo1]), torch.cat([hi0, hi1])
            keep = hi > lo
            ls, lq = torch.cat([ls, ls])[keep], torch.cat([lq, lq])[keep]
            sym = torch.cat([sym << 1, (sym << 1) | 1])[keep]
            lo, hi = lo[keep], hi[keep]
        out.index_add_(0, lq * top + sym, (hi - lo).to(torch.int32))
    return out.reshape(Q, top)


def range_histogram(wm: WaveletMatrix, lo, hi) -> torch.Tensor:
    """Occurrence count of every symbol in [lo, hi): (*Q, 2^nbits) int32
    (the reference's breadth-first descent, over the non-empty intervals
    only)."""
    lo, hi = _clip_range(wm, lo, hi)
    lo, hi = torch.broadcast_tensors(lo, hi)
    hist = histogram_descent(level_rows(wm), wm.nbits, lo.reshape(1, -1),
                             hi.reshape(1, -1))
    return hist.reshape(lo.shape + (1 << wm.nbits,))


def range_distinct(wm: WaveletMatrix, lo, hi) -> torch.Tensor:
    """# of distinct symbols in [lo, hi). int32."""
    return (range_histogram(wm, lo, hi) > 0).sum(-1).to(torch.int32)
