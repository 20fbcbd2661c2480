"""Repair of corrupted *derived* structures by recomputation (port of
``repro.robust.repair``).

Every rank/select directory, zero count, C table and SA-sample directory is
a function of the level bitmaps (paper Theorems 5.1/5.2), so a corrupted
derived leaf is repaired by recomputing it through the builders the
construction uses: a successful repair is bit-identical to the structure
before the fault. On a CUDA structure the rank tables go through
``rank_build_levels`` (one launch for every level of every shard) and the
deep FM repair's mark directory through ``bitpack``. Only corruption of the
primary bitmaps (a matrix level's ``rank.words``, seam windows) needs a
rebuild from the source tokens.

The deep FM repair recovers the suffix array from the BWT alone. The
reference walks LF from row 0, one dependent step a row; here the same
output comes in parallel: the BWT of every shard is decoded level by level
(one scan of the level's bits), LF is the inverse of the BWT's stable
argsort, and pointer jumping over LF (⌈log2 m⌉ rounds of gathers) gives
every row's distance to the row of text position 0, which is its suffix
array entry.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Tuple

import numpy as np
import torch

from repro_torch.core import bitops
from repro_torch.core.rank_select import build_bitvector_levels
from repro_torch.core.scan import flat_inclusive_sum, lift
from repro_torch.core.wavelet_matrix import WaveletMatrix, wm_rank
from repro_torch.tree import tree_map

#: path fragments of primary leaves; everything else is derivable. The
#: mark directory's ``mark/words`` is derived, so the matrix bitmap rule
#: matches on the bitvectors prefix, not bare "words".
_PRIMARY_FRAGMENTS = ("bitvectors/rank/words", "seam_windows")

#: (shard, symbol) lanes of one C-table batch
_C_LANES = 1 << 22


# --------------------------------------------------------------------------
# checksum-failure triage
# --------------------------------------------------------------------------

def is_primary_key(key: str) -> bool:
    """Does this flattened path name primary (non-derivable) data? Keys
    match dot-stripped: a field token is ``.name``, so the stored form of
    the matrix bitmap leaf is ``".bitvectors/.rank/.words"``."""
    key = key.replace(".", "")
    return any(frag in key for frag in _PRIMARY_FRAGMENTS)


def classify_bad_keys(bad_keys: Iterable[str]) -> Tuple[list, list]:
    """Split checksum-failed leaf paths into (derived, primary)."""
    derived, primary = [], []
    for k in bad_keys:
        (primary if is_primary_key(k) else derived).append(k)
    return derived, primary


# --------------------------------------------------------------------------
# wavelet matrix / analytics engine
# --------------------------------------------------------------------------

def _uses_kernels(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


def repair_wavelet_matrix(wm: WaveletMatrix) -> WaveletMatrix:
    """Recompute every derived leaf of a matrix (or a stack of them) from
    its level bitmaps: the rank tables (``rank_build_levels`` on the card,
    one launch for all rows), both select sample directories and the
    per-level ``zeros``."""
    words = wm.bitvectors.rank.words                  # (*B, nbits, W)
    bv = build_bitvector_levels(words, wm.n, wm.bitvectors.sel1.sample_rate,
                                use_kernels=_uses_kernels(words))
    zeros = (wm.n - bitops.popcount(words).sum(-1)).to(torch.int32)
    return WaveletMatrix(bitvectors=bv, zeros=zeros, n=wm.n, nbits=wm.nbits)


def repair_analytics(engine):
    """Repair every shard of a ``ShardedAnalytics``; geometry and the
    availability mask pass through. The result takes the quantile kernel's
    operands from the repaired directories (``quantile=None``): operands of
    the old engine would read its corrupt ones."""
    return dataclasses.replace(engine,
                               shards=repair_wavelet_matrix(engine.shards),
                               quantile=None)


# --------------------------------------------------------------------------
# FM-index (full-text shards)
# --------------------------------------------------------------------------

def wm_decode(wm: WaveletMatrix) -> torch.Tensor:
    """The symbol at every position of a matrix (or of each of a stack):
    (*B, n) int64. Each level is one scan of its bits; a position follows
    its bit into the zero block (its zeros before) or the one block (the
    level's zeros plus its ones before). Equal to ``wm_access`` of every
    position when the rank directories agree with the bitmaps."""
    n = wm.n
    words = wm.bitvectors.rank.words
    lead = words.shape[:-2]
    cur = torch.arange(n, device=words.device).expand(lead + (n,))
    sym = torch.zeros(lead + (n,), dtype=torch.long, device=words.device)
    for l in range(wm.nbits):
        bits = bitops.unpack_bits(words[..., l, :], n)
        ones = (flat_inclusive_sum(bits) - bits).long()      # exclusive
        bit = torch.gather(bits, -1, cur).long()
        before = torch.gather(ones, -1, cur)
        z = lift(wm.zeros[..., l].long(), cur)
        cur = torch.where(bit == 0, cur - before, z + before)
        sym = (sym << 1) | bit
    return sym


def _c_table(wm: WaveletMatrix, sigma_work: int, m: int) -> torch.Tensor:
    """C of the reference's repair: each symbol's count as ``wm_rank(c,
    m)``, then the exclusive (σ+2,) boundary table; a stack of matrices in
    groups of shards of at most ``_C_LANES`` (shard, symbol) lanes."""
    batched = wm.zeros.dim() == 2
    stack = wm if batched else tree_map(lambda x: x[None], wm)
    per = max(1, _C_LANES // sigma_work)
    parts = []
    for s0 in range(0, stack.zeros.shape[0], per):
        part = tree_map(lambda x: x[s0:s0 + per], stack)
        c = torch.arange(sigma_work, device=wm.zeros.device).expand(
            part.zeros.shape[0], sigma_work)
        parts.append(wm_rank(part, c, torch.full_like(c, m)))
    cum = torch.cumsum(torch.cat(parts, 0).long(), -1).to(torch.int32)
    C = torch.nn.functional.pad(cum, (1, 0))
    return C if batched else C[0]


def suffix_array_from_bwt(bwt: torch.Tensor) -> torch.Tensor:
    """The suffix array of each row of a BWT (*B, m) whose terminator is
    the row's one smallest symbol: LF is the inverse of the BWT's stable
    argsort (C[c] + rank_c(j) is j's place in that sort), LF walks the text
    backwards, and pointer jumping gives each row's number of LF steps to
    the row of text position 0, which is its suffix array entry. int32."""
    m = bwt.shape[-1]
    order = torch.sort(bwt, dim=-1, stable=True).indices
    steps = torch.arange(m, device=bwt.device).expand(bwt.shape).contiguous()
    lf = torch.empty_like(order).scatter_(-1, order, steps)
    # the terminator sorts first: its row, order[0], is the row of text
    # position 0 (LF sends it to row 0), where every walk ends
    tail = order[..., :1]
    nxt = lf.scatter(-1, tail, tail)
    dist = torch.ones_like(lf).scatter_(-1, tail, 0)
    for _ in range(max(1, math.ceil(math.log2(max(2, m))))):
        dist = dist + torch.gather(dist, -1, nxt)
        nxt = torch.gather(nxt, -1, nxt)
    return dist.to(torch.int32)


def repair_fm_index(fm, deep: bool = True):
    """Recompute every derived leaf of an ``FMIndex`` (one shard, or a stack
    with a leading (S,) axis) from its bitmaps: the matrix directories and
    the C table always; with ``deep`` also the sampled-SA directories
    (``mark``, ``sa_sample``), from the suffix array the BWT gives back."""
    from repro_torch.index.fm_index import FMIndex, sample_directories
    wm = repair_wavelet_matrix(fm.wm)
    m = fm.m
    C = _c_table(wm, fm.sigma + 1, m)
    if deep:
        sa = suffix_array_from_bwt(wm_decode(wm))
        mark, sa_sample = sample_directories(sa, fm.sample_rate,
                                             _uses_kernels(sa))
    else:
        mark, sa_sample = fm.mark, fm.sa_sample
    return FMIndex(wm=wm, C=C, mark=mark, sa_sample=sa_sample, n=fm.n,
                   sigma=fm.sigma, sample_rate=fm.sample_rate)


def repair_sharded_index(idx, deep: bool = True):
    """Repair all shards of a ``ShardedTextIndex`` at once (the shard axis
    is the batch axis); seam windows are primary and pass through."""
    return dataclasses.replace(idx, shards=repair_fm_index(idx.shards,
                                                           deep=deep))


# --------------------------------------------------------------------------
# wavelet tree
# --------------------------------------------------------------------------

def repair_wavelet_tree(wt):
    """Recompute a ``WaveletTree``'s directories and ``node_starts`` from its
    level bitmaps: row l+1 of ``node_starts`` follows from row l and the
    per-node zero counts of level l (each node splits into its zero and one
    children), row 0 is [0, …]. Host numpy, as in the reference, for the
    starts; the directories on the structure's device."""
    from repro_torch.core.wavelet_tree import WaveletTree
    words_t = wt.bitvectors.rank.words
    words = words_t.cpu().numpy().view(np.uint32)          # (nbits, W)
    n, nbits = wt.n, wt.nbits
    size = 1 << nbits
    starts = np.zeros((nbits + 1, size), np.int64)
    row = np.zeros(1, np.int64)                           # 2^l node starts
    for l in range(nbits):
        starts[l, :row.shape[0]] = row   # tail stays 0 (builder's padding)
        bits = np.unpackbits(np.ascontiguousarray(words[l]).view(np.uint8),
                             bitorder="little")[:n]
        bounds = np.concatenate([row, [n]])
        ones_pref = np.concatenate([[0], np.cumsum(bits)])
        a, b = bounds[:-1], bounds[1:]
        z = (b - a) - (ones_pref[b] - ones_pref[a])
        child = np.empty(row.shape[0] * 2, np.int64)
        child[0::2] = a
        child[1::2] = a + z
        row = child
    starts[nbits, :row.shape[0]] = row
    bv = build_bitvector_levels(words_t, n, wt.bitvectors.sel1.sample_rate,
                                use_kernels=_uses_kernels(words_t))
    return WaveletTree(bitvectors=bv,
                       node_starts=torch.from_numpy(starts.astype(
                           np.int32)).to(words_t.device),
                       n=n, nbits=nbits)
