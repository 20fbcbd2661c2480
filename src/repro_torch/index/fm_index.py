"""FM-index: backward search over a wavelet-matrix BWT (count + locate)
(port of ``repro.index.fm_index``).

Every step of backward search is two ``rank`` queries on the BWT's wavelet
matrix, so a batch of B patterns of length L issues 2·B·L rank calls, all
independent and run as one batch a step.

Structure (Ferragina–Manzini, with the occ counts answered by the wavelet
matrix):

* ``wm``       — WaveletMatrix over the BWT of ``T·$`` (working alphabet
                 [0, σ]; raw symbol c stored as c+1, terminator 0).
* ``C``        — boundary table, C[c] = # of BWT symbols < c.
* ``mark``/``sa_sample`` — sampled suffix array for ``locate``: rows j with
                 sa[j] ≡ 0 (mod sample_rate) are marked in a rank bitvector
                 and their sa values stored compacted in row order; a locate
                 walks LF at most sample_rate−1 steps to a marked row, then
                 reads the sample.

An index may carry a leading batch axis (S,) on every leaf (the stacked
shards of ``sharded.ShardedTextIndex``); queries then answer every pattern
on every row, with results (S, ...). The backward search is a Python loop
of L steps over all patterns at once; the LF walk of ``locate`` a loop of
``sample_rate`` trips with a done mask, as the reference's ``fori_loop``s.
The queries are plain torch: the reference has no kernel for them.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import obs
from repro_torch.core import bitops
from repro_torch.core.rank_select import (BinaryRank, access_bit,
                                          build_binary_rank, rank1)
from repro_torch.core.scan import flat_inclusive_sum, take
from repro_torch.core.wavelet_matrix import (WaveletMatrix,
                                             build_wavelet_matrix, wm_follow)
from repro_torch.device import resolve_device
from repro_torch.tree import tree_leaves

from .bwt import SENTINEL_SHIFT, bwt_encode


@dataclass(frozen=True)
class FMIndex:
    """Succinct full-text index over one text shard (or a stack of them:
    every leaf then has a leading (S,) axis)."""
    wm: WaveletMatrix       # BWT wavelet matrix, m = n+1 positions
    C: torch.Tensor         # (sigma+2,) int32 symbol boundaries
    mark: BinaryRank        # m bits: row j marked iff sa[j] % sample_rate == 0
    sa_sample: torch.Tensor  # (ceil(m/sample_rate),) int32, row order
    n: int                  # text length (no $)
    sigma: int              # raw alphabet size
    sample_rate: int

    @property
    def m(self) -> int:
        return self.n + 1

    def count(self, patterns, lengths) -> torch.Tensor:
        return fm_count(self, patterns, lengths)

    def locate(self, pattern, length, max_hits: int = 16) -> torch.Tensor:
        return fm_locate(self, pattern, length, max_hits)

    def bits_per_symbol(self) -> float:
        total = sum(x.numel() * x.element_size() * 8
                    for x in tree_leaves(self))
        return total / max(1, self.n)


def _pack_marks(marked: torch.Tensor, m: int,
                use_kernels: bool) -> BinaryRank:
    """Rank directory of the mark bits (*B, m): packed by ``bitpack`` and
    ranked by ``rank_build_levels`` when ``use_kernels`` (their plain
    versions for a CPU tensor), else by the plain packing and
    ``build_binary_rank``. The same leaves either way."""
    if not use_kernels:
        words = bitops.pack_bits(bitops.pad_bits(marked.to(torch.uint8)))
        return build_binary_rank(words, m)
    from repro_torch.kernels import ops
    words = ops.bitpack(marked.to(torch.int32))
    superblock, block = ops.rank_build_levels(
        words.reshape(-1, words.shape[-1]), m)
    lead = words.shape[:-1]
    return BinaryRank(words=words,
                      superblock=superblock.reshape(lead + (-1,)),
                      block=block.reshape(lead + (-1,)), n=m)


def build_fm_index(seq, sigma: int, *, sample_rate: int = 32, tau: int = 8,
                   big_step: str = "compose", bv_sample_rate: int = 512,
                   backend: str = "counting",
                   use_kernels: bool | None = None,
                   device: str | torch.device = "cuda") -> FMIndex:
    """Build the index of each row of ``seq`` ((n,) or (S, n) symbols in
    [0, σ), moved to ``device``): prefix-doubling suffix array → BWT
    gather → the paper's wavelet-matrix construction (Theorem 4.5) →
    sampled-SA directories. ``use_kernels`` (default: ``device`` is CUDA)
    routes the suffix array's sorts, the matrix and the mark directory
    through the kernels; the same index either way. Stages: the suffix
    array's ``sa.*``, ``bwt.gather``, ``bwt.c_table``, the matrix's
    ``wm.*``, ``fm.samples``."""
    dev = resolve_device(device)
    seq = torch.as_tensor(seq, device=dev)
    if use_kernels is None:
        use_kernels = dev.type == "cuda"
    if seq.numel() and (int(seq.min()) < 0 or int(seq.max()) >= sigma):
        # a symbol ≥ σ would be silently dropped from C and truncated by
        # the wavelet matrix: corrupt counts with no error downstream
        raise ValueError(f"symbols outside [0, {sigma})")
    bwt, sa, C = bwt_encode(seq, sigma, backend=backend,
                            use_kernel=use_kernels, device=dev)
    wm = build_wavelet_matrix(bwt, sigma + SENTINEL_SHIFT, tau=tau,
                              big_step=big_step, sample_rate=bv_sample_rate,
                              use_kernels=use_kernels, device=dev)

    with obs.stage("fm.samples"):
        mark, sa_sample = sample_directories(sa, sample_rate, use_kernels)
    return FMIndex(wm=wm, C=C, mark=mark, sa_sample=sa_sample,
                   n=seq.shape[-1], sigma=sigma, sample_rate=sample_rate)


def sample_directories(sa: torch.Tensor, sample_rate: int,
                       use_kernels: bool):
    """``(mark, sa_sample)`` of suffix arrays ``sa`` (*B, m): the rank
    directory of the rows j with sa[j] % sample_rate == 0 (see
    :func:`_pack_marks`) and their sa values in row order."""
    m = sa.shape[-1]
    marked = (sa % sample_rate) == 0
    # sa is a permutation of [0, m): exactly ceil(m/sample_rate) multiples,
    # compacted in row order by a scatter on the marked-prefix count; the
    # unmarked rows go to one extra column, dropped after (torch faults on
    # an index out of range where JAX drops it)
    num_samples = (m + sample_rate - 1) // sample_rate
    cnt = flat_inclusive_sum(marked).long() - 1
    slot = torch.where(marked, cnt, num_samples)
    samples = torch.zeros(sa.shape[:-1] + (num_samples + 1,),
                          dtype=torch.int32, device=sa.device)
    samples.scatter_(-1, slot, sa)
    return (_pack_marks(marked, m, use_kernels),
            samples[..., :num_samples].contiguous())


# ----------------------------------------------------------------------
# backward search
# ----------------------------------------------------------------------

def _batch_shape(fm: FMIndex) -> torch.Size:
    """The index's leading batch axes: () for one shard, (S,) stacked."""
    return fm.C.shape[:-1]


def _query_args(fm: FMIndex, patterns, lengths):
    dev = fm.C.device
    patterns = torch.atleast_2d(torch.as_tensor(patterns, device=dev).long())
    lengths = torch.atleast_1d(torch.as_tensor(lengths, device=dev).long())
    return patterns, lengths


def _descend(wm: WaveletMatrix, x: torch.Tensor,
             c: torch.Tensor) -> torch.Tensor:
    """Positions x followed down every level by the bits of the symbols c
    (same shapes): rank_c(x) is the result less that of 0."""
    for l in range(wm.nbits):
        x = wm_follow(wm, l, x, (c >> (wm.nbits - 1 - l)) & 1)
    return x


def _backward_range(fm: FMIndex, patterns: torch.Tensor,
                    lengths: torch.Tensor):
    """(lo, hi) of the SA range matching each padded pattern, each of shape
    (*S, B): ``patterns`` (B, L) raw symbols, padding anywhere at
    t ≥ length. Out-of-alphabet symbols (e.g. σ used as padding) never
    match: their shifted id clips to the C-table edge and the range
    empties.

    A step's two ranks, rank_c(lo) and rank_c(hi), share the descent of 0
    by c's bits, so one descent of (0, lo, hi) gives both: three rank
    probes a level where the reference's two ``wm_rank`` calls take four.
    The same integers."""
    B, L = patterns.shape
    shape = _batch_shape(fm) + (B,)
    lo = torch.zeros(shape, dtype=torch.long, device=patterns.device)
    hi = torch.full(shape, fm.m, dtype=torch.long, device=patterns.device)
    for t in range(L):
        i = L - 1 - t                      # right-to-left
        p = patterns[:, i]
        c = (p + SENTINEL_SHIFT).clamp(0, fm.sigma + 1).expand(shape)
        in_alpha = (p >= 0) & (p < fm.sigma)
        active = i < lengths
        base = take(fm.C, c).long()
        z, lo_c, hi_c = _descend(
            fm.wm, torch.cat([torch.zeros_like(lo), lo, hi], -1),
            torch.cat([c, c, c], -1)).split(B, -1)
        hi2 = base + (hi_c - z)
        # an out-of-alphabet symbol (e.g. shard padding) empties the range
        lo2 = torch.where(in_alpha, base + (lo_c - z), hi2)
        lo = torch.where(active, lo2, lo)
        hi = torch.where(active, hi2, hi)
    return lo, hi


def fm_count(fm: FMIndex, patterns, lengths) -> torch.Tensor:
    """# of occurrences of each pattern in the text, (*S, B) ``int32``.

    ``patterns``: (B, L) int, padded; ``lengths``: (B,) true lengths. A
    zero-length pattern counts every position (m matches of the empty
    string, including before the terminator).
    """
    lo, hi = _backward_range(fm, *_query_args(fm, patterns, lengths))
    return (hi - lo).to(torch.int32)


# ----------------------------------------------------------------------
# locate (sampled-SA LF walk)
# ----------------------------------------------------------------------

def _lf_step(fm: FMIndex, j: torch.Tensor) -> torch.Tensor:
    """LF(j) = C[c] + rank_c(j), c the BWT symbol at row j: the row whose
    suffix starts one text position earlier.

    The reference takes ``wm_access`` and then ``wm_rank``. Following j
    by its own bits is both the access walk and the descent of j by c's
    bits, so one walk of (j, 0) gives c and rank_c(j): two rank probes a
    level where the two calls take four. The same integers."""
    wm = fm.wm
    p = j.long()
    lo = torch.zeros_like(p)
    c = torch.zeros_like(p)
    for l in range(wm.nbits):
        bit = access_bit(wm.level(l).rank, p)
        p, lo = wm_follow(wm, l, p, bit), wm_follow(wm, l, lo, bit)
        c = (c << 1) | bit
    return take(fm.C, c).long() + (p - lo)


def _locate_row(fm: FMIndex, j: torch.Tensor) -> torch.Tensor:
    """Text position of SA rows ``j`` (*S, ...): walk LF to the nearest
    marked row, ``sample_rate`` trips with a done mask."""
    j = j.long()
    steps = torch.zeros_like(j)
    done = torch.zeros_like(j, dtype=torch.bool)
    for _ in range(fm.sample_rate):
        done = done | (access_bit(fm.mark, j) > 0)
        j = torch.where(done, j, _lf_step(fm, j))
        steps = torch.where(done, steps, steps + 1)
    sample = take(fm.sa_sample, rank1(fm.mark, j)).long()
    return (sample + steps) % fm.m


def fm_locate(fm: FMIndex, pattern, length, max_hits: int = 16
              ) -> torch.Tensor:
    """Text positions of up to ``max_hits`` matches of each pattern.

    ``pattern`` (L,) with a scalar ``length``, or (B, L) with (B,)
    lengths. Returns (*S, max_hits), or (*S, B, max_hits) for a batch,
    ``int32``, sorted ascending, padded with -1 past the true match count.
    """
    single = torch.as_tensor(pattern).dim() == 1
    patterns, lengths = _query_args(fm, pattern, length)
    lo, hi = _backward_range(fm, patterns, lengths)
    ks = torch.arange(max_hits, device=lo.device)
    rows = (lo[..., None] + ks).clamp(max=fm.m - 1)
    pos = _locate_row(fm, rows)
    valid = ks < (hi - lo)[..., None]
    out = torch.sort(torch.where(valid, pos, fm.m), dim=-1).values
    out = torch.where(out >= fm.m, -1, out).to(torch.int32)
    return out.squeeze(-2) if single else out

