"""Wrapper contracts around the kernels (port of ``repro.kernels.ops``).

Each op handles layout, padding and trimming and calls a kernel module,
which launches the CUDA kernel for CUDA tensors and runs its plain version
for CPU tensors. The contracts are the reference's: same arguments, same
results, with the port's ``int32``/``int16`` leaves.

Every op records, as the reference's do, ``kernels.trace{op, route}``
(``route=cuda`` where it launches, ``plain`` where the plain version runs;
the reference labels ``interpret``) and the ``kernels.work.elements`` /
``kernels.work.bits`` gauges of its size; the port runs eagerly, so they
count calls, not traces. Each op also adds its bytes (each input read
once, each output written once) and int32 operations to the work model
of ``obs.prof`` while a profile is open. :data:`TRACE_LAUNCHES` says how
many launches each trace stands for.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import obs as _obs
from repro_torch.core import bitops
from repro_torch.core.rank_select import BLOCK_WORDS
from repro_torch.obs import prof as _prof
from repro_torch.tree import tree_map

from . import bitpack as _bitpack
from . import radix_rank as _radix_rank
from . import rank_build as _rank_build
from . import topk_greedy as _topk_greedy
from . import wm_count as _wm_count
from . import wm_level as _wm_level
from . import wm_quantile as _wm_quantile
from . import wt_level as _wt_level


#: ``kernels.trace`` op -> (``build.launches`` counter, launches a trace:
#: least, most). One launch a trace, except ``wm_level_step`` (the count
#: launch, then the level) and ``radix_rank`` without bucket starts (the
#: totals launch, then the scan); the one-launch level with its totals
#: given traces as ``wm_level_step_fused``, the reference's name for its
#: one-pass level, and the level that moves its keys as ``wm_level_move``.
TRACE_LAUNCHES = {"bitpack": ("bitpack", 1, 1),
                  "rank_build": ("rank_build_levels", 1, 1),
                  "rank_build_levels": ("rank_build_levels", 1, 1),
                  "wm_level_zeros": ("wm_level_step", 1, 1),
                  "wm_level_step_fused": ("wm_level_step", 1, 1),
                  "wm_level_step": ("wm_level_step", 2, 2),
                  "wm_level_move": ("wm_level_step", 1, 1),
                  "wt_level_step_fused": ("wt_level_step", 1, 1),
                  "radix_rank": ("radix_rank", 1, 2),
                  "wm_quantile_sharded_batch": ("wm_quantile_sharded", 1, 1),
                  "wm_quantile_batch": ("wm_quantile_sharded", 1, 1),
                  "topk_greedy": ("topk_greedy", 1, 1),
                  "wm_count": ("wm_count", 1, 1)}


def _trace(op: str, x: torch.Tensor) -> None:
    _obs.counter("kernels.trace", op=op,
                 route="cuda" if x.device.type == "cuda" else "plain").inc()


def _work_gauges(op: str, elements: int, bits: int | None = None) -> None:
    """Work-size gauges of one call: the problem size of its launch (the
    reference records them at trace time)."""
    _obs.gauge("kernels.work.elements", op=op).set(float(elements))
    if bits is not None:
        _obs.gauge("kernels.work.bits", op=op).set(float(bits))


def _rows(x: torch.Tensor) -> torch.Tensor:
    """(R, n) contiguous int32 view of a (…, n) tensor."""
    return x.reshape(-1, x.shape[-1]).to(torch.int32).contiguous()


def bitpack(bits: torch.Tensor) -> torch.Tensor:
    """Pack a (…, n) 0/1 tensor into (…, ceil(n/32)) int32 words,
    LSB-first, zero past n — the contract of the reference's ``bitpack``
    without its (32, W) transpose."""
    n = bits.shape[-1]
    _trace("bitpack", bits)
    _work_gauges("bitpack", bits.numel(), bits=bits.numel())
    words = _bitpack.bitpack(_rows(bits), n)
    _prof.add_work(bits.numel() * 4 + words.numel() * 4,
                   bits.numel() * 2)
    return words.reshape(bits.shape[:-1] + (-1,))


def radix_rank(digits: torch.Tensor, num_buckets: int,
               bucket_starts: torch.Tensor | None = None) -> torch.Tensor:
    """Stable counting-sort destination of every digit of each (…, n) row
    (digits in [0, num_buckets), num_buckets ≤ ``radix_rank.MAX_BUCKETS``).
    ``bucket_starts`` (…, num_buckets) int32: where each bucket starts in
    its row's output, when the caller knows it (a tree build does); then
    one launch, else a totals launch first. The same result either way: the
    contract of ``core.sort.counting_rank``; (…, n) int32."""
    if num_buckets > _radix_rank.MAX_BUCKETS:
        raise ValueError(f"num_buckets {num_buckets} exceeds "
                         f"{_radix_rank.MAX_BUCKETS}")
    n = digits.shape[-1]
    _trace("radix_rank", digits)
    _work_gauges("radix_rank", digits.numel())
    d = _rows(digits)
    starts = None
    if bucket_starts is not None:
        want = digits.shape[:-1] + (num_buckets,)
        if bucket_starts.shape != want:
            raise ValueError(f"bucket_starts {tuple(bucket_starts.shape)} do "
                             f"not fit digits {tuple(digits.shape)} and "
                             f"{num_buckets} buckets")
        starts = bucket_starts.reshape(d.shape[0], num_buckets)
    dest = _radix_rank.radix_rank(d, num_buckets, n, starts)
    _prof.add_work(digits.numel() * 8
                   + (0 if starts is None else starts.numel() * 4),
                   digits.numel() * 8)
    return dest.reshape(digits.shape)


def wt_level_step_fused(sub: torch.Tensor, nid: torch.Tensor, shift: int,
                        nbkt: int, n: int,
                        bucket_starts: torch.Tensor | None = None):
    """One segmented wavelet-tree level on narrow keys ``sub`` (n,) or
    (R, n) with node ids ``nid`` (non-decreasing per row): (dest int32
    stable per-node partition destinations, bitmap (…, ceil(n/32)) int32).
    ``nbkt`` = 2^(l+1) ≤ ``wt_level.MAX_KEYS``; ``bucket_starts`` (…, nbkt)
    int32, the start of every (node, bit) bucket in the level's output (a
    tree build passes ``node_starts[l + 1, :nbkt]``). With them one launch;
    without, a per-row bucket count comes first."""
    s, v = _rows(sub), _rows(nid)
    _trace("wt_level_step_fused", sub)
    _work_gauges("wt_level_step_fused", s.numel(), bits=s.numel())
    starts = (None if bucket_starts is None
              else bucket_starts.reshape(s.shape[0], nbkt).to(torch.int32))
    dest, bitmap = _wt_level.wt_level(s, v, shift, nbkt, n, starts)
    _prof.add_work(s.numel() * 12 + bitmap.numel() * 4, s.numel() * 12)
    lead = sub.shape[:-1]
    return dest.reshape(lead + (n,)), bitmap.reshape(lead + (-1,))


def rank_build_levels(words: torch.Tensor, n: int):
    """Jacobson directories of L stacked n-bit rows (L, W) int32, one launch.

    Returns (superblock (L, ceil(w/32)) int32, block (L, ceil(w/4)) int16),
    w = ceil(n/32) — row-wise ``rank_select.build_binary_rank``.
    """
    _trace("rank_build_levels", words)
    _work_gauges("rank_build_levels", words.shape[0] * n,
                 bits=words.shape[0] * n)
    return _rank_directories(words, n)


def _rank_directories(words: torch.Tensor, n: int):
    superblock, block = _rank_build.rank_build_levels(words,
                                                      bitops.num_words(n))
    _prof.add_work(words.numel() * 4 + superblock.numel() * 4
                   + block.numel() * 2, words.numel() * 8)
    return superblock, block


def rank_build(words: torch.Tensor, n: int):
    """Single-row form of :func:`rank_build_levels` (the same kernel at
    L = 1): (superblock, block) of a (W,) row."""
    _trace("rank_build", words)
    _work_gauges("rank_build", n, bits=n)
    superblock, block = _rank_directories(words[None], n)
    return superblock[0], block[0]


def wm_level_zeros(seq: torch.Tensor, nbits: int) -> torch.Tensor:
    """Zeros of every level of every row of ``seq`` (n,) or (R, n): (…,
    nbits) int32, column l counting the symbols whose bit ``nbits - 1 - l``
    is 0. One launch over the rows. A permutation of a row keeps its
    counts, so a matrix build takes every level's totals from its input."""
    keys = _rows(seq)
    _trace("wm_level_zeros", seq)
    _work_gauges("wm_level_zeros", keys.numel(), bits=keys.numel() * nbits)
    zeros = _wm_level.wm_level_zeros(keys, 0, nbits, keys.shape[1])
    _prof.add_work(keys.numel() * 4 + zeros.numel() * 4,
                   keys.numel() * nbits)
    return zeros.reshape(seq.shape[:-1] + (nbits,))


def wm_level_step(sub: torch.Tensor, shift: int, n: int,
                  total_zeros: torch.Tensor | None = None):
    """One wavelet-matrix level on narrow keys ``sub`` (n,) or (R, n).

    ``shift``: bit position of this level's bit inside the key;
    ``total_zeros`` (…,) int32: the zeros of that bit in each row (a matrix
    build passes the column of :func:`wm_level_zeros`). Returns (dest (…,
    n) int32 stable-partition destinations, bitmap (…, ceil(n/32)) int32,
    total_zeros (…,) int32 as the level counted them) — the contract of
    both ``wm_level_step`` and ``wm_level_step_fused`` in the reference.
    With the totals one launch (traced as ``wm_level_step_fused``);
    without, a count launch first (traced as ``wm_level_step``).
    """
    keys = _rows(sub)
    op = "wm_level_step" if total_zeros is None else "wm_level_step_fused"
    _trace(op, sub)
    _work_gauges(op, keys.numel(), bits=keys.numel())
    if total_zeros is None:
        total = _wm_level.wm_level_zeros(keys, shift, 1, n)[:, 0]
    else:
        total = total_zeros.reshape(keys.shape[0]).to(torch.int32)
    dest, bitmap, zeros = _wm_level.wm_level(keys, total, shift, n)
    _prof.add_work(keys.numel() * 8 + bitmap.numel() * 4
                   + zeros.numel() * 4, keys.numel() * 24)
    lead = sub.shape[:-1]
    return (dest.reshape(lead + (n,)), bitmap.reshape(lead + (-1,)),
            zeros.reshape(lead))


def wm_level_move(sub: torch.Tensor, shift: int, n: int,
                  total_zeros: torch.Tensor):
    """One wavelet-matrix level that moves its keys ``sub`` (n,) or (R, n):
    :func:`wm_level_step` with the totals, whose destinations the launch
    applies itself. Returns (moved keys (…, n) int32, each row the level's
    stable 0/1 partition of its keys by bit ``shift``, bitmap (…,
    ceil(n/32)) int32, total_zeros (…,) int32 as the level counted them).
    One launch, counted under ``wm_level_step``."""
    keys = _rows(sub)
    _trace("wm_level_move", sub)
    _work_gauges("wm_level_move", keys.numel(), bits=keys.numel())
    total = total_zeros.reshape(keys.shape[0]).to(torch.int32)
    moved, bitmap, zeros = _wm_level.wm_level_move(keys, total, shift, n)
    _prof.add_work(keys.numel() * 8 + bitmap.numel() * 4
                   + zeros.numel() * 4, keys.numel() * 24)
    lead = sub.shape[:-1]
    return (moved.reshape(lead + (n,)), bitmap.reshape(lead + (-1,)),
            zeros.reshape(lead))


def _pad_rank_rows(words: torch.Tensor, superblock: torch.Tensor,
                   block: torch.Tensor, nblocks: int):
    """Row-stacked directories for the quantile kernel: word rows grow to
    at least nblocks·BLOCK_WORDS words and to a multiple of 4 (so every
    block gathers its four words in one aligned 16-byte load), zero-padded;
    all three become contiguous. Rows that already fit are not copied."""
    need = max(nblocks * BLOCK_WORDS, -(-words.shape[1] // 4) * 4)
    if need > words.shape[1]:
        words = F.pad(words, (0, need - words.shape[1]))
    return words.contiguous(), superblock.contiguous(), block.contiguous()


def quantile_operands(shards, shard_bits: int, n: int):
    """The quantile kernel's operands (``wm_quantile.QuantileOperands``) of
    a stacked (S,)-leaf ``WaveletMatrix``: its directories flattened to
    (S·nbits, ·) rows, row ``s*nbits + l``, read in place (word rows are
    padded only where they do not hold whole blocks). An engine builds them
    once (``ShardedAnalytics.quantile``)."""
    rank = shards.bitvectors.rank
    num_shards, nbits = rank.words.shape[0], shards.nbits
    rows = num_shards * nbits
    words, superblock, block = _pad_rank_rows(
        rank.words.reshape(rows, -1), rank.superblock.reshape(rows, -1),
        rank.block.reshape(rows, -1), rank.block.shape[-1])
    return _wm_quantile.quantile_operands(
        words, superblock, block, shards.zeros.reshape(rows),
        num_shards=num_shards, nbits=nbits, n=n, shard_bits=shard_bits)


def wm_quantile(operands, lo, hi, k,
                name: str = "wm_quantile_sharded_batch") -> torch.Tensor:
    """Batched global range quantile on the kernel's operands
    (:func:`quantile_operands`; an engine keeps its own,
    ``ShardedAnalytics.quantile``): every shard and level in one launch.
    ``lo``/``hi``/``k``: (Q,) global positions / rank. Returns (Q,) int32,
    -1 for empty ranges. ``name`` is the op that ``kernels.trace`` records.
    """
    _trace(name, operands.words)
    out = _wm_quantile.wm_quantile_sharded(operands, lo, hi, k)
    _work_gauges(name, out.shape[0])
    if _prof.collecting():
        _prof.add_work(*_wm_quantile.quantile_work(operands, lo, hi, k))
    return out


def wm_count(operands, los: torch.Tensor, his: torch.Tensor, sym_lo,
             sym_hi) -> torch.Tensor:
    """Global range count on the quantile kernel's operands (the port's own
    kernel; the reference counts through XLA): ``los``/``his`` (Q, S)
    local ranges, ``sym_lo``/``sym_hi`` (Q,) symbol bounds, every shard of
    every query in one launch. Returns (Q,) int32, the contract of
    ``analytics.engine.sharded_range_count``."""
    _trace("wm_count", operands.words)
    out = _wm_count.wm_count_sharded(operands, los, his, sym_lo, sym_hi)
    _work_gauges("wm_count", los.shape[0])
    if _prof.collecting():
        _prof.add_work(los.numel() * 8 + out.numel() * 12)
    return out


def topk_greedy(operands, los: torch.Tensor, his: torch.Tensor, k: int,
                budget: int | None = None, prune: bool = True):
    """Greedy global top-k on the quantile kernel's operands (the port's
    own kernel; the reference runs the frontier as an XLA loop): ``los``/
    ``his`` (Q, S) local ranges, every query's frontier in one launch.
    Returns (syms (Q, k), counts (Q, k), found (Q,)) int32, the contract of
    ``analytics.range_ops.topk_frontier``."""
    _trace("topk_greedy", operands.words)
    out = _topk_greedy.topk_greedy(operands, los, his, k, budget, prune)
    _work_gauges("topk_greedy", los.shape[0])
    if _prof.collecting():
        _prof.add_work(los.numel() * 8 + out[0].numel() * 8
                       + out[2].numel() * 4)
    return out


def wm_quantile_sharded_batch(shards, shard_bits: int, n: int, lo, hi,
                              k) -> torch.Tensor:
    """Batched global range quantile over a stacked (S,)-leaf
    ``WaveletMatrix``: every shard and level in one launch.

    ``lo``/``hi``/``k``: (Q,) global positions / rank. Returns (Q,) int32,
    -1 for empty ranges — the contract of
    ``analytics.engine.sharded_range_quantile``.
    """
    return wm_quantile(quantile_operands(shards, shard_bits, n), lo, hi, k)


def wm_quantile_batch(wm, lo, hi, k) -> torch.Tensor:
    """Batched range quantile over one ``WaveletMatrix``: the sharded kernel
    at S = 1, with a shard size covering n. (Q,) int32, -1 if empty."""
    shard_bits = max(0, (wm.n - 1).bit_length())
    one = tree_map(lambda x: x[None], wm)
    return wm_quantile(quantile_operands(one, shard_bits, wm.n), lo, hi, k,
                       name="wm_quantile_batch")
