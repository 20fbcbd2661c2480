"""Wrapper contracts around the kernels (port of ``repro.kernels.ops``).

Each op handles layout, padding and trimming and calls a kernel module,
which launches the CUDA kernel for CUDA tensors and runs its plain version
for CPU tensors. The contracts are the reference's: same arguments, same
results, with the port's ``int32``/``int16`` leaves.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import bitops
from repro_torch.core.rank_select import BLOCK_WORDS
from repro_torch.tree import tree_map

from . import bitpack as _bitpack
from . import radix_rank as _radix_rank
from . import rank_build as _rank_build
from . import wm_level as _wm_level
from . import wm_quantile as _wm_quantile
from . import wt_level as _wt_level


def _rows(x: torch.Tensor) -> torch.Tensor:
    """(R, n) contiguous int32 view of a (…, n) tensor."""
    return x.reshape(-1, x.shape[-1]).to(torch.int32).contiguous()


def bitpack(bits: torch.Tensor) -> torch.Tensor:
    """Pack a (…, n) 0/1 tensor into (…, ceil(n/32)) int32 words,
    LSB-first, zero past n — the contract of the reference's ``bitpack``
    without its (32, W) transpose."""
    n = bits.shape[-1]
    words = _bitpack.bitpack(_rows(bits), n)
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
    starts = (None if bucket_starts is None
              else bucket_starts.reshape(s.shape[0], nbkt).to(torch.int32))
    dest, bitmap = _wt_level.wt_level(s, v, shift, nbkt, n, starts)
    lead = sub.shape[:-1]
    return dest.reshape(lead + (n,)), bitmap.reshape(lead + (-1,))


def rank_build_levels(words: torch.Tensor, n: int):
    """Jacobson directories of L stacked n-bit rows (L, W) int32, one launch.

    Returns (superblock (L, ceil(w/32)) int32, block (L, ceil(w/4)) int16),
    w = ceil(n/32) — row-wise ``rank_select.build_binary_rank``.
    """
    return _rank_build.rank_build_levels(words, bitops.num_words(n))


def rank_build(words: torch.Tensor, n: int):
    """Single-row form of :func:`rank_build_levels` (the same kernel at
    L = 1): (superblock, block) of a (W,) row."""
    superblock, block = rank_build_levels(words[None], n)
    return superblock[0], block[0]


def wm_level_zeros(seq: torch.Tensor, nbits: int) -> torch.Tensor:
    """Zeros of every level of every row of ``seq`` (n,) or (R, n): (…,
    nbits) int32, column l counting the symbols whose bit ``nbits - 1 - l``
    is 0. One launch over the rows. A permutation of a row keeps its
    counts, so a matrix build takes every level's totals from its input."""
    keys = _rows(seq)
    zeros = _wm_level.wm_level_zeros(keys, 0, nbits, keys.shape[1])
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
    With the totals one launch; without, a count launch first.
    """
    keys = _rows(sub)
    if total_zeros is None:
        total = _wm_level.wm_level_zeros(keys, shift, 1, n)[:, 0]
    else:
        total = total_zeros.reshape(keys.shape[0]).to(torch.int32)
    dest, bitmap, zeros = _wm_level.wm_level(keys, total, shift, n)
    lead = sub.shape[:-1]
    return (dest.reshape(lead + (n,)), bitmap.reshape(lead + (-1,)),
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


def wm_quantile_sharded_batch(shards, shard_bits: int, n: int, lo, hi,
                              k) -> torch.Tensor:
    """Batched global range quantile over a stacked (S,)-leaf
    ``WaveletMatrix``: every shard and level in one launch.

    ``lo``/``hi``/``k``: (Q,) global positions / rank. Returns (Q,) int32,
    -1 for empty ranges — the contract of
    ``analytics.engine.sharded_range_quantile``.
    """
    return _wm_quantile.wm_quantile_sharded(
        quantile_operands(shards, shard_bits, n), lo, hi, k)


def wm_quantile_batch(wm, lo, hi, k) -> torch.Tensor:
    """Batched range quantile over one ``WaveletMatrix``: the sharded kernel
    at S = 1, with a shard size covering n. (Q,) int32, -1 if empty."""
    shard_bits = max(0, (wm.n - 1).bit_length())
    one = tree_map(lambda x: x[None], wm)
    return wm_quantile_sharded_batch(one, shard_bits, wm.n, lo, hi, k)
