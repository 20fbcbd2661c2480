"""Parallel suffix array construction by prefix doubling (port of
``repro.index.suffix_array``).

Each doubling round is one stable pair sort (two LSD passes of
``core.sort.radix_sort_stable``: by the offset rank, then stably by the
head rank) and one prefix sum to re-rank ("name assignment"). On CUDA
tensors every pass of more than 32 buckets ranks through the
``radix_rank`` kernels (a totals count and a scan, as
``core.sort.counting_rank`` routes it): at m = 2^20 + 1 a key has 21 bits,
passes of 8, 8 and 5 bits, so a round makes four kernel passes, and the
first-character sort of 18-bit symbols (8, 8 and 2 bits) two.

Texts may carry leading batch axes (*B, n): every row is sorted on its own
and one round sorts all rows at once (the shard axis of a sharded index is
the batch axis). The host loop stops once every row's ranks are distinct, one
host sync a round; a finished row is left as it is by further rounds, so
stopping at the slowest row gives each row's own suffix array.

Stages (``obs.stage``): ``sa.initial`` (round 0), ``sa.round`` (a doubling
round, attribute ``offset``), ``sa.converged`` (the sync that ends the
loop).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.scan import flat_inclusive_sum, take
from repro_torch.core.sort import radix_sort_stable
from repro_torch.device import resolve_device


def _rank_bits(n: int) -> int:
    """Bits needed for a doubling-round key: ranks live in [0, n+1]."""
    return max(1, math.ceil(math.log2(n + 2)))


def _names(keys) -> torch.Tensor:
    """Dense ranks of rows of sorted key columns ``keys`` (a tuple of
    (*B, n) tensors): the number of distinct smaller keys, ``int32``."""
    neq = torch.zeros_like(keys[0], dtype=torch.bool)
    for k in keys:
        neq |= k != torch.roll(k, 1, dims=-1)
    neq[..., 0] = False
    return flat_inclusive_sum(neq)


def _scatter_ranks(sa: torch.Tensor, names: torch.Tensor) -> torch.Tensor:
    """rank[..., sa[..., j]] = names[..., j] (each row of ``sa`` a
    permutation)."""
    return torch.empty_like(names).scatter_(-1, sa.long(), names)


def doubling_round(rank: torch.Tensor, offset: int, key_bits: int,
                   bits_per_pass: int = 8, backend: str = "counting",
                   use_kernel: bool | None = None):
    """One prefix-doubling round: sort suffixes by the pair
    ``(rank[i], rank[i + offset])`` and assign dense new ranks.

    ``rank``: (*B, n) int32 current rank of each suffix. Returns ``(sa,
    new_rank)``, both (*B, n) int32. Suffixes running past the end compare
    smallest, via a 0 sentinel after a +1 shift. ``use_kernel``: as in
    ``core.sort.counting_rank`` (default: the ranks lie on a CUDA device).
    """
    n = rank.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=rank.device).expand(
        rank.shape).contiguous()
    r1 = rank + 1
    tail = idx.long() + offset
    r2 = torch.where(tail < n, take(rank, tail.clamp(max=n - 1)) + 1,
                     0).to(torch.int32)

    # stable pair sort = LSD over the two components (secondary first)
    r2s, (idx1, r1s) = radix_sort_stable(
        r2, key_bits, values=(idx, r1), bits_per_pass=bits_per_pass,
        backend=backend, use_kernel=use_kernel)
    r1f, (sa, r2f) = radix_sort_stable(
        r1s, key_bits, values=(idx1, r2s), bits_per_pass=bits_per_pass,
        backend=backend, use_kernel=use_kernel)
    return sa, _scatter_ranks(sa, _names((r1f, r2f)))


def initial_ranks(seq: torch.Tensor, sigma: int, bits_per_pass: int = 8,
                  backend: str = "counting",
                  use_kernel: bool | None = None):
    """Round 0: ``(order, rank)`` of each row by its first character, one
    stable sort of the symbols in [0, sigma) and one re-rank."""
    n = seq.shape[-1]
    sym_bits = max(1, math.ceil(math.log2(max(2, sigma))))
    idx = torch.arange(n, dtype=torch.int32, device=seq.device).expand(
        seq.shape).contiguous()
    syms, (order,) = radix_sort_stable(
        seq.to(torch.int32), sym_bits, values=(idx,),
        bits_per_pass=bits_per_pass, backend=backend, use_kernel=use_kernel)
    return order, _scatter_ranks(order, _names((syms,)))


def all_distinct(sa: torch.Tensor, rank: torch.Tensor) -> bool:
    """Whether every row's ranks are distinct (its largest rank is n - 1);
    one host sync."""
    n = rank.shape[-1]
    return bool((take(rank, sa[..., -1:]) == n - 1).all())


def suffix_array(seq, sigma: int | None = None, *, bits_per_pass: int = 8,
                 backend: str = "counting", max_rounds: int | None = None,
                 use_kernel: bool | None = None,
                 device: str | torch.device = "cuda") -> torch.Tensor:
    """Suffix array of each row of ``seq`` ((n,) or (*B, n), moved to
    ``device``): ``sa[j]`` = start of the j-th smallest suffix. Running off
    the end compares smaller than any symbol. ``int32``.

    ``sigma`` (symbols in [0, σ)) defaults to the largest symbol + 1 (a
    host sync); ``max_rounds`` pins the number of doubling rounds, else
    the loop stops once every row's ranks are distinct.
    """
    dev = resolve_device(device)
    seq = torch.as_tensor(seq, device=dev)
    n = seq.shape[-1]
    if n <= 1:
        return torch.zeros(seq.shape, dtype=torch.int32, device=dev)
    if sigma is None:
        sigma = int(seq.max()) + 1
    with obs.stage("sa.initial"):
        sa, rank = initial_ranks(seq, sigma, bits_per_pass, backend,
                                 use_kernel)
    kb = _rank_bits(n)
    rounds = (max_rounds if max_rounds is not None
              else math.ceil(math.log2(n)) + 1)
    offset = 1
    for _ in range(rounds):
        if offset >= n:
            break
        with obs.stage("sa.round", offset=offset):
            sa, rank = doubling_round(rank, offset, kb, bits_per_pass,
                                      backend, use_kernel)
        offset *= 2
        if max_rounds is None:
            with obs.stage("sa.converged"):
                if all_distinct(sa, rank):
                    break
    return sa


def suffix_array_naive(seq: np.ndarray) -> np.ndarray:
    """O(n² log n) numpy oracle (same end-of-string convention)."""
    s = list(np.asarray(seq).tolist())
    order = sorted(range(len(s)), key=lambda i: s[i:])
    return np.asarray(order, np.int32)
