"""Sharded batched analytics over stacked wavelet-matrix shards (port of
the quantile and count half of ``repro.analytics.engine``).

Per-shard matrices with one geometry stack leaf-wise into one
``WaveletMatrix`` with a leading (S,) axis; a query batch fans across all
shards as per-shard query rows (S, Q). Cross-shard reductions stay exact:
counts sum, and the range quantile is the count-then-refine descent — the
zero counts of every shard's interval are summed before each branch, so
all shards descend in lockstep on the global k.

``available`` (an (S,) bool mask, or None) empties the local ranges of
unavailable shards; the quantile then takes the plain descent, as the
reference sends degraded mode to XLA.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.wavelet_matrix import (WaveletMatrix, wm_child_interval,
                                             wm_interval_zeros)
from repro_torch.kernels.wm_quantile import (QuantileOperands,
                                             wm_quantile_sharded)
from repro_torch.tree import tree_leaves

from . import range_ops


def local_ranges(shard_bits: int, num_shards: int, n: int, lo, hi,
                 device=None):
    """Per-shard local ranges (S, *lo.shape) of global [lo, hi): shard s
    covers ``[s·2^shard_bits, (s+1)·2^shard_bits)``, clipped so the padded
    tail past n is never touched."""
    size = 1 << shard_bits
    lo = torch.as_tensor(lo, device=device).long().clamp(0, n)
    hi = torch.maximum(torch.as_tensor(hi, device=device).long().clamp(0, n),
                       lo)
    bases = torch.arange(num_shards, device=lo.device) << shard_bits
    bases = bases.reshape((num_shards,) + (1,) * lo.dim())
    return (lo[None] - bases).clamp(0, size), (hi[None] - bases).clamp(0, size)


def mask_ranges(los: torch.Tensor, his: torch.Tensor, available):
    """Empty the local ranges of unavailable shards (``available``: (S,)
    bool or None for all available)."""
    if available is None:
        return los, his
    m = torch.as_tensor(available, dtype=torch.bool, device=los.device)
    return los, torch.where(m.reshape(m.shape + (1,) * (los.dim() - 1)),
                            his, los)


def _num_shards(shards: WaveletMatrix) -> int:
    return shards.zeros.shape[0]


def sharded_range_count(shards: WaveletMatrix, shard_bits: int, n: int, lo,
                        hi, sym_lo, sym_hi, available=None) -> torch.Tensor:
    """Orthogonal range count over the whole corpus: per-shard counts sum.
    int32."""
    los, his = mask_ranges(*local_ranges(shard_bits, _num_shards(shards), n,
                                         lo, hi, shards.zeros.device),
                           available)
    per = range_ops.range_count(shards, los, his, sym_lo, sym_hi)
    return per.long().sum(0).to(torch.int32)


def sharded_range_quantile(shards: WaveletMatrix, shard_bits: int, n: int,
                           lo, hi, k, available=None) -> torch.Tensor:
    """Global k-th smallest symbol in [lo, hi) by the count-then-refine
    descent in plain torch: O(S·logσ) rank probes per query. int32, -1 if
    the (covered) range is empty."""
    los, his = mask_ranges(*local_ranges(shard_bits, _num_shards(shards), n,
                                         lo, hi, shards.zeros.device),
                           available)
    total = (his - los).sum(0)
    k = torch.as_tensor(k, device=los.device).long()
    k = torch.minimum(k.clamp(min=0), (total - 1).clamp(min=0))
    sym = torch.zeros_like(k)
    for l in range(shards.nbits):
        lo0, hi0 = wm_interval_zeros(shards, l, los, his)
        z = (hi0 - lo0).sum(0)
        bit = (k >= z).long()
        k = torch.where(bit == 1, k - z, k)
        sym = (sym << 1) | bit
        los, his = wm_child_interval(shards, l, los, his, bit, lo0, hi0)
    return torch.where(total <= 0, -1, sym).to(torch.int32)


def sharded_range_quantile_fused(shards: WaveletMatrix, shard_bits: int,
                                 n: int, lo, hi, k,
                                 available=None) -> torch.Tensor:
    """Kernel form of :func:`sharded_range_quantile`: the whole descent,
    all shards × all levels, in one ``wm_quantile_sharded`` launch ((Q,)
    batches). With an ``available`` mask it takes the plain descent. A
    one-off call: it fixes the kernel's operands for this call alone, where
    :meth:`ShardedAnalytics.range_quantile` reuses its engine's."""
    if available is not None:
        return sharded_range_quantile(shards, shard_bits, n, lo, hi, k,
                                      available)
    from repro_torch.kernels import ops
    return ops.wm_quantile_sharded_batch(shards, shard_bits, n, lo, hi, k)


@dataclass(frozen=True)
class ShardedAnalytics:
    """Stacked per-shard wavelet matrices + corpus geometry: the serving
    handle. Build once (or adopt a ``CompressedCorpus``'s shards), then
    serve batched range queries."""
    shards: WaveletMatrix            # every leaf has a leading (S,) axis
    n: int
    sigma: int
    shard_bits: int
    available: torch.Tensor | None = None
    # the quantile kernel's operands, fixed once per engine (filled in by
    # the constructor when not given): ``shards``' directories, read in
    # place where their rows hold whole blocks; no stored leaf
    quantile: QuantileOperands | None = None

    def __post_init__(self):
        if self.quantile is None:
            from repro_torch.kernels import ops
            object.__setattr__(self, "quantile", ops.quantile_operands(
                self.shards, self.shard_bits, self.n))

    @property
    def num_shards(self) -> int:
        return _num_shards(self.shards)

    @property
    def shard_size(self) -> int:
        return 1 << self.shard_bits

    def bits_per_token(self) -> float:
        total = sum(x.numel() * x.element_size() * 8
                    for x in tree_leaves(self.shards))
        return total / max(1, self.n)

    @classmethod
    def from_corpus(cls, corpus) -> "ShardedAnalytics":
        """Adopt a ``CompressedCorpus``'s shards (no rebuild, no copy)."""
        return cls(shards=corpus.shards, n=corpus.n, sigma=corpus.sigma,
                   shard_bits=corpus.shard_bits)

    def range_quantile(self, lo, hi, k) -> torch.Tensor:
        """Global k-th smallest in [lo, hi) for (Q,) batches: the
        ``wm_quantile_sharded`` kernel on a CUDA engine, its plain version on
        a CPU engine, the plain descent under an availability mask."""
        if self.available is not None:
            return sharded_range_quantile(self.shards, self.shard_bits,
                                          self.n, lo, hi, k, self.available)
        return wm_quantile_sharded(self.quantile, lo, hi, k)

    def range_count(self, lo, hi, sym_lo, sym_hi) -> torch.Tensor:
        return sharded_range_count(self.shards, self.shard_bits, self.n, lo,
                                   hi, sym_lo, sym_hi, self.available)


def build_sharded_analytics(tokens, sigma: int, *, shard_bits: int = 16,
                            tau: int = 8, big_step: str = "compose",
                            sample_rate: int = 512,
                            device: str | torch.device = "cuda"
                            ) -> ShardedAnalytics:
    """Build the engine from a raw token stream via the compressed-store
    shard builder."""
    from repro_torch.data.compressed_store import build_compressed_corpus
    corpus = build_compressed_corpus(tokens, sigma, shard_bits=shard_bits,
                                     tau=tau, big_step=big_step,
                                     sample_rate=sample_rate, device=device)
    return ShardedAnalytics.from_corpus(corpus)
