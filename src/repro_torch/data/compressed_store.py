"""Wavelet-matrix compressed token store (port of
``repro.data.compressed_store``).

A token stream is cut into power-of-two shards, each built into a wavelet
matrix by the τ-chunk construction, and the shards are stacked leaf-wise:
⌈logσ⌉ bits per token plus the o(n) directories (18 levels for Qwen2's
σ = 151,936). Queries: ``access`` (decode), ``count`` (rank of a token),
``locate`` (select), and the sharded range quantile and count.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.analytics.engine import (sharded_range_count,
                                          sharded_range_distinct,
                                          sharded_range_histogram,
                                          sharded_range_quantile,
                                          sharded_range_topk)
from repro_torch.core import bitops
from repro_torch.core.rank_select import rank1_rows
from repro_torch.core.wavelet_matrix import (WaveletMatrix,
                                             build_wavelet_matrix,
                                             num_levels, wm_rank,
                                             wm_select)
from repro_torch.device import resolve_device
from repro_torch.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class CompressedCorpus:
    """Stacked wavelet-matrix shards + per-shard symbol histograms."""
    shards: WaveletMatrix          # leaves carry a leading (S,) axis
    shard_counts: torch.Tensor     # (S + 1, sigma) int32 exclusive cumsum
    n: int
    sigma: int
    shard_bits: int

    @property
    def shard_size(self) -> int:
        return 1 << self.shard_bits

    @property
    def num_shards(self) -> int:
        return self.shard_counts.shape[0] - 1

    @property
    def nbits(self) -> int:
        return num_levels(self.sigma)

    def shard(self, s: int) -> WaveletMatrix:
        return tree_map(lambda x: x[s], self.shards)

    def bits_per_token(self) -> float:
        total = sum(x.numel() * x.element_size() * 8
                    for x in tree_leaves(self.shards))
        return total / self.n

    def raw_bits_per_token(self) -> int:
        return 32

    def _arg(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.shard_counts.device).long()

    def _per_shard(self, sid: torch.Tensor, fn) -> torch.Tensor:
        """out[i] = fn(s, mask)[...] for the queries i of every shard s
        present in ``sid`` (shard ids clamped into range, as the
        reference's gathers clamp)."""
        sid = sid.clamp(0, self.num_shards - 1)
        out = torch.zeros(sid.shape, dtype=torch.long, device=sid.device)
        for s in torch.unique(sid).tolist():
            m = sid == s
            out[m] = fn(s, m).long()
        return out

    def access(self, pos) -> torch.Tensor:
        """Decode the tokens at arbitrary positions: every position walks
        its own shard's levels at once (a lane names its (shard, level)
        row of the stacked directories, as the reference's gathers do;
        shard ids clamped into range), so a batch over many shards costs
        one pass of the levels and no host round trip."""
        pos = self._arg(pos)
        flat = pos.reshape(-1)
        sid = (flat >> self.shard_bits).clamp(0, self.num_shards - 1)
        p = flat & (self.shard_size - 1)
        rs = self.shards.bitvectors.rank          # leaves (S, L, ·)
        levels = self.nbits
        words = rs.words.reshape(-1)
        width = rs.words.shape[-1]
        zeros = self.shards.zeros.reshape(-1)
        c = torch.zeros_like(p)
        for l in range(levels):
            row = sid * levels + l
            bit = (bitops.u32(words[row * width + (p >> 5)]) >> (p & 31)) & 1
            ones = rank1_rows(rs, row, p)
            p = torch.where(bit == 0, p - ones, zeros[row].long() + ones)
            c = (c << 1) | bit
        return c.reshape(pos.shape).to(torch.int32)

    def decode_slice(self, start, length: int) -> torch.Tensor:
        """Decode the contiguous span [start, start + length) (a scalar
        start, a static length), across shard boundaries."""
        return self.access(self._arg(start) + torch.arange(
            length, device=self.shard_counts.device))

    def count(self, token, upto=None) -> torch.Tensor:
        """# occurrences of ``token`` in [0, upto) (whole corpus if None)."""
        token = self._arg(token)
        if upto is None:
            return self.shard_counts[-1, token]
        token, upto = torch.broadcast_tensors(token, self._arg(upto))
        t, u = token.reshape(-1), upto.reshape(-1)
        sid = u >> self.shard_bits
        off = u & (self.shard_size - 1)
        within = self._per_shard(
            sid, lambda s, m: wm_rank(self.shard(s), t[m], off[m]))
        base = self.shard_counts[sid.clamp(0, self.num_shards), t].long()
        return (base + within).reshape(token.shape).to(torch.int32)

    def locate(self, token, k) -> torch.Tensor:
        """Position of the k-th (0-based) occurrence of ``token``."""
        token, k = torch.broadcast_tensors(self._arg(token), self._arg(k))
        t, kk = token.reshape(-1), k.reshape(-1)
        cols = self.shard_counts[:, t].T.long().contiguous()   # (P, S+1)
        sid = (torch.searchsorted(cols, kk[:, None], right=True)[:, 0] - 1
               ).clamp(0, self.num_shards - 1)
        within = kk - cols.gather(1, sid[:, None])[:, 0]
        pos = self._per_shard(
            sid, lambda s, m: wm_select(self.shard(s), t[m], within[m]))
        return ((sid << self.shard_bits) + pos).reshape(token.shape).to(
            torch.int32)

    def range_quantile(self, lo, hi, k) -> torch.Tensor:
        """k-th smallest token in corpus positions [lo, hi) (plain descent)."""
        return sharded_range_quantile(self.shards, self.shard_bits, self.n,
                                      lo, hi, k)

    def range_count(self, lo, hi, sym_lo, sym_hi) -> torch.Tensor:
        """# of positions in [lo, hi) holding a token in [sym_lo, sym_hi)."""
        return sharded_range_count(self.shards, self.shard_bits, self.n,
                                   lo, hi, sym_lo, sym_hi)

    def range_topk(self, lo, hi, k: int):
        """(tokens, counts) of the k most frequent tokens in [lo, hi)."""
        return sharded_range_topk(self.shards, self.shard_bits, self.n, lo,
                                  hi, k)

    def range_distinct(self, lo, hi) -> torch.Tensor:
        """# of distinct tokens in [lo, hi)."""
        return sharded_range_distinct(self.shards, self.shard_bits, self.n,
                                      lo, hi)

    def range_histogram(self, lo, hi) -> torch.Tensor:
        """Per-token counts over [lo, hi): (…, 2^nbits) int32."""
        return sharded_range_histogram(self.shards, self.shard_bits, self.n,
                                       lo, hi)


def build_compressed_corpus(tokens, sigma: int, shard_bits: int = 16,
                            tau: int = 8, big_step: str = "compose",
                            sample_rate: int = 512,
                            device: str | torch.device = "cuda"
                            ) -> CompressedCorpus:
    """Pad the stream to whole shards (with token 0, never addressed: n
    keeps the true length and the histograms subtract the padding), build
    every shard on ``device`` and stack them. Stages: ``store.upload``
    (the cast, the range check's sync, the pad), the matrix's ``wm.*``,
    ``store.histograms``."""
    dev = resolve_device(device)
    with obs.stage("store.upload"):
        if isinstance(tokens, torch.Tensor):
            toks = tokens.to(device=dev, dtype=torch.int32)
        else:
            toks = torch.from_numpy(
                np.asarray(tokens).astype(np.int32)).to(dev)
        n = toks.shape[0]
        if n and int(toks.max()) >= sigma:
            raise ValueError(f"token id {int(toks.max())} >= sigma {sigma}")
        size = 1 << shard_bits
        num_shards = max(1, (n + size - 1) // size)
        pad = num_shards * size - n
        shards = F.pad(toks, (0, pad)).reshape(num_shards, size)

    # the shard axis is the builder's batch axis (the reference's vmap
    # mode of ``repro.data.shard_build``): one level of every shard is one
    # launch group
    stacked = build_wavelet_matrix(shards, sigma, tau=tau, big_step=big_step,
                                   sample_rate=sample_rate, device=dev)

    with obs.stage("store.histograms"):
        flat = (torch.arange(num_shards, device=dev)[:, None] * sigma
                + shards.long()).reshape(-1)
        hist = torch.bincount(flat, minlength=num_shards * sigma).reshape(
            num_shards, sigma)
        hist[-1, 0] -= pad
        cum = F.pad(torch.cumsum(hist, 0), (0, 0, 1, 0)).to(torch.int32)
    return CompressedCorpus(shards=stacked, shard_counts=cum, n=n,
                            sigma=sigma, shard_bits=shard_bits)


def token_histogram(corpus: CompressedCorpus) -> torch.Tensor:
    """Global symbol frequencies (σ,) int32."""
    return corpus.shard_counts[-1]
