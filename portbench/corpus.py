"""The benchmark's inputs, made from ``--seed``: token corpora and range
query batches.

``make_tokens`` is ``make_corpus``' arithmetic (``repro_torch.data
.synthetic``: Zipfian draws, ids by shuffled rank, an end-of-document id
closing every document) rewritten in torch on the card: a few large calls
on one seeded ``torch.Generator`` of the device, where the numpy original
takes 19 s on the host for 2^27 tokens. The same seed gives the same
tokens on the same device. ``make_queries`` is a copy of
``repro_torch.launch.analytics.make_queries``: the reference's query mix.
"""
from __future__ import annotations

import numpy as np
import torch


def substream(seed: int, *path: int) -> int:
    """A 63-bit seed for the stream ``path`` of ``seed`` (any whole number
    that numpy's ``SeedSequence`` takes, past 32 bits too)."""
    state = np.random.SeedSequence([int(seed), *path]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def zipf_cdf(vocab: int, exponent: float, device) -> torch.Tensor:
    """The cumulative Zipf distribution over ranks 1..vocab, float64."""
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    p = ranks ** (-exponent)
    cdf = torch.cumsum(p / p.sum(), 0)
    cdf[-1] = 1.0
    return cdf


def make_tokens(cfg: dict, seed: int, device) -> torch.Tensor:
    """(n_tokens,) int32 tokens of a configuration's corpus on ``device``.

    ``cfg`` keys: ``n_tokens``, ``vocab_size``, ``zipf_exponent``,
    ``doc_len``, ``eos_id``.
    """
    n, vocab = int(cfg["n_tokens"]), int(cfg["vocab_size"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    ids = torch.randperm(vocab, generator=gen, device=device)
    u = torch.rand(n, generator=gen, dtype=torch.float64, device=device)
    cdf = zipf_cdf(vocab, float(cfg["zipf_exponent"]), device)
    draws = torch.searchsorted(cdf, u).clamp_(max=vocab - 1)
    del u
    toks = ids[draws].to(torch.int32)
    del draws
    doc = int(cfg["doc_len"])
    toks[doc - 1::doc] = int(cfg["eos_id"])
    return toks


def make_queries(n: int, num: int, seed: int, narrow_share: float = 0.5,
                 narrow_max: int = 256, wide_div: int = 4):
    """(lo, hi, k) int32 numpy batches: mixed narrow/wide ranges over the
    corpus (the reference's query mix, same stream for the same seed):
    ``narrow_share`` of the ranges 1 to ``narrow_max`` - 1 tokens wide, the
    rest ``narrow_max`` to n / ``wide_div``; k uniform in the range."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, max(1, n - 1), num).astype(np.int32)
    width = np.where(rng.random(num) < narrow_share,
                     rng.integers(1, narrow_max, num),
                     rng.integers(narrow_max, max(2 * narrow_max,
                                                  n // wide_div), num))
    hi = np.minimum(lo + width, n).astype(np.int32)
    k = rng.integers(0, np.maximum(hi - lo, 1)).astype(np.int32)
    return lo, hi, k
