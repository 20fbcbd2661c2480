"""Synthetic corpus generation (deterministic, Zipfian token statistics).

The port's own copy of ``repro.data.synthetic``: numpy only, and the same
stream for the same seed.
"""
from __future__ import annotations

import numpy as np


def zipf_probs(vocab_size: int, exponent: float = 1.1) -> np.ndarray:
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    p = ranks ** (-exponent)
    return p / p.sum()


def make_corpus(n_tokens: int, vocab_size: int, seed: int = 0,
                exponent: float = 1.1, doc_len: int = 1024,
                eos_id: int = 0) -> np.ndarray:
    """Zipfian token stream with a document separator every ``doc_len``.

    Token ids are assigned by shuffled rank, so frequency is not correlated
    with id value (as with real tokenizers).
    """
    rng = np.random.default_rng(seed)
    p = zipf_probs(vocab_size, exponent)
    ids = rng.permutation(vocab_size)
    draws = rng.choice(vocab_size, size=n_tokens, p=p)
    toks = ids[draws].astype(np.uint32)
    toks[doc_len - 1::doc_len] = eos_id
    return toks
