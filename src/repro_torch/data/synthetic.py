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


def corpus_region(n_tokens: int, vocab_size: int, start: int, length: int,
                  seed: int = 0, exponent: float = 1.1,
                  doc_len: int = 1024, eos_id: int = 0) -> np.ndarray:
    """Regenerate ``[start, start+length)`` of a corpus without making the
    rest: a counter-mode generator (Philox) keyed on each aligned 64k
    block, so every block is reproducible on its own. The reference's
    stream of blocks (not :func:`make_corpus`'s stream)."""
    block = 65536
    out = np.empty(length, np.uint32)
    p = zipf_probs(vocab_size, exponent)
    ids = np.random.default_rng(seed).permutation(vocab_size)
    b0, b1 = start // block, (start + length - 1) // block
    for b in range(b0, b1 + 1):
        rng = np.random.default_rng(np.random.Philox(key=seed + (b << 20)))
        blk = ids[rng.choice(vocab_size, size=block, p=p)].astype(np.uint32)
        gstart = b * block
        idx = np.arange(gstart, gstart + block)
        blk[(idx % doc_len) == doc_len - 1] = eos_id
        lo = max(start, gstart)
        hi = min(start + length, gstart + block)
        out[lo - start:hi - start] = blk[lo - gstart:hi - gstart]
    return out
