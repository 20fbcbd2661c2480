"""Query-pattern sampling shared by the index CLI and ``chip_smoke.py``
(the port's own copy of ``repro.index.patterns``: numpy only, the same
patterns for the same seed).

Draws padded fixed-width pattern batches from a token stream: mostly real
substrings (at least one match each) with an optional fraction of random
patterns (miss-heavy traffic). Lengths are clamped to the corpus so
degenerate configs (pattern budget longer than the text) stay valid.
"""
from __future__ import annotations

import numpy as np


def sample_patterns(toks: np.ndarray, num: int, max_len: int, pad: int,
                    seed: int = 1, miss_every: int | None = 4,
                    min_len: int = 1):
    """(num, max_len) int32 padded patterns + (num,) true lengths.

    Every ``miss_every``-th pattern is uniform-random over the observed
    vocabulary (usually a miss); the rest are substrings of ``toks``.
    ``miss_every=None`` samples substrings only.
    """
    rng = np.random.default_rng(seed)
    pats = np.full((num, max_len), pad, np.int32)
    lens = rng.integers(min_len, max_len + 1, num).astype(np.int32)
    lens = np.minimum(lens, max(1, len(toks) - 1))
    vocab = int(toks.max()) + 1
    for i in range(num):
        if miss_every is not None and i % miss_every == miss_every - 1:
            pats[i, :lens[i]] = rng.integers(0, vocab, lens[i])
        else:
            s = int(rng.integers(0, len(toks) - lens[i]))
            pats[i, :lens[i]] = toks[s:s + lens[i]]
    return pats, lens
