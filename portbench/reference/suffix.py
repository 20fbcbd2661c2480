"""The plain reference of an FM index over text shards: suffix arrays by
prefix doubling on ``torch.sort``, the BWT, the C table, the sampled
suffix array and the seam windows, in plain torch and numpy.

Convention (that of infini-gram-style indexes built on a terminated
text): raw symbols c are stored as c + 1 and each shard's text ends in a
unique terminator 0, the smallest symbol; a suffix that runs past the end
compares smaller than any that does not.
"""
from __future__ import annotations

import numpy as np
import torch

SHIFT = 1            # raw symbol c is stored as c + 1; the terminator is 0


def terminated(shards: torch.Tensor) -> torch.Tensor:
    """(R, n) raw symbols -> (R, n + 1) int64 texts with the terminator."""
    rows = shards.shape[0]
    end = torch.zeros((rows, 1), dtype=torch.int64, device=shards.device)
    return torch.cat([shards.long() + SHIFT, end], 1)


def suffix_arrays(text: torch.Tensor, max_rounds: int | None = None):
    """(R, m) int64 suffix array of each row of ``text`` (R, m) int64 and
    the number of doubling rounds it took. ``max_rounds`` stops the
    doubling early (the control): ties then stay in text order."""
    rows, m = text.shape
    rank = text.clone()
    i = torch.arange(m, device=text.device)
    sa = None
    rounds, offset = 0, 1
    while True:
        nxt = torch.where(i + offset < m,
                          rank[:, (i + offset).clamp(max=m - 1)] + 1, 0)
        key = rank * (int(rank.max()) + 2) + nxt
        key, sa = torch.sort(key, dim=1, stable=True)
        new = torch.zeros_like(key)
        new[:, 1:] = torch.cumsum(key[:, 1:] != key[:, :-1], 1)
        rank = torch.empty_like(new).scatter_(1, sa, new)
        rounds += 1
        offset *= 2
        if bool((new[:, -1] == m - 1).all()) or offset >= m:
            break
        if max_rounds is not None and rounds >= max_rounds:
            break
    return sa, rounds


def bwt(text: torch.Tensor, sa: torch.Tensor) -> torch.Tensor:
    """bwt[j] = text[(sa[j] - 1) mod m] of each row."""
    m = text.shape[1]
    return text.gather(1, (sa - 1) % m)


def c_table(text: torch.Tensor, alphabet: int) -> torch.Tensor:
    """(R, alphabet + 1) int32: C[c] = the symbols of the row below c, for
    c = 0..alphabet (C[alphabet] = the row's length)."""
    rows, m = text.shape
    hist = torch.zeros((rows, alphabet), dtype=torch.int64,
                       device=text.device)
    hist.scatter_add_(1, text, torch.ones_like(text))
    c = torch.zeros((rows, alphabet + 1), dtype=torch.int64,
                    device=text.device)
    c[:, 1:] = torch.cumsum(hist, 1)
    return c.to(torch.int32)


def sa_samples(sa: torch.Tensor, rate: int):
    """(marked bits (R, m), the marked rows' suffix array values in row
    order (R, ceil(m / rate)) int32): row j is marked where sa[j] is a
    multiple of ``rate``."""
    marked = (sa % rate == 0).long()
    rows = sa.shape[0]
    values = sa[marked == 1].view(rows, -1).to(torch.int32)
    return marked, values


def seam_windows(tokens: np.ndarray, shards: int, size: int,
                 half: int, pad: int) -> np.ndarray:
    """(shards - 1, 2 * half) raw tokens around each inner shard border,
    ``pad`` outside the stream."""
    n = len(tokens)
    out = np.full((max(0, shards - 1), 2 * half), pad, np.int64)
    for s in range(1, shards):
        for j in range(2 * half):
            g = s * size - half + j
            if 0 <= g < n:
                out[s - 1, j] = tokens[g]
    return out
