"""Burrows–Wheeler transform + C[] boundary table from the suffix array
(port of ``repro.index.bwt``).

Given the suffix array of ``T·$`` ($ = unique smallest terminator), the BWT
is one gather, ``bwt[j] = T$[(sa[j] − 1) mod m]``, and the C table (``C[c]``
= # of symbols < c) a histogram and an exclusive prefix sum.

Alphabet convention of the whole index: raw symbols in [0, σ) are shifted
up by one and the terminator takes id 0, so the working alphabet is
[0, σ] and the wavelet matrix over the BWT has ⌈log₂(σ+1)⌉ levels.

Every function takes rows (*B, n) and works on each row, as the reference
does under ``vmap``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.core.scan import exclusive_sum, take
from repro_torch.device import resolve_device

from .suffix_array import suffix_array

#: raw symbol c is stored as c + SENTINEL_SHIFT; the terminator is 0.
SENTINEL_SHIFT = 1


def append_sentinel(seq: torch.Tensor) -> torch.Tensor:
    """``T → T'·$`` on each row: shift symbols up by one, append
    terminator id 0. ``int32``."""
    return F.pad(seq.to(torch.int32) + SENTINEL_SHIFT, (0, 1))


def bwt_from_sa(text: torch.Tensor, sa: torch.Tensor) -> torch.Tensor:
    """``bwt[j] = text[(sa[j] - 1) mod len(text)]`` per row."""
    m = text.shape[-1]
    prev = torch.where(sa == 0, m - 1, sa.long() - 1)
    return take(text, prev)


def symbol_boundaries(text: torch.Tensor, sigma_work: int) -> torch.Tensor:
    """C table of each row over the working alphabet: ``C[c]`` = # of
    symbols < c, shape (*B, sigma_work + 1) ``int32``; ``C[sigma_work]`` =
    m. Symbols outside [0, sigma_work) are not counted in the histogram
    (the reference drops them). One flat ``bincount`` with a row offset."""
    lead = text.shape[:-1]
    rows = int(np.prod(lead, dtype=np.int64))
    t = text.reshape(rows, -1).long()
    ok = (t >= 0) & (t < sigma_work)
    base = torch.arange(rows, device=t.device)[:, None] * sigma_work
    flat = torch.where(ok, base + t, rows * sigma_work).reshape(-1)
    hist = torch.bincount(flat, minlength=rows * sigma_work + 1)
    hist = hist[:rows * sigma_work].reshape(rows, sigma_work)
    C = F.pad(exclusive_sum(hist), (0, 1), value=text.shape[-1])
    return C.to(torch.int32).reshape(lead + (sigma_work + 1,))


def bwt_encode(seq, sigma: int | None = None, *, backend: str = "counting",
               use_kernel: bool | None = None,
               device: str | torch.device = "cuda"):
    """Full BWT pipeline for raw symbols in [0, σ), rows (n,) or (*B, n)
    moved to ``device``. Returns ``(bwt, sa, C)`` over the working alphabet
    [0, σ]: ``sa`` the suffix array of the terminated text (length n+1),
    ``bwt`` its Burrows–Wheeler transform, ``C`` the (σ+2,)-entry
    boundary table, each row's own."""
    dev = resolve_device(device)
    seq = torch.as_tensor(seq, device=dev)
    if sigma is None:
        sigma = int(seq.max()) + 1 if seq.numel() else 1
    sigma_work = sigma + SENTINEL_SHIFT
    text = append_sentinel(seq)
    sa = suffix_array(text, sigma_work, backend=backend,
                      use_kernel=use_kernel, device=dev)
    with obs.stage("bwt.gather"):
        bwt = bwt_from_sa(text, sa)
    with obs.stage("bwt.c_table"):
        C = symbol_boundaries(text, sigma_work)
    return bwt, sa, C


def bwt_decode(bwt, C) -> np.ndarray:
    """Invert one row's BWT by repeated LF-mapping: a numpy oracle, O(m)
    steps in sequence (for tests and round-trip checks, not serving).
    Returns the raw symbols as ``int32``."""
    b = np.asarray(bwt.cpu() if isinstance(bwt, torch.Tensor) else bwt
                   ).astype(np.int64)
    Cn = np.asarray(C.cpu() if isinstance(C, torch.Tensor) else C
                    ).astype(np.int64)
    m = len(b)
    # occ[j] = # of b[j] among b[:j]: j's place in a stable sort of b,
    # less the symbols smaller than b[j]
    place = np.empty(m, np.int64)
    place[np.argsort(b, kind="stable")] = np.arange(m)
    smaller = np.searchsorted(np.sort(b), b)
    lf = (Cn[b] + place - smaller).tolist()
    sym = b.tolist()
    out = np.empty(m, np.int64)
    j = 0                              # row of the terminator-rotated text
    for t in range(m - 1, -1, -1):
        out[t] = sym[j]
        j = lf[j]
    # out is T'·$ rotated so $ is last; strip terminator, undo the shift
    return (out[out != 0] - SENTINEL_SHIFT).astype(np.int32)
