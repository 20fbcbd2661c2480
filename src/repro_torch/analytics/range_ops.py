"""Range queries over a wavelet matrix (port of the quantile and count half
of ``repro.analytics.range_ops``).

Each op descends the ``nbits`` levels with two rank0 probes per level, so a
query costs O(logσ) directory lookups whatever the range width. Position
ranges ``[lo, hi)`` and symbol ranges ``[sym_lo, sym_hi)`` are half-open.
A matrix with leading batch axes (stacked shards) takes per-row query
arrays of shape (*B, *Q).
"""
from __future__ import annotations

import torch

from repro_torch.core.wavelet_matrix import (WaveletMatrix, wm_child_interval,
                                             wm_interval_zeros)


def _arg(x, wm: WaveletMatrix) -> torch.Tensor:
    return torch.as_tensor(x, device=wm.zeros.device).long()


def _clip_range(wm: WaveletMatrix, lo, hi):
    lo = _arg(lo, wm).clamp(0, wm.n)
    hi = torch.maximum(_arg(hi, wm).clamp(0, wm.n), lo)
    return lo, hi


def range_quantile(wm: WaveletMatrix, lo, hi, k) -> torch.Tensor:
    """k-th smallest symbol (0-based) among positions [lo, hi); k clamps
    into [0, hi-lo), an empty range gives -1. int32."""
    lo, hi = _clip_range(wm, lo, hi)
    lo, hi, k = torch.broadcast_tensors(lo, hi, _arg(k, wm))
    k = torch.minimum(k.clamp(min=0), (hi - lo - 1).clamp(min=0))
    empty = hi <= lo
    sym = torch.zeros_like(lo)
    for l in range(wm.nbits):
        lo0, hi0 = wm_interval_zeros(wm, l, lo, hi)
        z = hi0 - lo0
        bit = (k >= z).long()
        sym = (sym << 1) | bit
        k = torch.where(bit == 1, k - z, k)
        lo, hi = wm_child_interval(wm, l, lo, hi, bit, lo0, hi0)
    return torch.where(empty, -1, sym).to(torch.int32)


def _count_below(wm: WaveletMatrix, lo: torch.Tensor, hi: torch.Tensor,
                 sym) -> torch.Tensor:
    """# of positions in [lo, hi) whose symbol is < sym (sym clamped to
    [0, 2^nbits]): where sym's bit is 1, the zero branch is all smaller."""
    top = 1 << wm.nbits
    s = _arg(sym, wm).clamp(0, top)
    full = s >= top
    total = hi - lo
    acc = torch.zeros_like(lo)
    for l in range(wm.nbits):
        bit = (s >> (wm.nbits - 1 - l)) & 1
        lo0, hi0 = wm_interval_zeros(wm, l, lo, hi)
        acc = acc + torch.where(bit == 1, hi0 - lo0, 0)
        lo, hi = wm_child_interval(wm, l, lo, hi, bit, lo0, hi0)
    return torch.where(full, total, acc)


def range_count(wm: WaveletMatrix, lo, hi, sym_lo, sym_hi) -> torch.Tensor:
    """# of positions in [lo, hi) whose symbol lies in [sym_lo, sym_hi).
    int32."""
    lo, hi = _clip_range(wm, lo, hi)
    below_hi = _count_below(wm, lo, hi, sym_hi)
    below_lo = _count_below(wm, lo, hi, sym_lo)
    return (below_hi - below_lo).clamp(min=0).to(torch.int32)
