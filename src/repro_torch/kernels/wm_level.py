"""One wavelet-matrix level over stacked key rows: CUDA kernel + plain version.

Replaces ``repro/kernels/wm_level.py:wm_level_fused_pallas``; its two
phases also serve the contracts of ``wm_counts_pallas`` and
``wm_apply_pallas``. The fused Pallas form carries the per-block zero counts
across a sequential TPU grid; CUDA blocks have no order, so the level is a
count launch, a tiny torch scan (``ops.wm_level_step``) and an apply launch
(``csrc/wm_level.cu``). Bound on the H100 by bytes: 4 B of key in, 4 B of
destination and 1/8 B of bitmap out per key.

Keys past ``n`` read as ones, as the reference pads them: they sort after
every real key, their destinations are never written, and their bitmap
bits are zero.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import bitops

from . import build

BLOCK = 1024                  # keys per block of the count/apply phases


def _level_bits(keys: torch.Tensor, shift: int, n: int) -> torch.Tensor:
    """(R, nb, BLOCK) bits of the first n keys, ones past n."""
    nb = (n + BLOCK - 1) // BLOCK
    bit = (bitops.u32(keys[:, :n]) >> shift) & 1
    return F.pad(bit, (0, nb * BLOCK - n), value=1).reshape(-1, nb, BLOCK)


def wm_counts_plain(keys: torch.Tensor, shift: int, n: int) -> torch.Tensor:
    """Zeros per BLOCK keys of every row: (R, ceil(n/BLOCK)) int32."""
    return (BLOCK - _level_bits(keys, shift, n).sum(-1)).to(torch.int32)


def wm_apply_plain(keys: torch.Tensor, zeros_excl: torch.Tensor,
                   total_zeros: torch.Tensor, shift: int, n: int):
    """(dest (R, n) int32, bitmap (R, ceil(n/32)) int32) given the exclusive
    per-block zero offsets (R, nb) and the row totals (R,)."""
    bit = _level_bits(keys, shift, n)
    rows, nb, _ = bit.shape
    zl = 1 - bit
    zeros_local = torch.cumsum(zl, -1) - zl
    ones_local = torch.arange(BLOCK, device=keys.device) - zeros_local
    zb = zeros_excl.long()[..., None]
    ones_before = (torch.arange(nb, device=keys.device)[:, None] * BLOCK - zb)
    dest = torch.where(bit == 0, zb + zeros_local,
                       total_zeros.long()[:, None, None] + ones_before
                       + ones_local)
    dest = dest.reshape(rows, -1)[:, :n].to(torch.int32)
    gidx = torch.arange(nb * BLOCK, device=keys.device)
    bm_bit = torch.where(gidx < n, bit.reshape(rows, -1), 0)
    bitmap = bitops.pack_bits(bm_bit)[:, :bitops.num_words(n)]
    return dest, bitmap


def _check_keys(keys: torch.Tensor, shift: int, n: int) -> None:
    if keys.dim() != 2 or keys.dtype != torch.int32:
        raise ValueError(f"keys must be (R, N) int32, got "
                         f"{tuple(keys.shape)} {keys.dtype}")
    if keys.shape[1] < n:
        raise ValueError(f"rows hold {keys.shape[1]} keys, need {n}")
    if not 0 <= shift < 32:
        raise ValueError(f"shift {shift} out of [0, 32)")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {keys.device}")
    if keys.device.type == "cuda" and keys.stride(1) != 1:
        raise ValueError("key rows must be contiguous")


def wm_counts(keys: torch.Tensor, shift: int, n: int) -> torch.Tensor:
    """Count phase: the CUDA kernel for a CUDA tensor, else the plain
    version."""
    _check_keys(keys, shift, n)
    if keys.device.type == "cpu":
        return wm_counts_plain(keys, shift, n)
    rows, nb = keys.shape[0], (n + BLOCK - 1) // BLOCK
    counts = torch.empty((rows, nb), dtype=torch.int32, device=keys.device)
    lib = build.library("wm_level")
    err = lib.wm_counts(keys.data_ptr(), rows, n, keys.stride(0), shift,
                        counts.data_ptr(), nb,
                        torch.cuda.current_stream(keys.device).cuda_stream)
    build.launches["wm_level_step"] += 1
    build.check(lib, err, "wm_counts")
    return counts


def wm_apply(keys: torch.Tensor, zeros_excl: torch.Tensor,
             total_zeros: torch.Tensor, shift: int, n: int):
    """Apply phase: the CUDA kernel for a CUDA tensor, else the plain
    version."""
    _check_keys(keys, shift, n)
    rows, nb = keys.shape[0], (n + BLOCK - 1) // BLOCK
    if zeros_excl.shape != (rows, nb) or total_zeros.shape != (rows,):
        raise ValueError(f"offsets {tuple(zeros_excl.shape)} / totals "
                         f"{tuple(total_zeros.shape)} do not fit "
                         f"{rows} rows of {nb} blocks")
    if keys.device.type == "cpu":
        return wm_apply_plain(keys, zeros_excl, total_zeros, shift, n)
    zeros_excl = zeros_excl.to(torch.int32).contiguous()
    total_zeros = total_zeros.to(torch.int32).contiguous()
    W = bitops.num_words(n)
    dest = torch.empty((rows, n), dtype=torch.int32, device=keys.device)
    bitmap = torch.empty((rows, W), dtype=torch.int32, device=keys.device)
    lib = build.library("wm_level")
    err = lib.wm_apply(keys.data_ptr(), rows, n, keys.stride(0), shift, nb,
                       zeros_excl.data_ptr(), total_zeros.data_ptr(),
                       dest.data_ptr(), dest.stride(0), bitmap.data_ptr(), W,
                       bitmap.stride(0),
                       torch.cuda.current_stream(keys.device).cuda_stream)
    build.launches["wm_level_step"] += 1
    build.check(lib, err, "wm_apply")
    return dest, bitmap
