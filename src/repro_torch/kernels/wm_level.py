"""One wavelet-matrix level over stacked key rows: CUDA kernels + plain
versions.

Replaces ``repro/kernels/wm_level.py:wm_level_fused_pallas`` with one
launch per level (:func:`wm_level`, ``wm_level_scan`` in
``csrc/wm_level.cu``): a single-pass zero scan with decoupled look-back
(``csrc/zero_scan.cuh``) that places every key given its row's total
zeros. A level's zero count does not change when the row is permuted, so
the build counts the zeros of every level of every row once, before the
first level (:func:`wm_level_zeros`, one launch over its input). Bound on
the H100 by bytes: 4 B of key in, 4 B of destination and 1/8 B of bitmap
out per key.

:func:`wm_level_move` is the same launch in the scan's move mode
(``wm_level_move``): it writes each key to its destination instead of the
destination, so a build moves a level's keys without a destination array,
a scatter or an int64 index. Its bound is the dest mode's, with 4 B of
moved key in place of the destination.

``wm_counts`` and ``wm_apply`` are the counterparts of the reference's two
phase kernels ``wm_counts_pallas`` and ``wm_apply_pallas``; no build calls
them. In both a warp owns one block of ``BLOCK`` keys, read with the zero
scan's 16-byte loads: ``wm_counts`` adds the popcounts of its level bits,
``wm_apply`` runs the zero scan's warp half with no look-back, its base the
block's own exclusive offset. The plain version of a level is those two
phases with a torch scan between them.

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
TILE = 8192                   # keys per tile of the zero scan


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


def wm_level_zeros_plain(keys: torch.Tensor, lo: int, width: int,
                         n: int) -> torch.Tensor:
    """(R, width) int32: column j holds the zeros of bit ``lo + width - 1 -
    j`` among the first n keys of each row (level order: the top bit
    first)."""
    k = bitops.u32(keys[:, :n])
    return torch.stack([n - ((k >> b) & 1).sum(-1)
                        for b in range(lo + width - 1, lo - 1, -1)],
                       -1).to(torch.int32)


def wm_level_plain(keys: torch.Tensor, total_zeros: torch.Tensor,
                   shift: int, n: int):
    """(dest (R, n), bitmap (R, ceil(n/32)), counted zeros (R,)) int32 of
    one level, the ones placed after the given ``total_zeros`` (R,): the
    count and apply phases with an exclusive scan of the block counts."""
    counts = wm_counts_plain(keys, shift, n)
    incl = torch.cumsum(counts, 1)
    dest, bitmap = wm_apply_plain(keys, (incl - counts).to(torch.int32),
                                  total_zeros, shift, n)
    return dest, bitmap, incl[:, -1].to(torch.int32)


def wm_level_move_plain(keys: torch.Tensor, total_zeros: torch.Tensor,
                        shift: int, n: int):
    """(moved keys (R, n), bitmap (R, ceil(n/32)), counted zeros (R,))
    int32: :func:`wm_level_plain`'s destinations applied to the first n keys
    of each row by a scatter."""
    dest, bitmap, zeros = wm_level_plain(keys, total_zeros, shift, n)
    k = keys[:, :n]
    return torch.empty_like(k).scatter_(1, dest.long(), k), bitmap, zeros


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
                        build.stream(keys.device))
    build.count_launch("wm_level_step")
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
                       build.stream(keys.device))
    build.count_launch("wm_level_step")
    build.check(lib, err, "wm_apply")
    return dest, bitmap


def _check_totals(total_zeros: torch.Tensor, keys: torch.Tensor) -> None:
    if (total_zeros.shape != (keys.shape[0],)
            or total_zeros.dtype != torch.int32
            or total_zeros.device != keys.device):
        raise ValueError(f"total_zeros must be ({keys.shape[0]},) int32 on "
                         f"{keys.device}, got {tuple(total_zeros.shape)} "
                         f"{total_zeros.dtype} on {total_zeros.device}")


def wm_level_zeros(keys: torch.Tensor, lo: int, width: int,
                   n: int) -> torch.Tensor:
    """Zeros of bits ``lo + width - 1`` down to ``lo`` in each row, (R,
    width) int32 in level order: the CUDA kernel for a CUDA tensor (one
    launch), else the plain version."""
    _check_keys(keys, lo, n)
    if not 1 <= width <= 32 - lo:
        raise ValueError(f"bits [{lo}, {lo + width}) out of [0, 32)")
    if keys.device.type == "cpu":
        return wm_level_zeros_plain(keys, lo, width, n)
    out = torch.zeros((keys.shape[0], width), dtype=torch.int32,
                      device=keys.device)
    lib = build.library("wm_level")
    stream = build.stream(keys.device)
    err = lib.wm_level_zeros(keys.data_ptr(), keys.shape[0], n,
                             keys.stride(0), lo, width, out.data_ptr(),
                             stream)
    build.count_launch("wm_level_step")
    build.check(lib, err, "wm_level_zeros")
    return out


def _level_scan(entry: str, keys: torch.Tensor, total_zeros: torch.Tensor,
                shift: int, n: int):
    """One launch of the C entry ``entry`` (``wm_level_scan`` or
    ``wm_level_move``) on CUDA tensors: (out (R, n), bitmap, zeros)."""
    rows, W = keys.shape[0], bitops.num_words(n)
    tiles = rows * ((n + TILE - 1) // TILE)
    status = torch.zeros(tiles + 1, dtype=torch.int64, device=keys.device)
    out = torch.empty((rows, n), dtype=torch.int32, device=keys.device)
    bitmap = torch.empty((rows, W), dtype=torch.int32, device=keys.device)
    zeros = torch.empty(rows, dtype=torch.int32, device=keys.device)
    lib = build.library("wm_level")
    err = getattr(lib, entry)(keys.data_ptr(), rows, n, keys.stride(0), shift,
                              total_zeros.data_ptr(), total_zeros.stride(0),
                              zeros.data_ptr(), out.data_ptr(), out.stride(0),
                              bitmap.data_ptr(), W, bitmap.stride(0),
                              status.data_ptr(), build.stream(keys.device))
    build.count_launch("wm_level_step")
    build.check(lib, err, entry)
    return out, bitmap, zeros


def wm_level(keys: torch.Tensor, total_zeros: torch.Tensor, shift: int,
             n: int):
    """One level given each row's total zeros (R,) int32 (any stride):
    (dest (R, n), bitmap (R, ceil(n/32)), the zeros the level counted (R,))
    int32. One launch of the zero scan for a CUDA tensor, else the plain
    version."""
    _check_keys(keys, shift, n)
    _check_totals(total_zeros, keys)
    if keys.device.type == "cpu":
        return wm_level_plain(keys, total_zeros, shift, n)
    return _level_scan("wm_level_scan", keys, total_zeros, shift, n)


def wm_level_move(keys: torch.Tensor, total_zeros: torch.Tensor, shift: int,
                  n: int):
    """One level that moves its own keys, given each row's total zeros
    (R,) int32 (any stride): (moved keys (R, n), bitmap (R, ceil(n/32)),
    the zeros the level counted (R,)) int32, row r of the moved keys the
    level's stable 0/1 partition of the first n keys of row r. One launch
    of the zero scan's move mode for a CUDA tensor, into a new array (the
    caller drops its input, whose memory the next level's output takes),
    else the plain version."""
    _check_keys(keys, shift, n)
    _check_totals(total_zeros, keys)
    if keys.device.type == "cpu":
        return wm_level_move_plain(keys, total_zeros, shift, n)
    return _level_scan("wm_level_move", keys, total_zeros, shift, n)
