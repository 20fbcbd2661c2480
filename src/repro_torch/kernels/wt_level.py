"""One segmented wavelet-tree level over key rows: CUDA kernels + plain
versions.

Replaces ``repro/kernels/wt_level.py:wt_level_fused_pallas``. A tree level
splits every node's segment stably by the level bit, which is the stable
sort by bucket ``(nid << 1) | bit`` over nbkt = 2^(l+1) ≤ 512 buckets. The
Pallas form carries the per-block bucket histograms across a sequential
(2, nblocks) TPU grid in VMEM; CUDA blocks have no order, so the level is a
count launch (``wt_counts``), the offsets' scan in torch
(``ops.wt_level_step_fused``) and an apply launch (``wt_apply``) that also
writes the level bitmap from ``__ballot_sync`` (``csrc/wt_level.cu``, on the
blocked bucket rank of ``csrc/bucket_rank.cuh``). Bound on the H100 by
bytes: 8 B of key and node id in, 4 B of destination and 1/8 B of bitmap out
per key.

Positions past n carry the sentinel bucket nbkt, as the reference pads
them; their destinations are never written and their bitmap bits are zero.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import bitops

from . import build
from .radix_rank import BLOCK, bucket_apply_plain, bucket_hist_plain

MAX_KEYS = 512                # real (node, bit) buckets, 2^(l+1)


def _level_keys(sub: torch.Tensor, nid: torch.Tensor, shift: int, n: int,
                nbkt: int):
    """(bits (R, n), tiled keys (R, nb·BLOCK) int64 with the sentinel nbkt
    past n and for out-of-range keys)."""
    nb = (n + BLOCK - 1) // BLOCK
    bit = (bitops.u32(sub[:, :n]) >> shift) & 1
    key = (nid[:, :n].long() << 1) | bit
    key = torch.where((key < 0) | (key > nbkt), nbkt, key)
    return bit, F.pad(key, (0, nb * BLOCK - n), value=nbkt)


def wt_counts_plain(sub: torch.Tensor, nid: torch.Tensor, shift: int,
                    nbkt: int, n: int) -> torch.Tensor:
    """(R, ceil(n/BLOCK), nbkt+1) int32 per-tile bucket histograms."""
    return bucket_hist_plain(_level_keys(sub, nid, shift, n, nbkt)[1],
                             nbkt + 1)


def wt_apply_plain(sub: torch.Tensor, nid: torch.Tensor,
                   offsets: torch.Tensor, shift: int, nbkt: int, n: int):
    """(dest (R, n) int32, bitmap (R, ceil(n/32)) int32) given the per-tile
    bucket offsets (R, nb, nbkt+1) of ``radix_rank.bucket_offsets``."""
    bit, key = _level_keys(sub, nid, shift, n, nbkt)
    return (bucket_apply_plain(key, offsets, n),
            bitops.pack_bits(bitops.pad_bits(bit)))


def _check(sub: torch.Tensor, nid: torch.Tensor, shift: int, nbkt: int,
           n: int) -> None:
    for name, x in (("sub", sub), ("nid", nid)):
        if x.dim() != 2 or x.dtype != torch.int32:
            raise ValueError(f"{name} must be (R, N) int32, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.shape[1] < n:
            raise ValueError(f"{name} rows hold {x.shape[1]}, need {n}")
        if x.device.type == "cuda" and x.stride(1) != 1:
            raise ValueError(f"{name} rows must be contiguous")
    if sub.shape[0] != nid.shape[0] or sub.device != nid.device:
        raise ValueError("sub and nid must have the same rows and device")
    if not 0 <= shift < 32:
        raise ValueError(f"shift {shift} out of [0, 32)")
    if not 1 <= nbkt <= MAX_KEYS:
        raise ValueError(f"nbkt {nbkt} out of [1, {MAX_KEYS}]")
    if sub.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {sub.device}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def wt_counts(sub: torch.Tensor, nid: torch.Tensor, shift: int, nbkt: int,
              n: int) -> torch.Tensor:
    """Count phase: the CUDA kernel for CUDA tensors, else the plain
    version."""
    _check(sub, nid, shift, nbkt, n)
    if sub.device.type == "cpu":
        return wt_counts_plain(sub, nid, shift, nbkt, n)
    rows, nb = sub.shape[0], (n + BLOCK - 1) // BLOCK
    hist = torch.empty((rows, nb, nbkt + 1), dtype=torch.int32,
                       device=sub.device)
    lib = build.library("wt_level")
    err = lib.wt_counts(sub.data_ptr(), nid.data_ptr(), rows, n,
                        sub.stride(0), nid.stride(0), shift, nbkt,
                        hist.data_ptr(), nb, _stream(sub))
    build.launches["wt_level_step"] += 1
    build.check(lib, err, "wt_counts")
    return hist


def wt_apply(sub: torch.Tensor, nid: torch.Tensor, offsets: torch.Tensor,
             shift: int, nbkt: int, n: int):
    """Apply phase: the CUDA kernel for CUDA tensors, else the plain
    version."""
    _check(sub, nid, shift, nbkt, n)
    rows, nb = sub.shape[0], (n + BLOCK - 1) // BLOCK
    if offsets.shape != (rows, nb, nbkt + 1):
        raise ValueError(f"offsets {tuple(offsets.shape)} do not fit {rows} "
                         f"rows of {nb} tiles and {nbkt} buckets")
    if sub.device.type == "cpu":
        return wt_apply_plain(sub, nid, offsets, shift, nbkt, n)
    offsets = offsets.to(torch.int32).contiguous()
    W = bitops.num_words(n)
    dest = torch.empty((rows, n), dtype=torch.int32, device=sub.device)
    bitmap = torch.empty((rows, W), dtype=torch.int32, device=sub.device)
    lib = build.library("wt_level")
    err = lib.wt_apply(sub.data_ptr(), nid.data_ptr(), rows, n,
                       sub.stride(0), nid.stride(0), shift, nbkt, nb,
                       offsets.data_ptr(), dest.data_ptr(), dest.stride(0),
                       bitmap.data_ptr(), W, bitmap.stride(0),
                       _stream(sub))
    build.launches["wt_level_step"] += 1
    build.check(lib, err, "wt_apply")
    return dest, bitmap
