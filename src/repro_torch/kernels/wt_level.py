"""One segmented wavelet-tree level over key rows: CUDA kernel + plain
version.

Replaces ``repro/kernels/wt_level.py:wt_level_fused_pallas``. A tree level
splits every node's segment stably by the level bit, which is the stable
sort by bucket ``(nid << 1) | bit`` over nbkt = 2^(l+1) ≤ 512 buckets. The
Pallas form carries per-block bucket histograms across a sequential
(2, nblocks) TPU grid. The CUDA form is one launch (:func:`wt_level`,
``wt_level_scan`` in ``csrc/wt_level.cu``): the single-pass zero scan of
``csrc/zero_scan.cuh``, which needs no histogram because the bucket starts
are known before the level (the tree build has them in its node offsets).
Node ids are non-decreasing, so nodes are contiguous; with node v's zeros
starting at ``s0``, its ones at ``s1`` and ``zs`` zeros in earlier nodes
(:func:`node_table`), a key with ``Z`` zeros before it in its row goes to
``s0 + (Z - zs)`` if its bit is 0, else to ``s1 + (i - s0) - (Z - zs)``.
Bound on the H100 by bytes: 8 B of key and node id in, 4 B of destination
and 1/8 B of bitmap out per key.

The plain version is independent of that formula: per-tile bucket
histograms, their offsets (``radix_rank.bucket_offsets``) and a stable
in-tile rank, with the given bucket starts in place of the counted bases.
Positions past n carry the sentinel bucket nbkt there, as the reference
pads them; their destinations are never written and their bitmap bits are
zero.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import bitops

from . import build
from .radix_rank import (BLOCK, bucket_apply_plain, bucket_hist_plain,
                         bucket_offsets)

MAX_KEYS = 512                # real (node, bit) buckets, 2^(l+1)
TILE = 8192                   # keys per tile of the zero scan


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


def bucket_starts_plain(sub: torch.Tensor, nid: torch.Tensor, shift: int,
                        nbkt: int, n: int) -> torch.Tensor:
    """(R, nbkt) int32 start of every (node, bit) bucket in each row's
    level order, from one bucket count per row."""
    rows = sub.shape[0]
    _, key = _level_keys(sub, nid, shift, n, nbkt)
    hist = torch.zeros((rows, nbkt + 1), dtype=torch.int64, device=sub.device)
    hist.scatter_add_(1, key, torch.ones_like(key))
    return (torch.cumsum(hist, 1) - hist)[:, :nbkt].to(torch.int32)


def node_table(bucket_starts: torch.Tensor) -> torch.Tensor:
    """(R, 3, nbkt/2) int32 table of the zero scan from the bucket starts
    (R, nbkt): per node v, ``s0`` = start of bucket 2v (its zeros), ``s1`` =
    start of bucket 2v+1 (its ones) and ``zs`` = the zeros of nodes before
    v, an exclusive scan of ``s1 - s0``."""
    s = bucket_starts.long()
    s0, s1 = s[:, 0::2], s[:, 1::2]
    zeros = s1 - s0
    return torch.stack([s0, s1, torch.cumsum(zeros, 1) - zeros],
                       1).to(torch.int32)


def wt_level_plain(sub: torch.Tensor, nid: torch.Tensor, shift: int,
                   nbkt: int, n: int, bucket_starts: torch.Tensor | None =
                   None):
    """(dest (R, n) int32, bitmap (R, ceil(n/32)) int32) of one level:
    per-tile histograms, their offsets and the in-tile rank, with
    ``bucket_starts`` (R, nbkt) as the bucket bases when given."""
    offsets = bucket_offsets(wt_counts_plain(sub, nid, shift, nbkt, n))
    if bucket_starts is not None:
        counted = offsets[:, :1]               # tile 0: the bucket bases
        given = torch.cat([bucket_starts.to(offsets.dtype),
                           counted[:, 0, nbkt:]], 1)
        offsets = offsets - counted + given[:, None]
    return wt_apply_plain(sub, nid, offsets, shift, nbkt, n)


def _check(sub: torch.Tensor, nid: torch.Tensor, shift: int, nbkt: int,
           n: int, bucket_starts: torch.Tensor | None) -> None:
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
    if not 2 <= nbkt <= MAX_KEYS or nbkt % 2:
        raise ValueError(f"nbkt {nbkt} must be even, in [2, {MAX_KEYS}]")
    if sub.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {sub.device}")
    if bucket_starts is not None and (
            bucket_starts.shape != (sub.shape[0], nbkt)
            or bucket_starts.device != sub.device):
        raise ValueError(f"bucket_starts {tuple(bucket_starts.shape)} on "
                         f"{bucket_starts.device} do not fit {sub.shape[0]} "
                         f"rows of {nbkt} buckets on {sub.device}")


def wt_level(sub: torch.Tensor, nid: torch.Tensor, shift: int, nbkt: int,
             n: int, bucket_starts: torch.Tensor | None = None):
    """One level of R rows: (dest (R, n), bitmap (R, ceil(n/32))) int32.
    Node ids are non-decreasing in [0, nbkt/2) per row; ``bucket_starts``
    (R, nbkt) are the level's bucket starts, counted here (off the build
    path) when not given. One launch of the zero scan for CUDA tensors,
    else the plain version."""
    _check(sub, nid, shift, nbkt, n, bucket_starts)
    if sub.device.type == "cpu":
        return wt_level_plain(sub, nid, shift, nbkt, n, bucket_starts)
    if bucket_starts is None:
        bucket_starts = bucket_starts_plain(sub, nid, shift, nbkt, n)
    table = node_table(bucket_starts).contiguous()
    rows, W = sub.shape[0], bitops.num_words(n)
    tiles = rows * ((n + TILE - 1) // TILE)
    status = torch.zeros(tiles + 1, dtype=torch.int64, device=sub.device)
    dest = torch.empty((rows, n), dtype=torch.int32, device=sub.device)
    bitmap = torch.empty((rows, W), dtype=torch.int32, device=sub.device)
    lib = build.library("wt_level")
    err = lib.wt_level_scan(sub.data_ptr(), nid.data_ptr(), rows, n,
                            sub.stride(0), nid.stride(0), shift,
                            table.data_ptr(), nbkt // 2, dest.data_ptr(),
                            dest.stride(0), bitmap.data_ptr(), W,
                            bitmap.stride(0), status.data_ptr(),
                            torch.cuda.current_stream(sub.device).cuda_stream)
    build.count_launch("wt_level_step")
    build.check(lib, err, "wt_level_scan")
    return dest, bitmap
