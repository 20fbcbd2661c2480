"""Blocked stable counting rank over digit rows: CUDA kernels + plain versions.

Replaces ``repro/kernels/radix_rank.py:radix_hist_pallas`` (``radix_hist``)
and ``radix_apply_pallas`` (``radix_apply``). The Pallas apply takes the
in-tile stable rank from a 1024 × (B+1) one-hot cumsum in VMEM; the CUDA
apply walks each tile with one warp in 32 ordered rounds, with
``__match_any_sync`` and a per-bucket counter in shared memory
(``csrc/bucket_rank.cuh``), so no one-hot exists. Between the launches
``ops.radix_rank`` turns the histograms into offsets in torch
(:func:`bucket_offsets`). Bound on the H100 by bytes: 4 B of digit in and
4 B of destination out per digit, plus the (tiles, B+1) histogram.

Positions past n carry the sentinel bucket B, as the reference pads them:
the histogram counts them in column B, and their destinations are never
written. Digits outside [0, B] read as the sentinel too.

The plain versions share ``bucket_hist_plain``/``bucket_apply_plain`` with
``wt_level``, whose level step is the same rank on (node, bit) keys.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build

BLOCK = 1024                  # digits per tile
MAX_BUCKETS = 512             # real buckets; column B is the sentinel


def tiled_keys(keys: torch.Tensor, n: int, num_buckets: int) -> torch.Tensor:
    """(R, nb·BLOCK) int64: the first n keys of each row, out-of-range keys
    and the padding past n set to the sentinel ``num_buckets``."""
    nb = (n + BLOCK - 1) // BLOCK
    k = keys[:, :n].long()
    k = torch.where((k < 0) | (k > num_buckets), num_buckets, k)
    return F.pad(k, (0, nb * BLOCK - n), value=num_buckets)


def _flat_tile_keys(k: torch.Tensor, nb1: int) -> torch.Tensor:
    tile = torch.arange(k.shape[1], device=k.device) // BLOCK
    return tile * nb1 + k


def bucket_hist_plain(k: torch.Tensor, nb1: int) -> torch.Tensor:
    """Per-tile histograms (R, nb, nb1) int32 of tiled keys ``k`` (R, N)."""
    rows, N = k.shape
    hist = torch.zeros((rows, N // BLOCK * nb1), dtype=torch.int32,
                       device=k.device)
    hist.scatter_add_(1, _flat_tile_keys(k, nb1),
                      torch.ones_like(k, dtype=torch.int32))
    return hist.reshape(rows, N // BLOCK, nb1)


def bucket_offsets(hist: torch.Tensor) -> torch.Tensor:
    """(R, nb, B+1) int32 offsets ``base[d] + across[tile, d]`` of per-tile
    histograms (R, nb, B+1): the bucket's start in its row plus its count in
    earlier tiles, i.e. the reference's two exclusive scans (over buckets,
    over tiles) added up. Laid out bucket-major, that sum is a single
    exclusive scan per row, one ``cumsum`` along the row: a scan over the
    tile axis of the (nb, B+1) layout would run each column's 2^17 tiles in
    sequence on the card. No sum crosses a row, so each stays under the
    row's nb·BLOCK padded length, whatever the number of rows."""
    rows, nb, nb1 = hist.shape
    flat = hist.transpose(1, 2).reshape(rows, nb1 * nb)
    excl = torch.cumsum(flat, 1, dtype=torch.int32) - flat
    return excl.reshape(rows, nb1, nb).transpose(1, 2).contiguous()


def bucket_apply_plain(k: torch.Tensor, offsets: torch.Tensor,
                       n: int) -> torch.Tensor:
    """(R, n) int32 destinations ``offsets[tile, key] + in-tile rank`` of
    tiled keys ``k``; the in-tile rank comes from a stable sort by (tile,
    key) and the histogram of those pairs."""
    rows, N = k.shape
    nb1 = offsets.shape[-1]
    flat = _flat_tile_keys(k, nb1)
    order = torch.argsort(flat, dim=1, stable=True)
    pos = torch.empty_like(order).scatter_(
        1, order, torch.arange(N, device=k.device).expand(rows, N))
    hist = bucket_hist_plain(k, nb1).reshape(rows, -1).long()
    group_start = torch.cumsum(hist, 1) - hist
    within = pos - torch.gather(group_start, 1, flat)
    dest = torch.gather(offsets.reshape(rows, -1).long(), 1, flat) + within
    return dest[:, :n].to(torch.int32)


def radix_hist_plain(digits: torch.Tensor, num_buckets: int,
                     n: int) -> torch.Tensor:
    """(R, ceil(n/BLOCK), B+1) int32 per-tile histograms, sentinel last."""
    return bucket_hist_plain(tiled_keys(digits, n, num_buckets),
                             num_buckets + 1)


def radix_apply_plain(digits: torch.Tensor, offsets: torch.Tensor,
                      num_buckets: int, n: int) -> torch.Tensor:
    """(R, n) int32 stable destinations given the per-tile bucket offsets
    (R, nb, B+1) of :func:`bucket_offsets`."""
    return bucket_apply_plain(tiled_keys(digits, n, num_buckets), offsets,
                              n)


def _check_digits(digits: torch.Tensor, num_buckets: int, n: int) -> None:
    if digits.dim() != 2 or digits.dtype != torch.int32:
        raise ValueError(f"digits must be (R, N) int32, got "
                         f"{tuple(digits.shape)} {digits.dtype}")
    if digits.shape[1] < n:
        raise ValueError(f"rows hold {digits.shape[1]} digits, need {n}")
    if not 1 <= num_buckets <= MAX_BUCKETS:
        raise ValueError(f"num_buckets {num_buckets} out of [1, "
                         f"{MAX_BUCKETS}]")
    if digits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {digits.device}")
    if digits.device.type == "cuda" and digits.stride(1) != 1:
        raise ValueError("digit rows must be contiguous")


def radix_hist(digits: torch.Tensor, num_buckets: int,
               n: int) -> torch.Tensor:
    """Count phase: the CUDA kernel for a CUDA tensor, else the plain
    version."""
    _check_digits(digits, num_buckets, n)
    if digits.device.type == "cpu":
        return radix_hist_plain(digits, num_buckets, n)
    rows, nb = digits.shape[0], (n + BLOCK - 1) // BLOCK
    hist = torch.empty((rows, nb, num_buckets + 1), dtype=torch.int32,
                       device=digits.device)
    lib = build.library("radix_rank")
    err = lib.radix_hist(digits.data_ptr(), rows, n, digits.stride(0),
                         num_buckets, hist.data_ptr(), nb,
                         torch.cuda.current_stream(digits.device).cuda_stream)
    build.launches["radix_rank"] += 1
    build.check(lib, err, "radix_hist")
    return hist


def radix_apply(digits: torch.Tensor, offsets: torch.Tensor,
                num_buckets: int, n: int) -> torch.Tensor:
    """Apply phase: the CUDA kernel for a CUDA tensor, else the plain
    version."""
    _check_digits(digits, num_buckets, n)
    rows, nb = digits.shape[0], (n + BLOCK - 1) // BLOCK
    if offsets.shape != (rows, nb, num_buckets + 1):
        raise ValueError(f"offsets {tuple(offsets.shape)} do not fit {rows} "
                         f"rows of {nb} tiles and {num_buckets} buckets")
    if digits.device.type == "cpu":
        return radix_apply_plain(digits, offsets, num_buckets, n)
    offsets = offsets.to(torch.int32).contiguous()
    dest = torch.empty((rows, n), dtype=torch.int32, device=digits.device)
    lib = build.library("radix_rank")
    err = lib.radix_apply(digits.data_ptr(), rows, n, digits.stride(0),
                          num_buckets, nb, offsets.data_ptr(),
                          dest.data_ptr(), dest.stride(0),
                          torch.cuda.current_stream(digits.device).cuda_stream)
    build.launches["radix_rank"] += 1
    build.check(lib, err, "radix_apply")
    return dest
