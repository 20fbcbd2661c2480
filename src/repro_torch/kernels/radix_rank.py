"""Stable counting rank over digit rows: CUDA kernels + plain versions.

Replaces ``repro/kernels/radix_rank.py:radix_hist_pallas`` and
``radix_apply_pallas``. A stable counting sort gives digit i of bucket d the
destination ``start[d]`` + (count of d in earlier tiles) + (count of d
earlier in i's tile). The build path (:func:`radix_rank`) is one sweep
(``csrc/radix_rank.cu``): given every row's bucket starts, one launch of
``radix_scan`` ranks each tile of ``TILE`` digits in-warp (32 ordered rounds
a warp) and takes the counts of earlier tiles from a decoupled look-back,
one 32-bit status word per (tile, bucket). Without the starts a
``radix_totals`` launch counts every row's buckets first and one small
``cumsum`` over (R, B) turns them into starts; nothing per digit runs in
torch. Bound on the H100 by bytes: 4 B of digit in and 4 B of destination
out per digit.

``radix_hist``/``radix_apply`` are the counterparts of the two Pallas phase
kernels, off the build path: per-1,024-digit-tile histograms, their offsets
in torch (:func:`bucket_offsets`), and an apply launch that walks each tile
with one warp in 32 ordered rounds (``csrc/bucket_rank.cuh``).

Positions past n are never written. Digits outside [0, B) read as the
sentinel bucket B: the phase kernels sort them after every real digit (the
histogram counts them, and the padding past n, in column B), while the
one-sweep rank gives them -1.

The plain versions share ``bucket_hist_plain``/``bucket_apply_plain`` with
``wt_level``, whose plain level step is the same rank on (node, bit) keys.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build

BLOCK = 1024                  # digits per tile of the phase kernels
MAX_BUCKETS = 512             # real buckets; column B is the sentinel
TILE = 8192                   # digits per tile of the one-sweep scan
MAX_ROW = 1 << 30             # the scan's status words count in 30 bits


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


def radix_totals_plain(digits: torch.Tensor, num_buckets: int,
                       n: int) -> torch.Tensor:
    """(R, B) int32 count of every real bucket among each row's first n
    digits."""
    d = digits[:, :n].long()
    d = torch.where((d < 0) | (d > num_buckets), num_buckets, d)
    hist = torch.zeros((d.shape[0], num_buckets + 1), dtype=torch.int32,
                       device=d.device)
    hist.scatter_add_(1, d, torch.ones_like(d, dtype=torch.int32))
    return hist[:, :num_buckets].contiguous()


def exclusive_starts(totals: torch.Tensor) -> torch.Tensor:
    """(R, B) int32 bucket starts: the exclusive scan of each row's
    totals."""
    return torch.cumsum(totals, 1, dtype=torch.int32) - totals


def radix_rank_plain(digits: torch.Tensor, num_buckets: int, n: int,
                     bucket_starts: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """(R, n) int32 stable destinations from the phases' plain versions
    (per-tile histograms, their offsets, the in-tile rank), with
    ``bucket_starts`` (R, B) as the bucket bases when given; -1 for digits
    outside [0, B)."""
    k = tiled_keys(digits, n, num_buckets)
    offsets = bucket_offsets(bucket_hist_plain(k, num_buckets + 1))
    if bucket_starts is not None:
        counted = offsets[:, :1]               # tile 0: the bucket bases
        given = torch.cat([bucket_starts.to(offsets.dtype),
                           counted[:, 0, num_buckets:]], 1)
        offsets = offsets - counted + given[:, None]
    dest = bucket_apply_plain(k, offsets, n)
    return torch.where(k[:, :n] < num_buckets, dest, -1).to(torch.int32)


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
                         build.stream(digits.device))
    build.count_launch("radix_rank")
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
                          build.stream(digits.device))
    build.count_launch("radix_rank")
    build.check(lib, err, "radix_apply")
    return dest


def _check_starts(bucket_starts: torch.Tensor, digits: torch.Tensor,
                  num_buckets: int) -> None:
    want = (digits.shape[0], num_buckets)
    if (bucket_starts.dtype != torch.int32 or bucket_starts.shape != want
            or bucket_starts.device != digits.device):
        raise ValueError(f"bucket_starts must be {want} int32 on "
                         f"{digits.device}, got {tuple(bucket_starts.shape)} "
                         f"{bucket_starts.dtype} on {bucket_starts.device}")
    if digits.device.type == "cuda" and bucket_starts.stride(1) != 1:
        raise ValueError("bucket_starts rows must be contiguous")


def radix_totals(digits: torch.Tensor, num_buckets: int,
                 n: int) -> torch.Tensor:
    """Bucket totals (R, B) int32 of each row's first n digits: the CUDA
    kernel for a CUDA tensor, else the plain version."""
    _check_digits(digits, num_buckets, n)
    if digits.device.type == "cpu":
        return radix_totals_plain(digits, num_buckets, n)
    totals = torch.zeros((digits.shape[0], num_buckets), dtype=torch.int32,
                         device=digits.device)
    lib = build.library("radix_rank")
    err = lib.radix_totals(digits.data_ptr(), digits.shape[0], n,
                           digits.stride(0), num_buckets, totals.data_ptr(),
                           build.stream(digits.device))
    build.count_launch("radix_rank")
    build.check(lib, err, "radix_totals")
    return totals


def radix_scan(digits: torch.Tensor, num_buckets: int, n: int,
               bucket_starts: torch.Tensor) -> torch.Tensor:
    """(R, n) int32 stable destinations given every row's bucket starts
    (R, B) int32: one launch of the one-sweep scan for a CUDA tensor, else
    the plain version."""
    _check_digits(digits, num_buckets, n)
    _check_starts(bucket_starts, digits, num_buckets)
    if n >= MAX_ROW:
        raise ValueError(f"rows of {n} digits: the scan takes fewer than "
                         f"{MAX_ROW}")
    if digits.device.type == "cpu":
        return radix_rank_plain(digits, num_buckets, n, bucket_starts)
    rows = digits.shape[0]
    tiles = rows * ((n + TILE - 1) // TILE)
    # one status word per (tile, bucket), then the tile counter
    status = torch.zeros(tiles * num_buckets + 1, dtype=torch.int32,
                         device=digits.device)
    dest = torch.empty((rows, n), dtype=torch.int32, device=digits.device)
    lib = build.library("radix_rank")
    err = lib.radix_scan(digits.data_ptr(), rows, n, digits.stride(0),
                         num_buckets, bucket_starts.data_ptr(),
                         bucket_starts.stride(0), dest.data_ptr(),
                         dest.stride(0), status.data_ptr(),
                         build.stream(digits.device))
    build.count_launch("radix_rank")
    build.check(lib, err, "radix_scan")
    return dest


def radix_rank(digits: torch.Tensor, num_buckets: int, n: int,
               bucket_starts: torch.Tensor | None = None) -> torch.Tensor:
    """(R, n) int32 stable destinations of each row's first n digits.
    ``bucket_starts`` (R, B) int32: where each bucket starts in its row's
    output (the exclusive scan of the row's histogram); given, one
    :func:`radix_scan` launch; else :func:`radix_totals` first. The plain
    version for a CPU tensor."""
    _check_digits(digits, num_buckets, n)
    if bucket_starts is not None:
        _check_starts(bucket_starts, digits, num_buckets)
    if digits.device.type == "cpu":
        return radix_rank_plain(digits, num_buckets, n, bucket_starts)
    if bucket_starts is None:
        bucket_starts = exclusive_starts(radix_totals(digits, num_buckets, n))
    return radix_scan(digits, num_buckets, n, bucket_starts)
