"""Jacobson rank directories of stacked bit rows: CUDA kernel + plain version.

Replaces ``repro/kernels/rank_build.py:rank_build_levels_pallas`` (and, at
one row, ``rank_build_pallas``). The kernel (``csrc/rank_build.cu``) is a
single-pass scan in place of the TPU's sequential grid: every row is cut
into tiles of ``TILE`` words, one block each, and the popcount carried into
a tile comes from a decoupled look-back over the row's earlier tiles
(``csrc/look_back.cuh``), so a few long rows spread over the whole card as
well as many short ones. Bound on the H100 by bytes: each word is read once
and 0.625 B of directory is written per word.
"""
from __future__ import annotations

import torch

from repro_torch.core import rank_select

from . import build

TILE = 16384                  # words per tile of the scan


def rank_build_levels_plain(words: torch.Tensor, W: int):
    """(superblock (R, ceil(W/32)) int32, block (R, ceil(W/4)) int16) over
    the first ``W`` words of every row of ``words`` (R, >=W) int32."""
    rs = rank_select.build_binary_rank(words[:, :W], W * 32)
    return rs.superblock, rs.block


def rank_build_levels(words: torch.Tensor, W: int):
    """Directories of the first ``W`` words of each row: the CUDA kernel for
    a CUDA tensor, the plain version for a CPU tensor."""
    if words.dim() != 2 or words.dtype != torch.int32:
        raise ValueError(f"words must be (R, W) int32, got "
                         f"{tuple(words.shape)} {words.dtype}")
    if words.shape[1] < W:
        raise ValueError(f"rows hold {words.shape[1]} words, need {W}")
    if words.device.type == "cpu":
        return rank_build_levels_plain(words, W)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    if words.stride(1) != 1:
        raise ValueError("words rows must be contiguous")
    rows = words.shape[0]
    nsb = (W + rank_select.SUPERBLOCK_WORDS - 1) // rank_select.SUPERBLOCK_WORDS
    nblk = (W + rank_select.BLOCK_WORDS - 1) // rank_select.BLOCK_WORDS
    superblock = torch.empty((rows, nsb), dtype=torch.int32,
                             device=words.device)
    block = torch.empty((rows, nblk), dtype=torch.int16, device=words.device)
    # one status word per tile, then the tile counter
    status = torch.zeros(rows * ((W + TILE - 1) // TILE) + 1,
                         dtype=torch.int64, device=words.device)
    lib = build.library("rank_build")
    err = lib.rank_build_levels(
        words.data_ptr(), rows, W, words.stride(0), superblock.data_ptr(),
        nsb, block.data_ptr(), nblk, status.data_ptr(),
        build.stream(words.device))
    build.count_launch("rank_build_levels")
    build.check(lib, err, "rank_build_levels")
    return superblock, block
