"""Global range quantile over stacked wavelet-matrix shards: CUDA kernel +
plain version.

Replaces ``repro/kernels/wm_quantile.py:wm_quantile_sharded_pallas`` (and,
at one shard, ``wm_quantile_pallas``). The Pallas form keeps every shard's
directories resident in VMEM; on the H100 they stay in global memory, one
warp answers one query with the shards spread over its lanes, and
``__shfl_xor_sync`` sums each level's zero counts (``csrc/wm_quantile.cu``).
Bound on the H100 by bytes: each rank probe reads a superblock entry, a
block entry and four words, as scattered 32-byte sectors.

Inputs are the stacked directories flattened to (S·nbits, ·) rows, row
``s*nbits + l`` holding level l of shard s, as ``ops._pad_rank_rows``
lays them out.
"""
from __future__ import annotations

import torch

from repro_torch.core.rank_select import BinaryRank, rank1

from . import build


def wm_quantile_sharded_plain(lo, hi, k, words, superblock, block, zeros, *,
                              num_shards: int, nbits: int, n: int,
                              shard_bits: int, nblocks: int) -> torch.Tensor:
    """Count-then-refine descent in plain torch: (Q,) int32, -1 if empty."""
    S, size = num_shards, 1 << shard_bits
    w3 = words.reshape(S, nbits, -1)
    sb3 = superblock.reshape(S, nbits, -1)
    b3 = block.reshape(S, nbits, -1)[..., :nblocks]
    z2 = zeros.reshape(S, nbits).long()
    glo = lo.long().clamp(0, n)
    ghi = torch.maximum(hi.long().clamp(max=n), glo)
    base = (torch.arange(S, device=lo.device) << shard_bits)[:, None]
    los = (glo[None] - base).clamp(0, size)
    his = (ghi[None] - base).clamp(0, size)
    total = (his - los).sum(0)
    k = torch.minimum(k.long().clamp(min=0), (total - 1).clamp(min=0))
    sym = torch.zeros_like(k)
    for l in range(nbits):
        rs = BinaryRank(words=w3[:, l], superblock=sb3[:, l], block=b3[:, l],
                        n=size)
        lo0 = los - rank1(rs, los)
        hi0 = his - rank1(rs, his)
        z = (hi0 - lo0).sum(0)
        bit = k >= z
        sym = (sym << 1) | bit.long()
        k = torch.where(bit, k - z, k)
        zl = z2[:, l, None]
        los = torch.where(bit, zl + los - lo0, lo0)
        his = torch.where(bit, zl + his - hi0, hi0)
    return torch.where(total <= 0, -1, sym).to(torch.int32)


def wm_quantile_sharded(lo, hi, k, words, superblock, block, zeros, *,
                        num_shards: int, nbits: int, n: int, shard_bits: int,
                        nblocks: int) -> torch.Tensor:
    """(Q,) int32 quantiles: the CUDA kernel for CUDA tensors, else the plain
    version. ``lo``/``hi``/``k``: (Q,) int32; ``words`` (S·nbits, >=
    nblocks·4) int32; ``superblock`` int32; ``block`` int16; ``zeros``
    (S·nbits,) int32."""
    rows = num_shards * nbits
    for name, t, dt in (("words", words, torch.int32),
                        ("superblock", superblock, torch.int32),
                        ("block", block, torch.int16)):
        if t.dim() != 2 or t.shape[0] != rows or t.dtype != dt:
            raise ValueError(f"{name} must be ({rows}, *) {dt}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if words.shape[1] < nblocks * 4 or block.shape[1] < nblocks:
        raise ValueError("words rows must hold nblocks*4 words")
    if zeros.shape != (rows,) or zeros.dtype != torch.int32:
        raise ValueError(f"zeros must be ({rows},) int32")
    q = lo.shape[0]
    for name, t in (("lo", lo), ("hi", hi), ("k", k)):
        if t.shape != (q,) or t.dtype != torch.int32:
            raise ValueError(f"{name} must be ({q},) int32")
    if words.device.type == "cpu":
        return wm_quantile_sharded_plain(
            lo, hi, k, words, superblock, block, zeros, num_shards=num_shards,
            nbits=nbits, n=n, shard_bits=shard_bits, nblocks=nblocks)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    if (words.stride(1) != 1 or words.stride(0) % 4
            or words.data_ptr() % 16):
        raise ValueError("words rows must be contiguous, 16-byte aligned")
    if superblock.stride(1) != 1 or block.stride(1) != 1:
        raise ValueError("directory rows must be contiguous")
    lo, hi, k, zeros = (t.contiguous() for t in (lo, hi, k, zeros))
    lib = build.library("wm_quantile")
    max_shards = lib.wm_quantile_max_shards()
    if num_shards > max_shards:
        raise ValueError(f"{num_shards} shards exceed the kernel's "
                         f"{max_shards}")
    out = torch.empty((q,), dtype=torch.int32, device=words.device)
    err = lib.wm_quantile_sharded(
        lo.data_ptr(), hi.data_ptr(), k.data_ptr(), q,
        words.data_ptr(), words.stride(0),
        superblock.data_ptr(), superblock.stride(0),
        block.data_ptr(), block.stride(0), zeros.data_ptr(),
        num_shards, nbits, n, shard_bits, nblocks, out.data_ptr(),
        torch.cuda.current_stream(words.device).cuda_stream)
    build.launches["wm_quantile_sharded"] += 1
    build.check(lib, err, "wm_quantile_sharded")
    return out
