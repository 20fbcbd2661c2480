"""Global range count over stacked wavelet-matrix shards: CUDA kernel +
plain version.

No Pallas counterpart: the reference counts through XLA (two count-below
descents a shard, ``repro.analytics.range_ops.range_count``). The port's
plain torch form of those descents is about 1,800 launches a serving batch
on the H100; the kernel (``csrc/wm_count.cu``) deals a query's shards 16
to a warp, lo and hi of a shard on neighbouring lanes, probes once a level
while the two bounds' bits agree and not at all for a bound whose answer
is known (at most 0, at least 2^nbits), and sums the shards' counts by
warp reductions, a block a query.

Both take the quantile kernel's operands
(:class:`~repro_torch.kernels.wm_quantile.QuantileOperands`, the engine's
``quantile``) and (Q, S) local ranges, masked shards already emptied.
``wm_count_plain`` is ``range_ops.range_count`` on the operands'
directories viewed as the stacked shards, summed over the shards: the
kernel's plain version, which the wrapper takes for operands on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core.rank_select import BinaryRank, BitVector
from repro_torch.core.wavelet_matrix import WaveletMatrix

from . import build
from .wm_quantile import QuantileOperands


def wm_count_plain(op: QuantileOperands, los: torch.Tensor,
                   his: torch.Tensor, sym_lo: torch.Tensor,
                   sym_hi: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: per shard, ``range_ops.range_count`` of
    its local range (the positions whose symbol is in [sym_lo, sym_hi)),
    summed over the shards. ``los``/``his`` (Q, S), ``sym_lo``/``sym_hi``
    (Q,) or scalars; (Q,) int32."""
    from repro_torch.analytics import range_ops
    S, nbits, size = op.num_shards, op.nbits, 1 << op.shard_bits
    rank = BinaryRank(words=op.words.reshape(S, nbits, -1),
                      superblock=op.superblock.reshape(S, nbits, -1),
                      block=op.block.reshape(S, nbits, -1), n=size)
    shards = WaveletMatrix(
        bitvectors=BitVector(rank=rank, sel1=None, sel0=None),
        zeros=op.zeros.reshape(S, nbits), n=size, nbits=nbits)
    per = range_ops.range_count(shards, los.T, his.T, sym_lo, sym_hi)
    return per.long().sum(0).to(torch.int32)


def wm_count_sharded(op: QuantileOperands, los: torch.Tensor,
                     his: torch.Tensor, sym_lo: torch.Tensor,
                     sym_hi: torch.Tensor) -> torch.Tensor:
    """(Q,) int32 counts of the symbols in [sym_lo, sym_hi) within the
    (Q, S) local ranges ``los``/``his`` of the shards of ``op``: the CUDA
    kernel for operands on the card (one launch), the plain version for
    operands on the CPU."""
    dev = op.words.device
    Q, S = los.shape
    if his.shape != (Q, S) or S != op.num_shards:
        raise ValueError(f"los and his must be (Q, {op.num_shards}), got "
                         f"{tuple(los.shape)} and {tuple(his.shape)}")
    if dev.type == "cpu":
        return wm_count_plain(op, los, his, sym_lo, sym_hi)
    if dev.type != "cuda" or not op.launch_args:
        raise ValueError(f"no kernel operands for directories on {dev}")
    los, his = (x.to(device=dev, dtype=torch.int32).contiguous()
                for x in (los, his))
    sym_lo, sym_hi = (torch.as_tensor(x, device=dev).to(torch.int32)
                      .broadcast_to((Q,)).contiguous()
                      for x in (sym_lo, sym_hi))
    out = torch.empty((Q,), dtype=torch.int32, device=dev)
    lib = build.library("wm_count")
    err = lib.wm_count_sharded(
        los.data_ptr(), his.data_ptr(), sym_lo.data_ptr(), sym_hi.data_ptr(),
        Q, S, op.words.data_ptr(), op.words.stride(0),
        op.superblock.data_ptr(), op.superblock.stride(0),
        op.block.data_ptr(), op.block.stride(0), op.nblocks,
        op.zeros.data_ptr(), op.nbits, out.data_ptr(),
        build.stream(dev))
    build.count_launch("wm_count")
    build.check(lib, err, "wm_count_sharded")
    return out
