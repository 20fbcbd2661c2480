"""Greedy global range top-k over stacked wavelet-matrix shards: CUDA
kernel + plain version.

No Pallas counterpart: the reference runs the greedy frontier
(``repro.analytics.range_ops.topk_frontier``) as an XLA loop, and the
serving front-end runs it at ladder levels 1 and 2. Its plain torch
version here is a loop of eager ops, some 75 launches a round and a host
sync every eighth; in the kernel (``csrc/topk_greedy.cu``) a warp runs a
query's whole frontier, its slots' weights, symbols and levels in shared
memory (in a global scratch slice past what a block may hold: budgets
over 7,263 pops on the H100) and their per-shard intervals in a global
scratch slice, and deals each split's shards over the lanes. No budget
is refused.

Both take the quantile kernel's operands
(:class:`~repro_torch.kernels.wm_quantile.QuantileOperands`, the engine's
``quantile``): the same directories, row ``s*nbits + l`` holding level l
of shard s. ``topk_greedy_plain`` is ``range_ops.topk_frontier`` on those
rows, the kernel's plain version, which the wrapper takes for operands on
the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core.rank_select import BinaryRank

from . import build
from .wm_quantile import QuantileOperands


def topk_greedy_plain(op: QuantileOperands, los: torch.Tensor,
                      his: torch.Tensor, k: int, budget: int | None = None,
                      prune: bool = True):
    """The kernel's plain version: ``range_ops.topk_frontier`` over the
    operands' rows. ``los``/``his``: (Q, S) local ranges. Returns (syms
    (Q, k), counts (Q, k), found (Q,)) int32."""
    from repro_torch.analytics import range_ops
    rows = (BinaryRank(words=op.words, superblock=op.superblock,
                       block=op.block, n=1 << op.shard_bits),
            op.zeros.long())
    return range_ops.topk_frontier(rows, op.nbits, los, his, k, budget,
                                   prune)


def topk_greedy(op: QuantileOperands, los: torch.Tensor, his: torch.Tensor,
                k: int, budget: int | None = None, prune: bool = True):
    """Greedy top-k of Q queries over the S shards of ``op``: ``los``/
    ``his`` (Q, S) local ranges; (syms (Q, k), counts (Q, k), found (Q,))
    int32, the contract of ``range_ops.topk_frontier``. The CUDA kernel for
    operands on the card (one launch), the plain version for operands on
    the CPU."""
    dev = op.words.device
    Q, S = los.shape
    if his.shape != (Q, S) or S != op.num_shards:
        raise ValueError(f"los and his must be (Q, {op.num_shards}), got "
                         f"{tuple(los.shape)} and {tuple(his.shape)}")
    if k <= 0:
        raise ValueError(f"k must be positive, got {k}")
    if dev.type == "cpu":
        return topk_greedy_plain(op, los, his, k, budget, prune)
    if dev.type != "cuda" or not op.launch_args:
        raise ValueError(f"no kernel operands for directories on {dev}")
    from repro_torch.analytics.range_ops import topk_slot_budget
    pops, cap = ((budget, 2 * budget + 1) if budget is not None
                 else topk_slot_budget(op.nbits, k))
    los = los.to(device=dev, dtype=torch.int32).contiguous()
    his = his.to(device=dev, dtype=torch.int32).contiguous()
    syms = torch.empty((Q, k), dtype=torch.int32, device=dev)
    cnts = torch.empty((Q, k), dtype=torch.int32, device=dev)
    found = torch.empty((Q,), dtype=torch.int32, device=dev)
    # per launch, stream-ordered: concurrent launches never share it; the
    # intervals, then room for the slot fields where shared memory is short
    scratch = torch.empty((max(Q, 1) * cap * (2 * S + 4),),
                          dtype=torch.int32, device=dev)
    lib = build.library("topk_greedy")
    err = lib.topk_greedy(
        los.data_ptr(), his.data_ptr(), Q, S, op.words.data_ptr(),
        op.words.stride(0), op.superblock.data_ptr(),
        op.superblock.stride(0), op.block.data_ptr(), op.block.stride(0),
        op.nblocks, op.zeros.data_ptr(), op.nbits, k, pops, int(prune),
        scratch.data_ptr(), syms.data_ptr(), cnts.data_ptr(),
        found.data_ptr(), build.stream(dev))
    build.count_launch("topk_greedy")
    build.check(lib, err, "topk_greedy")
    return syms, cnts, found
