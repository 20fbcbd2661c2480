"""Greedy global range top-k over stacked wavelet-matrix shards: CUDA
kernel + plain version.

No Pallas counterpart: the reference runs the greedy frontier
(``repro.analytics.range_ops.topk_frontier``) as an XLA loop, and the
serving front-end runs it at ladder levels 1 and 2. Its plain torch
version here is a loop of eager ops, some 75 launches a round and a host
sync every eighth; in the kernel (``csrc/topk_greedy.cu``) a block runs a
query's whole frontier, a thread a shard, its slots' per-shard intervals
and fields in shared memory (in a per-block slice of a global scratch past
the 227 KB a block may hold on the H100: past about 100 pops over 128
shards), so that a split issues every shard's two rank probes at once. No
budget is refused. The global scratch is kept per stream on the operands
(``greedy_scratch``), grown to the largest launch it served.

Both take the quantile kernel's operands
(:class:`~repro_torch.kernels.wm_quantile.QuantileOperands`, the engine's
``quantile``): the same directories, row ``s*nbits + l`` holding level l
of shard s. ``topk_greedy_plain`` is ``range_ops.topk_frontier`` on those
rows, the kernel's plain version, which the wrapper takes for operands on
the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.rank_select import BinaryRank

from . import build
from .wm_quantile import QuantileOperands


def topk_greedy_plain(op: QuantileOperands, los: torch.Tensor,
                      his: torch.Tensor, k: int, budget: int | None = None,
                      prune: bool = True, pops: torch.Tensor | None = None):
    """The kernel's plain version: ``range_ops.topk_frontier`` over the
    operands' rows. ``los``/``his``: (Q, S) local ranges. Returns (syms
    (Q, k), counts (Q, k), found (Q,)) int32; ``pops`` as
    ``topk_frontier`` fills it."""
    from repro_torch.analytics import range_ops
    rows = (BinaryRank(words=op.words, superblock=op.superblock,
                       block=op.block, n=1 << op.shard_bits),
            op.zeros.long())
    return range_ops.topk_frontier(rows, op.nbits, los, his, k, budget,
                                   prune, pops)


def _scratch_elems(lib, Q: int, S: int, pops: int) -> int:
    """The int32 global scratch a launch needs (0 when its frontier fits a
    block's shared memory): ``topk_greedy_plan`` of the C entry, kept per
    shape."""
    key = (Q, S, pops)
    if key not in _plans:
        out = (ctypes.c_longlong * 4)()
        build.check(lib, lib.topk_greedy_plan(Q, S, pops, out),
                    "topk_greedy_plan")
        _plans[key] = int(out[0])
    return _plans[key]


def _scratch(op: QuantileOperands, stream: int, elems: int, dev) -> int:
    """The address of ``stream``'s global scratch in ``op``, of at least
    ``elems`` int32: allocated on that stream at its first launch that needs
    one (grown by a later, larger one), then reused by its later launches,
    which the stream orders after the earlier ones."""
    buf = op.greedy_scratch.get(stream)
    if buf is None or buf.numel() < elems:
        buf = op.greedy_scratch[stream] = torch.empty(
            (elems,), dtype=torch.int32, device=dev)
    return buf.data_ptr()


#: (Q, S, pops) -> int32 global scratch a launch needs
_plans: dict = {}


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
    pops = budget if budget is not None else topk_slot_budget(op.nbits,
                                                              k)[0]
    los = los.to(device=dev, dtype=torch.int32).contiguous()
    his = his.to(device=dev, dtype=torch.int32).contiguous()
    syms = torch.empty((Q, k), dtype=torch.int32, device=dev)
    cnts = torch.empty((Q, k), dtype=torch.int32, device=dev)
    found = torch.empty((Q,), dtype=torch.int32, device=dev)
    lib = build.library("topk_greedy")
    stream = build.stream(dev)
    elems = _scratch_elems(lib, Q, S, pops)
    scratch = _scratch(op, stream, elems, dev) if elems else None
    err = lib.topk_greedy(
        los.data_ptr(), his.data_ptr(), Q, S, op.words.data_ptr(),
        op.words.stride(0), op.superblock.data_ptr(),
        op.superblock.stride(0), op.block.data_ptr(), op.block.stride(0),
        op.nblocks, op.zeros.data_ptr(), op.nbits, k, pops, int(prune),
        scratch, elems, syms.data_ptr(), cnts.data_ptr(), found.data_ptr(),
        stream)
    build.count_launch("topk_greedy")
    build.check(lib, err, "topk_greedy")
    return syms, cnts, found
