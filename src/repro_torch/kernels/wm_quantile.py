"""Global range quantile over stacked wavelet-matrix shards: CUDA kernel +
plain versions.

Replaces ``repro/kernels/wm_quantile.py:wm_quantile_sharded_pallas`` (and,
at one shard, ``wm_quantile_pallas``). The Pallas form keeps every shard's
directories resident in VMEM. On the H100 they stay in global memory, so
the descent is bound by its dependent, scattered rank probes. In the kernel
(``csrc/wm_quantile.cu``) a warp deals the (shard, endpoint) probes of a
query's covered shards to its lanes and issues a level's loads together:
one round trip to memory a level, whatever the shard count.

The operands (:class:`QuantileOperands`) are fixed once per engine: the
stored directories read in place, and on the card the C entry's arguments
and the grid. Each stream that launches the kernel gets its own scratch,
allocated on that stream at its first launch and kept with the operands:
launches on one stream run one after another and reuse it, launches on
several streams share no buffer. A
copy of the directories cut into 32-byte "rank lines", one sector a
probe, was no faster on the H100 (within 1-3%, ``launch/sweep_quantile.py``,
which keeps that layout as a variant).

``wm_quantile_sharded_plain`` is the plain descent on the directories,
the kernel's plain version.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import torch

from repro_torch.core.rank_select import BLOCK_WORDS, BinaryRank, rank1

from . import build

#: the work model's units (:func:`quantile_work`): a 32-byte sector, the
#: least a rank probe can fetch, covers 224 positions in the rank-line
#: layout (seven words of bits after a count, ``launch/sweep_quantile.py``);
#: a probe counts as 40 int32 operations, as ``chip_smoke.py``'s bound has
#: counted it since the kernel's first port.
SECTOR_BYTES = 32
SECTOR_BITS = 224
PROBE_OPS = 40


@dataclass(frozen=True)
class QuantileOperands:
    """The kernel's operands for S stacked shards, fixed once per engine.

    The directories flattened to (S·nbits, ·) rows, row ``s*nbits + l``
    holding level l of shard s: ``words`` int32 (rows of whole 16-byte
    blocks, at least ``nblocks``·4 words), ``superblock`` int32, ``block``
    int16, ``zeros`` (S·nbits,) int32. On the card ``launch_args`` holds
    the C entry's per-engine arguments, ``max_blocks`` the grid that fills
    the card once, ``over`` the probes of a query too wide for the kernel's
    registers that each resident warp keeps in scratch, and
    ``scratch_elems`` the int32 scratch a launch needs (2·over a resident
    warp), held in ``scratch`` for each stream that launched.
    """
    words: torch.Tensor
    superblock: torch.Tensor
    block: torch.Tensor
    zeros: torch.Tensor
    num_shards: int
    nbits: int
    n: int
    shard_bits: int
    launch_args: tuple = ()
    max_blocks: int = 0
    over: int = 0
    scratch_elems: int = 0
    #: raw stream handle -> that stream's scratch (:func:`_scratch`)
    scratch: dict = field(default_factory=dict, repr=False, compare=False)
    #: raw stream handle -> that stream's global scratch of the greedy
    #: top-k (``topk_greedy._scratch``), for frontiers past shared memory
    greedy_scratch: dict = field(default_factory=dict, repr=False,
                                 compare=False)

    @property
    def nblocks(self) -> int:
        return self.block.shape[1]


def kernel_info(lib) -> dict:
    """Registers, local bytes, resident blocks per SM and the compiled
    constants of the quantile kernel in ``lib``."""
    a = (ctypes.c_int * 5)()
    build.check(lib, lib.wm_quantile_info(a), "wm_quantile_info")
    keys = ("registers", "local_bytes", "blocks_per_sm", "warps_per_block",
            "register_probes")
    return dict(zip(keys, a))


def launch_shape(info: dict, num_shards: int, device) -> tuple[int, int]:
    """(max_blocks, over): the grid that fills the card once, and the probes
    each warp keeps in scratch so that no query's probes are dropped."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    max_blocks = max(1, info["blocks_per_sm"]) * sms
    over = max(0, 2 * num_shards - info["register_probes"])
    return max_blocks, over


def quantile_operands(words, superblock, block, zeros, *, num_shards: int,
                      nbits: int, n: int,
                      shard_bits: int) -> QuantileOperands:
    """Check the flattened directories once and, on a CUDA device, size the
    kernel's grid and scratch. ``words`` must already hold whole 16-byte
    blocks (``ops.quantile_operands`` pads them)."""
    rows = num_shards * nbits
    for name, t, dt in (("words", words, torch.int32),
                        ("superblock", superblock, torch.int32),
                        ("block", block, torch.int16)):
        if t.dim() != 2 or t.shape[0] != rows or t.dtype != dt:
            raise ValueError(f"{name} must be ({rows}, *) {dt}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"{name} rows must be contiguous")
    nblocks = block.shape[1]
    if (nblocks < 1 or words.shape[1] < nblocks * BLOCK_WORDS
            or words.stride(0) % 4 or words.data_ptr() % 16):
        raise ValueError(f"words rows must be 16-byte aligned and hold "
                         f"{nblocks} blocks of {BLOCK_WORDS} words")
    if zeros.shape != (rows,) or zeros.dtype != torch.int32:
        raise ValueError(f"zeros must be ({rows},) int32")
    if not 0 <= shard_bits <= 30 or not 0 <= n <= num_shards << shard_bits:
        raise ValueError(f"n {n} does not fit {num_shards} shards of "
                         f"2^{shard_bits}")
    zeros = zeros.contiguous()
    base = dict(words=words, superblock=superblock, block=block, zeros=zeros,
                num_shards=num_shards, nbits=nbits, n=n,
                shard_bits=shard_bits)
    if words.device.type != "cuda":
        return QuantileOperands(**base)
    info = kernel_info(build.library("wm_quantile"))
    max_blocks, over = launch_shape(info, num_shards, words.device)
    args = (words.data_ptr(), words.stride(0), superblock.data_ptr(),
            superblock.stride(0), block.data_ptr(), block.stride(0), nblocks,
            zeros.data_ptr(), num_shards, nbits, n, shard_bits)
    return QuantileOperands(
        **base, launch_args=args, max_blocks=max_blocks, over=over,
        scratch_elems=max_blocks * info["warps_per_block"] * 2 * over)


def _local_ranges(lo, hi, k, num_shards: int, n: int, shard_bits: int):
    """Clamped per-shard ranges (S, Q) int64, every query's clamped k and
    its total."""
    size = 1 << shard_bits
    glo = lo.long().clamp(0, n)
    ghi = torch.maximum(hi.long().clamp(max=n), glo)
    base = (torch.arange(num_shards, device=lo.device) << shard_bits)[:, None]
    los = (glo[None] - base).clamp(0, size)
    his = (ghi[None] - base).clamp(0, size)
    total = (his - los).sum(0)
    k = torch.minimum(k.long().clamp(min=0), (total - 1).clamp(min=0))
    return los, his, k, total


def descend(rank_at, op: QuantileOperands, lo, hi, k) -> torch.Tensor:
    """Count-then-refine descent over the shards of ``op``; ``rank_at(l,
    pos)`` is rank1 on level l of every shard at (S, Q) positions."""
    dev = op.zeros.device
    lo, hi, k = (_queries(x, dev) for x in (lo, hi, k))
    los, his, k, total = _local_ranges(lo, hi, k, op.num_shards, op.n,
                                       op.shard_bits)
    z2 = op.zeros.reshape(op.num_shards, op.nbits).long()
    sym = torch.zeros_like(k)
    for l in range(op.nbits):
        lo0 = los - rank_at(l, los)
        hi0 = his - rank_at(l, his)
        z = (hi0 - lo0).sum(0)
        bit = k >= z
        sym = (sym << 1) | bit.long()
        k = torch.where(bit, k - z, k)
        zl = z2[:, l, None]
        los = torch.where(bit, zl + los - lo0, lo0)
        his = torch.where(bit, zl + his - hi0, hi0)
    return torch.where(total <= 0, -1, sym).to(torch.int32)


def _plain_rank_at(op: QuantileOperands):
    """``rank_at(l, pos)`` of :func:`descend` in plain torch on the
    operands' directories."""
    S, nbits, size = op.num_shards, op.nbits, 1 << op.shard_bits
    w3 = op.words.reshape(S, nbits, -1)
    sb3 = op.superblock.reshape(S, nbits, -1)
    b3 = op.block.reshape(S, nbits, -1)

    def rank_at(l, pos):
        return rank1(BinaryRank(words=w3[:, l], superblock=sb3[:, l],
                                block=b3[:, l], n=size), pos)
    return rank_at


def wm_quantile_sharded_plain(op: QuantileOperands, lo, hi,
                              k) -> torch.Tensor:
    """The kernel's plain version: the count-then-refine descent in plain
    torch on the operands' directories. (Q,) int32, -1 if empty."""
    return descend(_plain_rank_at(op), op, lo, hi, k)


def quantile_work(op: QuantileOperands, lo, hi, k) -> tuple[int, int]:
    """(bytes, int32 operations) that a batch's descent needs, counted on
    this batch's data (the work model of ``obs.prof``): each query's lo,
    hi, k and answer (16 bytes), one ``SECTOR_BYTES`` sector for every
    distinct sector of ``SECTOR_BITS`` positions that its live rank probes
    fall in (probes that share a sector need it from memory once), and
    ``PROBE_OPS`` operations a probe. A probe is live where a shard's local
    range at that level is not empty. Runs the plain descent once."""
    plain = _plain_rank_at(op)
    calls = []

    def rank_at(l, pos):
        calls.append((l, pos))
        return plain(l, pos)

    q = descend(rank_at, op, lo, hi, k).shape[0]
    per_row = (1 << op.shard_bits) // SECTOR_BITS + 1
    first_row = torch.arange(op.num_shards, device=op.zeros.device)[:, None]
    probes, keys = 0, []
    for (l, los), (_, his) in zip(calls[::2], calls[1::2]):
        live = his > los
        probes += 2 * int(live.sum())
        row = (first_row * op.nbits + l).expand_as(los)[live] * per_row
        keys += [row + los[live] // SECTOR_BITS,
                 row + his[live] // SECTOR_BITS]
    sectors = int(torch.unique(torch.cat(keys)).numel()) if keys else 0
    return q * 16 + sectors * SECTOR_BYTES, probes * PROBE_OPS


def _queries(x, device) -> torch.Tensor:
    """(Q,) contiguous int32 on ``device``; a batch that already is one
    passes through without a cast (the serving path's common case)."""
    if (isinstance(x, torch.Tensor) and x.dtype == torch.int32
            and x.device == device and x.dim() == 1 and x.is_contiguous()):
        return x
    return torch.as_tensor(x, device=device).to(torch.int32).reshape(
        -1).contiguous()


def _scratch(op: QuantileOperands, stream: int, dev) -> int:
    """The address of ``stream``'s scratch in ``op``: allocated on that
    stream at its first launch, then reused by its later launches, which
    the stream orders after the earlier ones."""
    buf = op.scratch.get(stream)
    if buf is None:
        buf = op.scratch[stream] = torch.empty(
            (op.scratch_elems,), dtype=torch.int32, device=dev)
    return buf.data_ptr()


def wm_quantile_sharded(op: QuantileOperands, lo, hi, k) -> torch.Tensor:
    """(Q,) int32 quantiles of global [lo, hi) at rank k, -1 if empty: the
    CUDA kernel for operands on the card, the plain descent for operands on
    the CPU. A batch costs its query casts, one launch and the output;
    everything else was fixed by :func:`quantile_operands` (the scratch
    for queries over more than 48 shards at a stream's first launch)."""
    dev = op.words.device
    lo, hi, k = (_queries(x, dev) for x in (lo, hi, k))
    q = lo.shape[0]
    if hi.shape != (q,) or k.shape != (q,):
        raise ValueError(f"lo, hi and k must have one length, got "
                         f"{q}, {hi.shape[0]}, {k.shape[0]}")
    if dev.type == "cpu":
        return wm_quantile_sharded_plain(op, lo, hi, k)
    if dev.type != "cuda" or not op.launch_args:
        raise ValueError(f"no kernel operands for directories on {dev}")
    out = torch.empty_like(lo)
    stream = build.stream(dev)
    lib = build.library("wm_quantile")
    err = lib.wm_quantile_sharded(
        lo.data_ptr(), hi.data_ptr(), k.data_ptr(), q, *op.launch_args,
        _scratch(op, stream, dev) if op.over else None, op.over,
        op.max_blocks, out.data_ptr(), stream)
    build.count_launch("wm_quantile_sharded")
    build.check(lib, err, "wm_quantile_sharded")
    return out
