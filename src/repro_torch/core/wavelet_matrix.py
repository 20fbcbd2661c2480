"""Wavelet matrix construction (paper Section 4, Theorem 4.5) and queries
(port of ``repro.core.wavelet_matrix``).

τ-chunk construction: each τ-bit field of the symbols is split level by
level with stable 0/1 partitions of the narrow field ("short lists"), and
the full-width symbols move once per chunk by the composition of those
partitions (``big_step="compose"``), by one stable counting sort on the
reversed τ-bit field (``"radix"``, through the ``radix_rank`` kernels on
CUDA tensors) or by the vendor's stable sort (``"xla"``, ``torch.sort``).
The per-level step routes through the
``wm_level_step`` kernel (one launch a level, given every level's zero
count, which one launch takes from the input before the first level) and
the rank tables through ``rank_build_levels`` on CUDA tensors; the plain
path gathers with the select-based ``stable_partition_gather``. Both give
bit-identical matrices.

``fused=False`` (``_build_wavelet_matrix_steps``) and
``build_wavelet_matrix_levelwise`` are the reference's baselines: stable
0/1 partitions by two prefix sums, applied through inverse-permutation
scatters, and per-level directories. On CUDA tensors their level bitmaps
pack through the ``bitpack`` kernel and the radix big step ranks through
``radix_rank`` (a totals count and a scan, no bucket starts), as
``core.sort.counting_rank`` routes it; the same bits either way.

Sequences may carry one leading batch axis (S, n): each row is built into
its own matrix and every leaf gains that leading axis — the stacked shard
layout, with one level of all shards per kernel launch.

Counters (the reference's): ``core.build{builder, path}`` a build and
``core.level_step{builder=wm, impl=kernel|torch}`` a level of the fused
build (the reference's ``impl=xla``). The reference's
``core.kernel_guard_trip`` guards jit's batch tracers, which the port does
not have, and has no counterpart here.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .. import obs
from . import bitops
from .rank_select import (BitVector, access_bit, build_bitvector,
                          build_bitvector_levels, rank0, rank1, select0,
                          select1, stable_partition_gather)
from .scan import (apply_permutation_dest, lift, stable_partition_indices,
                   take)
from .sort import _invert_permutation, sort_pass
from ..device import resolve_device
from ..tree import tree_map


def num_levels(sigma: int) -> int:
    return max(1, math.ceil(math.log2(max(2, sigma))))


def reverse_bits(x: torch.Tensor, width: int) -> torch.Tensor:
    """Reverse the low ``width`` bits of each element, ``int64``."""
    x = bitops.u32(x)
    out = torch.zeros_like(x)
    for i in range(width):
        out |= ((x >> i) & 1) << (width - 1 - i)
    return out


@dataclass(frozen=True)
class WaveletMatrix:
    """Per-level bitvectors stacked on an (nbits,) axis after any batch
    axes: ``bitvectors`` leaves are (*B, nbits, X), ``zeros`` (*B, nbits)."""
    bitvectors: BitVector
    zeros: torch.Tensor       # int32 zeros per level
    n: int
    nbits: int

    def level(self, l: int) -> BitVector:
        return tree_map(lambda x: x.select(-2, l), self.bitvectors)

    def level_zeros(self, l: int) -> torch.Tensor:
        return self.zeros[..., l].long()


def _pack_level(bit: torch.Tensor, use_kernels: bool) -> torch.Tensor:
    """LSB-first words of a level's bits along the last axis: the
    ``bitpack`` kernel when ``use_kernels`` (its plain version for a CPU
    tensor), else ``bitops.pack_bits``. The same words either way."""
    if use_kernels:
        from repro_torch.kernels import ops
        return ops.bitpack(bit)
    return bitops.pack_bits(bitops.pad_bits(bit))


def _input_rows(seq, device):
    """(device, (rows, n) int32 symbols, whether ``seq`` had a batch
    axis) of a build's input moved to ``device``."""
    dev = resolve_device(device)
    seq = torch.as_tensor(seq, device=dev)
    batched = seq.dim() == 2
    return dev, (seq if batched else seq[None]).to(torch.int32), batched


def _finalize(level_words, zeros, n: int, nbits: int, sample_rate: int,
              batched: bool) -> WaveletMatrix:
    """The baselines' directories: one ``build_bitvector`` a level,
    stacked on the level axis (the same leaves as the fused build's)."""
    bvs = [build_bitvector(w, n, sample_rate) for w in level_words]
    wm = WaveletMatrix(
        bitvectors=tree_map(lambda *xs: torch.stack(xs, -2), *bvs),
        zeros=torch.stack(zeros, -1), n=n, nbits=nbits)
    return wm if batched else tree_map(lambda x: x[0], wm)


def build_wavelet_matrix(seq, sigma: int, tau: int = 8,
                         big_step: str = "compose", sample_rate: int = 512,
                         fused: bool = True, use_kernels: bool | None = None,
                         device: str | torch.device = "cuda"
                         ) -> WaveletMatrix:
    """τ-chunked parallel construction (paper Theorem 4.5).

    ``seq``: (n,) or (S, n) symbols in [0, sigma), moved to ``device``.
    ``use_kernels`` routes the level steps, the radix big step and the rank
    tables through the CUDA kernels; ``None`` enables them on a CUDA
    device. ``fused=False`` is the reference's step-by-step baseline
    (:func:`_build_wavelet_matrix_steps`); both give the same matrix.
    """
    if big_step not in ("compose", "radix", "xla"):
        raise ValueError(f"unknown big_step {big_step!r}")
    dev, order, batched = _input_rows(seq, device)
    if use_kernels is None:
        use_kernels = dev.type == "cuda"
    obs.counter("core.build", builder="wm",
                path="fused" if fused else "scatter").inc()
    if not fused:
        return _build_wavelet_matrix_steps(order, sigma, tau, big_step,
                                           sample_rate, use_kernels,
                                           batched)
    rows, n = order.shape
    nbits = num_levels(sigma)
    level_words, zeros = [], []
    if use_kernels:
        from repro_torch.kernels import ops
        # a level's zeros survive every permutation of its row: count the
        # zeros of all levels once, from the input
        level_zeros = ops.wm_level_zeros(order, nbits)

    for alpha0 in range(0, nbits, tau):
        width = min(tau, nbits - alpha0)
        # the τ-bit field starting alpha0 bits below the top: the short list
        fld = bitops.extract_field(order, nbits - alpha0 - width, width)
        sub = fld.to(torch.int32)
        last_chunk = alpha0 + width >= nbits
        # the composed permutation exists only for a compose big step
        idx = (torch.arange(n, dtype=torch.int32, device=dev)
               .expand(rows, n).contiguous()
               if not last_chunk and big_step == "compose" else None)
        for t in range(width):
            shift = width - 1 - t
            # movement arranges the next level; at the chunk's final level
            # only the composed permutation still advances (a radix or xla
            # big step re-sorts from the chunk-start order)
            move = (alpha0 + t < nbits - 1) and (t < width - 1
                                                 or idx is not None)
            obs.counter("core.level_step", builder="wm",
                        impl="kernel" if use_kernels else "torch").inc()
            if use_kernels:
                dest, words, z = ops.wm_level_step(
                    sub, shift, n, level_zeros[:, alpha0 + t])
                if move:
                    if t < width - 1:
                        sub = apply_permutation_dest(sub, dest)
                    if idx is not None:
                        idx = apply_permutation_dest(idx, dest)
            else:
                bit = (sub.long() >> shift) & 1
                words = bitops.pack_bits(bitops.pad_bits(bit))
                z = (n - bit.sum(-1)).to(torch.int32)
                if move:
                    g = stable_partition_gather(words, z, n)
                    if t < width - 1:
                        sub = take(sub, g)
                    if idx is not None:
                        idx = take(idx, g)
            level_words.append(words)
            zeros.append(z)
        if not last_chunk:
            if big_step == "compose":
                order = take(order, idx)
            else:
                order, _ = sort_pass(
                    order, reverse_bits(fld, width), 1 << width,
                    backend="counting" if big_step == "radix" else "xla",
                    use_kernel=use_kernels)

    bvs = build_bitvector_levels(torch.stack(level_words, 1), n, sample_rate,
                                 use_kernels=use_kernels)
    wm = WaveletMatrix(bitvectors=bvs, zeros=torch.stack(zeros, 1), n=n,
                       nbits=nbits)
    return wm if batched else tree_map(lambda x: x[0], wm)


def _build_wavelet_matrix_steps(order: torch.Tensor, sigma: int, tau: int,
                                big_step: str, sample_rate: int,
                                use_kernels: bool,
                                batched: bool) -> WaveletMatrix:
    """The reference's step-by-step baseline of Theorem 4.5 on (rows, n)
    int32 symbols: every level's stable partition applied as the inverse
    of its scatter destinations, the composed permutation always carried,
    one directory build a level. ``use_kernels`` packs the levels through
    ``bitpack`` and ranks the radix big step through ``radix_rank``."""
    n = order.shape[-1]
    nbits = num_levels(sigma)
    level_words, zeros = [], []
    for alpha0 in range(0, nbits, tau):
        width = min(tau, nbits - alpha0)
        fld = bitops.extract_field(order, nbits - alpha0 - width, width)
        sub = fld
        perm = None                    # composed gather permutation
        for t in range(width):
            bit = (sub >> (width - 1 - t)) & 1
            level_words.append(_pack_level(bit, use_kernels))
            zeros.append((n - bit.sum(-1)).to(torch.int32))
            if alpha0 + t < nbits - 1:
                g = _invert_permutation(stable_partition_indices(bit))
                sub = take(sub, g)
                perm = g if perm is None else take(perm, g)
        if alpha0 + width < nbits:
            if big_step == "compose":
                order = take(order, perm)
            else:
                order, _ = sort_pass(
                    order, reverse_bits(fld, width), 1 << width,
                    backend="counting" if big_step == "radix" else "xla",
                    use_kernel=use_kernels)
    return _finalize(level_words, zeros, n, nbits, sample_rate, batched)


def build_wavelet_matrix_levelwise(seq, sigma: int, sample_rate: int = 512,
                                   device: str | torch.device = "cuda"
                                   ) -> WaveletMatrix:
    """Prior-work baseline [Shun'15]: O(n·logσ) work, the full-width
    symbols moved by a stable 0/1 partition at every level. ``seq``: (n,)
    or (S, n), moved to ``device``; on a CUDA device the level bitmaps pack
    through the ``bitpack`` kernel."""
    obs.counter("core.build", builder="wm_levelwise", path="scatter").inc()
    dev, order, batched = _input_rows(seq, device)
    n = order.shape[-1]
    nbits = num_levels(sigma)
    level_words, zeros = [], []
    for l in range(nbits):
        bit = (order >> (nbits - 1 - l)) & 1
        level_words.append(_pack_level(bit, dev.type == "cuda"))
        zeros.append((n - bit.sum(-1)).to(torch.int32))
        if l < nbits - 1:
            order = take(order, _invert_permutation(
                stable_partition_indices(bit)))
    return _finalize(level_words, zeros, n, nbits, sample_rate, batched)


# --------------------------------------------------------------------------
# Level-descent primitives (shared by the queries here and analytics)
# --------------------------------------------------------------------------

def wm_interval_zeros(wm: WaveletMatrix, l: int, lo: torch.Tensor,
                      hi: torch.Tensor):
    """rank0 at both ends of [lo, hi) on level ``l``."""
    rs = wm.level(l).rank
    return rank0(rs, lo), rank0(rs, hi)


def wm_child_interval(wm: WaveletMatrix, l: int, lo: torch.Tensor,
                      hi: torch.Tensor, bit: torch.Tensor,
                      lo0: torch.Tensor | None = None,
                      hi0: torch.Tensor | None = None):
    """Map [lo, hi) on level ``l`` to its child interval under ``bit``
    (0 → zero block, 1 → one block); pass ``lo0``/``hi0`` when known."""
    if lo0 is None or hi0 is None:
        lo0, hi0 = wm_interval_zeros(wm, l, lo, hi)
    zl = lift(wm.level_zeros(l), lo)
    return (torch.where(bit == 0, lo0, zl + (lo - lo0)),
            torch.where(bit == 0, hi0, zl + (hi - hi0)))


def wm_follow(wm: WaveletMatrix, l: int, p: torch.Tensor,
              bit: torch.Tensor) -> torch.Tensor:
    """Position p of level l followed into the child under ``bit`` (0 →
    zero block, 1 → one block): one rank probe."""
    ones = rank1(wm.level(l).rank, p)
    return torch.where(bit == 0, p.long() - ones,
                       lift(wm.level_zeros(l), p) + ones)


def wm_position_step(wm: WaveletMatrix, l: int, p: torch.Tensor):
    """Follow one position down a level: (bit at p, position in child)."""
    bit = access_bit(wm.level(l).rank, p)
    return bit, wm_follow(wm, l, p, bit)


# --------------------------------------------------------------------------
# Queries (int32 results, like the reference)
# --------------------------------------------------------------------------

def _arg(x, wm: WaveletMatrix) -> torch.Tensor:
    return torch.as_tensor(x, device=wm.zeros.device).long()


def wm_access(wm: WaveletMatrix, i) -> torch.Tensor:
    """Symbol at position i; O(logσ) rank calls."""
    p = _arg(i, wm)
    c = torch.zeros_like(p)
    for l in range(wm.nbits):
        bit, p = wm_position_step(wm, l, p)
        c = (c << 1) | bit
    return c.to(torch.int32)


def wm_rank(wm: WaveletMatrix, c, i) -> torch.Tensor:
    """# of occurrences of symbol c in [0, i)."""
    c, hi = _arg(c, wm), _arg(i, wm)
    c, hi = torch.broadcast_tensors(c, hi)
    lo = torch.zeros_like(hi)
    for l in range(wm.nbits):
        bit = (c >> (wm.nbits - 1 - l)) & 1
        lo, hi = wm_child_interval(wm, l, lo, hi, bit)
    return (hi - lo).to(torch.int32)


def wm_select(wm: WaveletMatrix, c, k) -> torch.Tensor:
    """Position of the k-th (0-based) occurrence of c: descend to c's block
    at the deepest level, then ascend with select. Out-of-range k gives a
    clamped position in [0, n), as in the reference."""
    c, k = torch.broadcast_tensors(_arg(c, wm), _arg(k, wm))
    lo = torch.zeros_like(k)
    for l in range(wm.nbits):
        bit = (c >> (wm.nbits - 1 - l)) & 1
        lo, _ = wm_child_interval(wm, l, lo, lo, bit)
    pos = lo + k
    for l in range(wm.nbits - 1, -1, -1):
        bv = wm.level(l)
        bit = (c >> (wm.nbits - 1 - l)) & 1
        pos = torch.where(bit == 0, select0(bv.rank, bv.sel0, pos),
                          select1(bv.rank, bv.sel1,
                                  pos - lift(wm.level_zeros(l), pos)))
        pos = pos.clamp(0, wm.n - 1)
    return pos.to(torch.int32)
