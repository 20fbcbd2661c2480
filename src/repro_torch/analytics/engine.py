"""Sharded batched analytics over stacked wavelet-matrix shards (port of
``repro.analytics.engine``).

Per-shard matrices with one geometry stack leaf-wise into one
``WaveletMatrix`` with a leading (S,) axis; a query batch fans across all
shards as per-shard query rows (S, Q). Cross-shard reductions stay exact:

* ``count``     — per-shard counts sum;
* ``quantile``  — count-then-refine: the zero counts of every shard's
                  interval are summed before each branch, so all shards
                  descend in lockstep on the global k (the
                  ``wm_quantile_sharded`` kernel, or its plain descent);
* ``top-k``     — exact from the summed histograms, or one greedy frontier
                  whose nodes carry a per-shard interval vector;
* ``histogram``/``distinct`` — the per-shard histograms sum (a symbol in
                  several shards is counted once by ``distinct``).

Degraded mode: ``available`` (an (S,) bool mask, or None) empties the
local ranges of unavailable shards, so every op serves the surviving data;
the quantile then takes the plain descent, as the reference sends degraded
mode to XLA. ``coverage`` reports the covered fraction of each query and
the ``*_bounds`` forms bracket the full-corpus answer.

Counters (the reference's): ``analytics.op{op}`` an engine query,
``analytics.path{op=quantile, path=kernel|degraded_torch}`` the quantile's
route (the reference's ``path=xla``/``degraded_xla`` for its XLA
descent; the port's engine takes the kernel route whenever every shard is
available) and ``ingest.shard_swap{layer=analytics}`` an ``add_shards``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch import obs
from repro_torch.core.wavelet_matrix import (WaveletMatrix, wm_child_interval,
                                             wm_interval_zeros)
from repro_torch.kernels import ops
from repro_torch.kernels.wm_quantile import QuantileOperands
from repro_torch.tree import tree_leaves, tree_map

from . import range_ops


def local_ranges(shard_bits: int, num_shards: int, n: int, lo, hi,
                 device=None):
    """Per-shard local ranges (S, *lo.shape) of global [lo, hi): shard s
    covers ``[s·2^shard_bits, (s+1)·2^shard_bits)``, clipped so the padded
    tail past n is never touched."""
    size = 1 << shard_bits
    lo = torch.as_tensor(lo, device=device).long().clamp(0, n)
    hi = torch.maximum(torch.as_tensor(hi, device=device).long().clamp(0, n),
                       lo)
    bases = torch.arange(num_shards, device=lo.device) << shard_bits
    bases = bases.reshape((num_shards,) + (1,) * lo.dim())
    return (lo[None] - bases).clamp(0, size), (hi[None] - bases).clamp(0, size)


def mask_ranges(los: torch.Tensor, his: torch.Tensor, available):
    """Empty the local ranges of unavailable shards (``available``: (S,)
    bool or None for all available)."""
    if available is None:
        return los, his
    m = torch.as_tensor(available, dtype=torch.bool, device=los.device)
    return los, torch.where(m.reshape(m.shape + (1,) * (los.dim() - 1)),
                            his, los)


def _num_shards(shards: WaveletMatrix) -> int:
    return shards.zeros.shape[0]


def _ranges(shards: WaveletMatrix, shard_bits: int, n: int, lo, hi,
            available):
    """Masked per-shard local ranges (S, *Q) of global [lo, hi)."""
    return mask_ranges(*local_ranges(shard_bits, _num_shards(shards), n, lo,
                                     hi, shards.zeros.device), available)


def _covered(shard_bits: int, num_shards: int, n: int, lo, hi, available,
             device):
    """(total, covered, coverage) of each query: its positions, those on
    available shards, and their float32 ratio (1.0 for an empty range)."""
    los, his = local_ranges(shard_bits, num_shards, n, lo, hi, device)
    total = (his - los).sum(0)
    covered = (mask_ranges(los, his, available)[1] - los).sum(0)
    cov = torch.where(total > 0, covered.to(torch.float32)
                      / total.clamp(min=1).to(torch.float32), 1.0)
    return total, covered, cov


def sharded_range_count(shards: WaveletMatrix, shard_bits: int, n: int, lo,
                        hi, sym_lo, sym_hi, available=None,
                        operands: QuantileOperands | None = None
                        ) -> torch.Tensor:
    """Orthogonal range count over the whole corpus: per-shard counts sum.
    int32. Runs through ``ops.wm_count`` on the ``shards``' quantile
    operands (an engine's ``quantile``; made here when not given): one
    ``wm_count`` launch on the card, its plain version on the CPU."""
    if operands is None:
        operands = ops.quantile_operands(shards, shard_bits, n)
    los, his = _ranges(shards, shard_bits, n, lo, hi, available)
    shape, S = los.shape[1:], los.shape[0]
    q = los[0].numel()
    sym_lo, sym_hi = (torch.as_tensor(x, device=los.device).broadcast_to(
        shape).reshape(q) for x in (sym_lo, sym_hi))
    return ops.wm_count(operands, los.reshape(S, q).T, his.reshape(S, q).T,
                        sym_lo, sym_hi).reshape(shape)


def sharded_coverage(shard_bits: int, num_shards: int, n: int, lo, hi,
                     available, device=None) -> torch.Tensor:
    """Fraction of [lo, hi) positions living on available shards, float32
    (1.0 for fully covered or empty queries)."""
    return _covered(shard_bits, num_shards, n, lo, hi, available,
                    device)[2]


def sharded_range_count_bounds(shards: WaveletMatrix, shard_bits: int,
                               n: int, lo, hi, sym_lo, sym_hi,
                               available=None,
                               operands: QuantileOperands | None = None):
    """(lower, upper, coverage) bracketing the full-corpus count: ``lower``
    counts the surviving shards, and every uncovered position could match,
    so ``upper = lower + uncovered``. Exact (lower == upper) with every
    shard available. ``operands`` as for :func:`sharded_range_count`."""
    lower = sharded_range_count(shards, shard_bits, n, lo, hi, sym_lo,
                                sym_hi, available, operands)
    total, covered, cov = _covered(shard_bits, _num_shards(shards), n, lo,
                                   hi, available, shards.zeros.device)
    return lower, (lower + (total - covered)).to(torch.int32), cov


def sharded_range_quantile(shards: WaveletMatrix, shard_bits: int, n: int,
                           lo, hi, k, available=None) -> torch.Tensor:
    """Global k-th smallest symbol in [lo, hi) by the count-then-refine
    descent in plain torch (the bracket at full depth): O(S·logσ) rank
    probes per query. int32, -1 if the (covered) range is empty."""
    return sharded_range_quantile_bracket(shards, shard_bits, n, lo, hi, k,
                                          shards.nbits, available)[0]


def sharded_range_quantile_fused(shards: WaveletMatrix, shard_bits: int,
                                 n: int, lo, hi, k,
                                 available=None) -> torch.Tensor:
    """Kernel form of :func:`sharded_range_quantile`: the whole descent,
    all shards × all levels, in one ``wm_quantile_sharded`` launch ((Q,)
    batches). With an ``available`` mask it takes the plain descent. A
    one-off call: it fixes the kernel's operands for this call alone, where
    :meth:`ShardedAnalytics.range_quantile` reuses its engine's."""
    if available is not None:
        obs.counter("analytics.path", op="quantile",
                    path="degraded_torch").inc()
        return sharded_range_quantile(shards, shard_bits, n, lo, hi, k,
                                      available)
    obs.counter("analytics.path", op="quantile", path="kernel").inc()
    return ops.wm_quantile_sharded_batch(shards, shard_bits, n, lo, hi, k)


def sharded_range_quantile_bracket(shards: WaveletMatrix, shard_bits: int,
                                   n: int, lo, hi, k, levels: int,
                                   available=None):
    """The count-then-refine descent stopped after the top ``levels`` bit
    levels: (sym_lo, sym_hi), the half-open symbol bracket of width
    2^(nbits - levels) that holds the exact k-th smallest (``levels =
    nbits`` gives [q, q + 1)). (-1, -1) for an empty or uncovered range.
    int32."""
    nbits = shards.nbits
    levels = max(0, min(int(levels), nbits))
    los, his = _ranges(shards, shard_bits, n, lo, hi, available)
    total = (his - los).sum(0)
    k = torch.as_tensor(k, device=los.device).long()
    k = torch.minimum(k.clamp(min=0), (total - 1).clamp(min=0))
    sym = torch.zeros_like(k)
    for l in range(levels):
        lo0, hi0 = wm_interval_zeros(shards, l, los, his)
        z = (hi0 - lo0).sum(0)
        bit = (k >= z).long()
        k = torch.where(bit == 1, k - z, k)
        sym = (sym << 1) | bit
        los, his = wm_child_interval(shards, l, los, his, bit, lo0, hi0)
    width = nbits - levels
    empty = total <= 0
    return (torch.where(empty, -1, sym << width).to(torch.int32),
            torch.where(empty, -1, (sym + 1) << width).to(torch.int32))


def _per_query(fn, lo, hi):
    """``fn`` over (Q,) queries of a scalar or batched ``lo``/``hi``, its
    outputs reshaped back to the queries' shape (plus fn's own axes)."""
    lo = torch.as_tensor(lo)
    lo, hi = torch.broadcast_tensors(lo, torch.as_tensor(hi,
                                                         device=lo.device))
    out = fn(lo.reshape(-1), hi.reshape(-1))
    if isinstance(out, tuple):
        return tuple(x.reshape(lo.shape + x.shape[1:]) for x in out)
    return out.reshape(lo.shape + out.shape[1:])


def sharded_range_histogram(shards: WaveletMatrix, shard_bits: int, n: int,
                            lo, hi, available=None) -> torch.Tensor:
    """Global per-symbol counts of [lo, hi): the per-shard histograms
    summed, (*Q, 2^nbits) int32 (the sparse breadth-first descent of
    ``range_ops.histogram_descent``, over every shard at once)."""
    def hist(lo_q, hi_q):
        los, his = _ranges(shards, shard_bits, n, lo_q, hi_q, available)
        return range_ops.histogram_descent(range_ops.level_rows(shards),
                                           shards.nbits, los, his)
    return _per_query(hist, lo, hi)


def sharded_range_histogram_bounds(shards: WaveletMatrix, shard_bits: int,
                                   n: int, lo, hi, available=None):
    """(hist_lower, uncovered, coverage): every symbol's true count lies in
    [hist_lower[c], hist_lower[c] + uncovered]."""
    hist = sharded_range_histogram(shards, shard_bits, n, lo, hi, available)
    total, covered, cov = _covered(shard_bits, _num_shards(shards), n, lo,
                                   hi, available, shards.zeros.device)
    return hist, (total - covered).to(torch.int32), cov


def sharded_range_topk(shards: WaveletMatrix, shard_bits: int, n: int, lo,
                       hi, k: int, available=None):
    """Exact global top-k: the summed histogram's k largest, (*Q, k) syms
    and counts by descending count, (-1, 0) padded."""
    hist = sharded_range_histogram(shards, shard_bits, n, lo, hi, available)
    return range_ops.topk_from_histogram(hist, k)


def sharded_range_topk_greedy(shards: WaveletMatrix, shard_bits: int,
                              n: int, lo, hi, k: int,
                              budget: int | None = None, prune: bool = True,
                              available=None,
                              operands: QuantileOperands | None = None):
    """Greedy global top-k: one frontier a query whose nodes carry a
    per-shard interval vector (weight = summed width), not a merge of
    per-shard lists; the budget and ``prune`` of
    ``range_ops.range_topk_greedy``. (*Q, k) syms and counts. The
    frontier runs through ``ops.topk_greedy`` on the ``shards``' quantile
    operands (an engine's ``quantile``; made here when not given): one
    ``topk_greedy`` launch on the card, its plain version on the CPU."""
    if operands is None:
        operands = ops.quantile_operands(shards, shard_bits, n)

    def greedy(lo_q, hi_q):
        los, his = _ranges(shards, shard_bits, n, lo_q, hi_q, available)
        return ops.topk_greedy(operands, los.T, his.T, k, budget, prune)[:2]
    return _per_query(greedy, lo, hi)


def sharded_range_distinct(shards: WaveletMatrix, shard_bits: int, n: int,
                           lo, hi, available=None) -> torch.Tensor:
    """# of distinct symbols in global [lo, hi) (the union over the
    shards). int32."""
    hist = sharded_range_histogram(shards, shard_bits, n, lo, hi, available)
    return (hist > 0).sum(-1).to(torch.int32)


@dataclass(frozen=True)
class ShardedAnalytics:
    """Stacked per-shard wavelet matrices + corpus geometry: the serving
    handle. Build once (or adopt a ``CompressedCorpus``'s shards), then
    serve batched range queries.

    Every new engine whose ``shards`` differ from its source's (``add_shards``,
    a repair, a restore) is made with ``quantile=None``, so the kernel's
    operands are taken from the new directories; availability changes keep
    the shards and the operands."""
    shards: WaveletMatrix            # every leaf has a leading (S,) axis
    n: int
    sigma: int
    shard_bits: int
    available: torch.Tensor | None = None
    # the quantile kernel's operands, fixed once per engine (filled in by
    # the constructor when not given): ``shards``' directories, read in
    # place where their rows hold whole blocks; no stored leaf
    quantile: QuantileOperands | None = None

    def __post_init__(self):
        if self.quantile is None:
            with obs.stage("engine.operands"):
                object.__setattr__(self, "quantile", ops.quantile_operands(
                    self.shards, self.shard_bits, self.n))

    @property
    def num_shards(self) -> int:
        return _num_shards(self.shards)

    @property
    def shard_size(self) -> int:
        return 1 << self.shard_bits

    @property
    def degraded(self) -> bool:
        return self.available is not None

    @property
    def device(self) -> torch.device:
        return self.shards.zeros.device

    # ---- availability management ---------------------------------------
    def with_availability(self, available) -> "ShardedAnalytics":
        """Engine serving only the shards where ``available`` is True
        (``None`` restores full availability)."""
        if available is not None:
            available = torch.as_tensor(available, dtype=torch.bool,
                                        device=self.device)
            if available.shape != (self.num_shards,):
                raise ValueError(
                    f"availability mask shape {tuple(available.shape)} != "
                    f"({self.num_shards},)")
        return dataclasses.replace(self, available=available)

    def drop_shards(self, shard_ids) -> "ShardedAnalytics":
        """Mark the given shard indices unavailable, on top of the current
        mask: the degraded-serving entry point for lost shards."""
        mask = (torch.ones(self.num_shards, dtype=torch.bool,
                           device=self.device)
                if self.available is None else self.available.clone())
        mask[torch.as_tensor(shard_ids, device=self.device).long()] = False
        return dataclasses.replace(self, available=mask)

    def coverage(self, lo, hi) -> torch.Tensor:
        """Fraction of [lo, hi) positions on available shards (1.0 when the
        engine is fully available). float32."""
        return sharded_coverage(self.shard_bits, self.num_shards, self.n, lo,
                                hi, self.available, self.device)

    def shard(self, s: int) -> WaveletMatrix:
        return tree_map(lambda x: x[s], self.shards)

    def bits_per_token(self) -> float:
        total = sum(x.numel() * x.element_size() * 8
                    for x in tree_leaves(self.shards))
        return total / max(1, self.n)

    @classmethod
    def from_corpus(cls, corpus) -> "ShardedAnalytics":
        """Adopt a ``CompressedCorpus``'s shards (no rebuild, no copy)."""
        return cls(shards=corpus.shards, n=corpus.n, sigma=corpus.sigma,
                   shard_bits=corpus.shard_bits)

    # ---- incremental ingest ---------------------------------------------
    def add_shards(self, new_shards: WaveletMatrix, added_tokens: int,
                   new_available=None) -> "ShardedAnalytics":
        """Next-generation engine with ``new_shards`` (a stacked (K,)-leaf
        ``WaveletMatrix`` of this geometry) appended. ``added_tokens`` is
        their true token count (only the last new shard may be partial;
        this corpus must end on a shard boundary), ``new_available`` masks
        freshly quarantined shards; the combined mask collapses to None
        when every shard is available. The kernel's operands are taken
        anew from the merged directories."""
        if self.n != self.num_shards << self.shard_bits:
            raise ValueError(
                f"cannot append to a corpus with a partial tail shard "
                f"(n={self.n}, {self.num_shards} shards of "
                f"{self.shard_size})")
        K = _num_shards(new_shards)
        added_tokens = int(added_tokens)
        if not ((K - 1) << self.shard_bits) < added_tokens \
                <= (K << self.shard_bits):
            raise ValueError(
                f"added_tokens={added_tokens} does not fill {K} shard(s) "
                f"of {self.shard_size}")
        merged = tree_map(lambda a, b: torch.cat([a, b], 0), self.shards,
                          new_shards)
        if self.available is None and new_available is None:
            mask = None
        else:
            old = (torch.ones(self.num_shards, dtype=torch.bool,
                              device=self.device)
                   if self.available is None else self.available)
            new = (torch.ones(K, dtype=torch.bool, device=self.device)
                   if new_available is None
                   else torch.as_tensor(new_available, dtype=torch.bool,
                                        device=self.device).reshape(K))
            mask = torch.cat([old, new])
            if bool(mask.all()):
                mask = None
        obs.counter("ingest.shard_swap", layer="analytics").inc()
        return dataclasses.replace(self, shards=merged,
                                   n=self.n + added_tokens, available=mask,
                                   quantile=None)

    # ---- batched queries ------------------------------------------------
    def range_quantile(self, lo, hi, k) -> torch.Tensor:
        """Global k-th smallest in [lo, hi) for (Q,) batches: the
        ``wm_quantile_sharded`` kernel on a CUDA engine, its plain version on
        a CPU engine, the plain descent under an availability mask. Stage
        ``engine.range_quantile``: from the entry to the launch's return
        (the answers' readback is the caller's); a profiler's range only,
        no exported event, as a call is one batch."""
        with obs.stage("engine.range_quantile", export=False):
            obs.counter("analytics.op", op="quantile").inc()
            if self.available is not None:
                obs.counter("analytics.path", op="quantile",
                            path="degraded_torch").inc()
                return sharded_range_quantile(self.shards, self.shard_bits,
                                              self.n, lo, hi, k,
                                              self.available)
            obs.counter("analytics.path", op="quantile", path="kernel").inc()
            return ops.wm_quantile(self.quantile, lo, hi, k)

    def range_quantile_bracket(self, lo, hi, k, levels: int):
        """(sym_lo, sym_hi) bracketing the exact k-th smallest after a
        descent cut to ``levels`` bit levels."""
        obs.counter("analytics.op", op="quantile_bracket").inc()
        return sharded_range_quantile_bracket(self.shards, self.shard_bits,
                                              self.n, lo, hi, k, levels,
                                              self.available)

    def probe_shard(self, s: int, clock=None) -> bool:
        """Liveness probe of one shard: first sleeps any armed
        ``robust.faults.shard_latency`` stall on ``clock`` (a real stall on
        the system clock, an instant logical one on a ``FakeClock``), then
        reads the shard's first symbol by a one-shard range quantile of
        [s·2^shard_bits, s·2^shard_bits + 1) through the engine's kernel
        operands (every level's directories of shard s, whatever the
        availability mask; the plain descent on a CPU engine), and ends in
        a synchronize, so a probe the circuit breakers time covers the
        device work. Returns True on success.

        The reference probes with a one-shard plain count; the port's plain
        count is some 5,000 small launches, about 80 ms a probe on an H100,
        which made a refresh of 128 breakers 10 s long (``PERF.md`` §6).
        The kernel's one launch touches the same directories."""
        from repro_torch.robust.clock import SYSTEM_CLOCK
        from repro_torch.robust.faults import shard_latency
        clock = clock if clock is not None else SYSTEM_CLOCK
        delay = shard_latency(s)
        if delay > 0:
            clock.sleep(delay)
        lo = int(s) << self.shard_bits
        out = ops.wm_quantile(self.quantile, [lo], [lo + 1], [0])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return bool(out[0] >= 0)

    def range_count(self, lo, hi, sym_lo, sym_hi) -> torch.Tensor:
        obs.counter("analytics.op", op="count").inc()
        return sharded_range_count(self.shards, self.shard_bits, self.n, lo,
                                   hi, sym_lo, sym_hi, self.available,
                                   self.quantile)

    def range_count_bounds(self, lo, hi, sym_lo, sym_hi):
        """(lower, upper, coverage) bracketing the full-corpus count."""
        obs.counter("analytics.op", op="count_bounds").inc()
        return sharded_range_count_bounds(self.shards, self.shard_bits,
                                          self.n, lo, hi, sym_lo, sym_hi,
                                          self.available, self.quantile)

    def range_topk(self, lo, hi, k: int):
        obs.counter("analytics.op", op="topk").inc()
        return sharded_range_topk(self.shards, self.shard_bits, self.n, lo,
                                  hi, k, self.available)

    def range_topk_greedy(self, lo, hi, k: int, budget: int | None = None,
                          prune: bool = True):
        obs.counter("analytics.op", op="topk_greedy").inc()
        return sharded_range_topk_greedy(self.shards, self.shard_bits,
                                         self.n, lo, hi, k, budget, prune,
                                         self.available, self.quantile)

    def range_distinct(self, lo, hi) -> torch.Tensor:
        obs.counter("analytics.op", op="distinct").inc()
        return sharded_range_distinct(self.shards, self.shard_bits, self.n,
                                      lo, hi, self.available)

    def range_histogram(self, lo, hi) -> torch.Tensor:
        obs.counter("analytics.op", op="histogram").inc()
        return sharded_range_histogram(self.shards, self.shard_bits, self.n,
                                       lo, hi, self.available)

    def range_histogram_bounds(self, lo, hi):
        """(hist_lower, uncovered, coverage): true per-symbol counts lie in
        [hist_lower[c], hist_lower[c] + uncovered]."""
        obs.counter("analytics.op", op="histogram_bounds").inc()
        return sharded_range_histogram_bounds(self.shards, self.shard_bits,
                                              self.n, lo, hi, self.available)


def build_sharded_analytics(tokens, sigma: int, *, shard_bits: int = 16,
                            tau: int = 8, big_step: str = "compose",
                            sample_rate: int = 512,
                            device: str | torch.device = "cuda"
                            ) -> ShardedAnalytics:
    """Build the engine from a raw token stream via the compressed-store
    shard builder. Stage ``engine.build`` holds the store's stages and
    ``engine.operands``."""
    from repro_torch.data.compressed_store import build_compressed_corpus
    with obs.stage("engine.build"):
        corpus = build_compressed_corpus(
            tokens, sigma, shard_bits=shard_bits, tau=tau, big_step=big_step,
            sample_rate=sample_rate, device=device)
        return ShardedAnalytics.from_corpus(corpus)
