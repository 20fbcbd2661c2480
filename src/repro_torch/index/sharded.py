"""Shard-parallel full-text index: FM-index per shard, stacked leaf-wise
(port of ``repro.index.sharded``).

Every shard's ``FMIndex`` has the same geometry (power-of-two shard size,
shared alphabet), so the shards are built as one batch (the shard axis is
the batch axis of every build step) into ONE ``FMIndex`` whose leaves have
a leading (S,) axis, and a batch of patterns against all shards is one
backward search over (S, B) rows.

The last shard is padded with the out-of-alphabet symbol σ (indexed with
an alphabet of σ+1), which cannot appear in a query, so padding never
produces phantom matches.

Cross-shard stitching: per-shard FM-indexes alone cannot see a match that
spans a shard boundary. ``count`` therefore adds a seam pass: every
internal boundary stores a ±``seam_overlap``-token window of the raw
stream, and a sliding compare counts the matches that cross the boundary
(within-shard matches are excluded by the crossing condition, so nothing
is counted twice). Counts are exact for pattern lengths ≤ min(seam_overlap
+ 1, shard_size). ``locate`` reports within-shard positions only.

Counters (the reference's): ``index.op{op, path=full|degraded}`` a query
and ``ingest.shard_swap{layer=index}`` an ``add_shards``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.tree import tree_leaves, tree_map

from .fm_index import FMIndex, build_fm_index, fm_count, fm_locate

#: filler for seam-window slots outside the corpus. Distinct from the -1
#: that pattern sanitization emits, so masked query symbols can never
#: "match" masked window slots.
_SEAM_PAD = -2

#: elements of one (patterns × seams × offsets × positions) compare chunk
_SEAM_CHUNK = 1 << 26

_I32_MAX = torch.iinfo(torch.int32).max


@dataclass(frozen=True)
class ShardedTextIndex:
    """Stacked per-shard FM-indexes + seam windows + corpus geometry."""
    shards: FMIndex                # every leaf has a leading (S,) axis
    seam_windows: torch.Tensor     # (S-1, 2·seam_overlap) int32, _SEAM_PAD
    #                                filled outside [0, n)
    n: int                         # true corpus length
    sigma: int                     # raw vocab size
    shard_bits: int
    seam_overlap: int
    #: (S,) bool per-shard availability, or None for full availability.
    #: Degraded mode: unavailable shards contribute 0 within-shard matches,
    #: seams touching them are skipped, and their locate hits are masked.
    available: torch.Tensor | None = None

    @property
    def shard_size(self) -> int:
        return 1 << self.shard_bits

    @property
    def num_shards(self) -> int:
        return self.shards.C.shape[0]

    @property
    def degraded(self) -> bool:
        return self.available is not None

    @property
    def device(self) -> torch.device:
        return self.shards.C.device

    # ---- availability management -------------------------------------
    def with_availability(self, available) -> "ShardedTextIndex":
        """Index serving only the shards where ``available`` is True
        (``None`` restores full availability)."""
        if available is not None:
            available = torch.as_tensor(available, dtype=torch.bool,
                                        device=self.device)
            if available.shape != (self.num_shards,):
                raise ValueError(
                    f"availability mask shape {tuple(available.shape)} != "
                    f"({self.num_shards},)")
        return dataclasses.replace(self, available=available)

    def drop_shards(self, shard_ids) -> "ShardedTextIndex":
        """Mark the given shard indices unavailable (cumulative)."""
        mask = (torch.ones(self.num_shards, dtype=torch.bool,
                           device=self.device)
                if self.available is None else self.available.clone())
        mask[torch.as_tensor(shard_ids, device=self.device).long()] = False
        return dataclasses.replace(self, available=mask)

    def _shard_sizes(self) -> torch.Tensor:
        """(S,) true (unpadded) token count of each shard."""
        starts = torch.arange(self.num_shards,
                              device=self.device) << self.shard_bits
        return (self.n - starts).clamp(0, self.shard_size)

    def coverage(self) -> torch.Tensor:
        """Fraction of corpus positions on available shards (float32)."""
        if self.available is None:
            return torch.tensor(1.0, device=self.device)
        covered = torch.where(self.available, self._shard_sizes(), 0).sum()
        return covered.to(torch.float32) / float(max(1, self.n))

    def shard(self, s: int) -> FMIndex:
        return tree_map(lambda x: x[s], self.shards)

    def probe_shard(self, s: int, clock=None) -> bool:
        """Liveness probe of one shard: a one-shard backward search of a
        one-symbol pattern that first sleeps any armed
        ``robust.faults.shard_latency`` stall on ``clock`` and ends in a
        synchronize (the probe covers the device work, not only its
        dispatch). Returns True on success."""
        from repro_torch.robust.clock import SYSTEM_CLOCK
        from repro_torch.robust.faults import shard_latency
        clock = clock if clock is not None else SYSTEM_CLOCK
        delay = shard_latency(s)
        if delay > 0:
            clock.sleep(delay)
        pat = torch.zeros((1, 1), dtype=torch.int32, device=self.device)
        out = fm_count(self.shard(int(s)), pat,
                       torch.ones((1,), dtype=torch.int32,
                                  device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return bool(out[0] >= 0)

    # ---- incremental ingest ------------------------------------------
    def add_shards(self, new_shards: FMIndex, new_seams,
                   added_tokens: int, new_available=None
                   ) -> "ShardedTextIndex":
        """Next-generation index with ``new_shards`` appended.

        ``new_shards``: stacked (K,)-leaf FM-index with this index's
        geometry. ``new_seams``: the (K, 2·seam_overlap) boundary windows
        preceding each new shard (between the old tail and the first new
        shard, then between consecutive new shards). ``added_tokens`` is
        the true token count added (only the final shard may be partial;
        the old corpus must end on a shard boundary). ``new_available``
        masks quarantined shards. The result is a new value.
        """
        if self.n != self.num_shards << self.shard_bits:
            raise ValueError(
                f"cannot append to an index with a partial tail shard "
                f"(n={self.n}, {self.num_shards} shards of "
                f"{self.shard_size})")
        K = new_shards.C.shape[0]
        added_tokens = int(added_tokens)
        if not ((K - 1) << self.shard_bits) < added_tokens \
                <= (K << self.shard_bits):
            raise ValueError(
                f"added_tokens={added_tokens} does not fill {K} shard(s) "
                f"of {self.shard_size}")
        new_seams = torch.as_tensor(new_seams, device=self.device).to(
            torch.int32)
        if new_seams.shape != (K, 2 * self.seam_overlap):
            raise ValueError(
                f"new_seams shape {tuple(new_seams.shape)} != "
                f"({K}, {2 * self.seam_overlap})")
        merged = tree_map(lambda a, b: torch.cat([a, b], 0), self.shards,
                          new_shards)
        seams = torch.cat([self.seam_windows, new_seams], 0)
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
        obs.counter("ingest.shard_swap", layer="index").inc()
        return dataclasses.replace(self, shards=merged, seam_windows=seams,
                                   n=self.n + added_tokens, available=mask)

    def bits_per_token(self) -> float:
        total = sum(x.numel() * x.element_size() * 8
                    for x in tree_leaves(self.shards))
        return total / max(1, self.n)

    # ------------------------------------------------------------------
    def _sanitize(self, patterns, lengths):
        """Coerce shapes and mask symbols outside the *corpus* vocabulary.

        Shards are indexed with the widened alphabet σ+1 (pad symbol σ is
        in-alphabet for the per-shard FM-index), so out-of-vocab query
        symbols, σ included, are rewritten to -1 here, which the backward
        search treats as match-nothing. Zero-length patterns become a
        1-symbol match-nothing pattern: the empty query counts 0 at this
        layer. Returns (B, L) and (B,) ``int32``.
        """
        patterns = torch.atleast_2d(torch.as_tensor(
            patterns, device=self.device)).to(torch.int32)
        lengths = torch.atleast_1d(torch.as_tensor(
            lengths, device=self.device)).to(torch.int32)
        in_vocab = (patterns >= 0) & (patterns < self.sigma)
        patterns = torch.where(in_vocab, patterns, -1)
        empty = lengths <= 0
        patterns[:, 0] = torch.where(empty, -1, patterns[:, 0])
        return patterns, torch.where(empty, 1, lengths)

    def count(self, patterns, lengths) -> torch.Tensor:
        """Total matches per pattern, (B,) int32: within-shard matches from
        the FM-indexes plus boundary-crossing matches from the seam
        windows. Exact for lengths ≤ min(seam_overlap + 1, shard_size). On
        a degraded index this counts surviving shards only (a lower bound
        on the true count; ``count_bounds`` brackets it)."""
        obs.counter("index.op", op="count",
                    path="degraded" if self.degraded else "full").inc()
        within = self.count_by_shard(patterns, lengths).sum(0)
        seams = self._seam_count(*self._sanitize(patterns, lengths))
        return (within + seams).to(torch.int32)

    def count_bounds(self, patterns, lengths):
        """(lower, upper, coverage) bracketing the full-corpus count.

        ``lower`` is the degraded ``count``. Every missed match either
        starts on an unavailable shard (≤ its position count) or crosses
        a skipped seam (≤ length−1 starts per seam), so
        ``upper = lower + unavailable_positions + skipped_seams·(len−1)``.
        Fully available indexes return lower == upper, coverage 1.0.
        """
        obs.counter("index.op", op="count_bounds",
                    path="degraded" if self.degraded else "full").inc()
        lower = self.count(patterns, lengths)
        if self.available is None:
            return lower, lower, self.coverage()
        uncovered = torch.where(self.available, 0, self._shard_sizes()).sum()
        seam_ok = self.available[:-1] & self.available[1:]
        skipped = (~seam_ok).sum()
        lengths = torch.atleast_1d(torch.as_tensor(
            lengths, device=self.device)).long()
        extra = uncovered + skipped * (lengths - 1).clamp(min=0)
        return lower, (lower + extra).to(torch.int32), self.coverage()

    def _seam_count(self, patterns: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
        """(B,) matches that cross a shard boundary (sanitized inputs).

        A length-l match at window offset o of a seam (boundary at window
        center ov) crosses iff o < ov < o + l; the sliding compare is one
        broadcast equality over (patterns × seams × offsets × positions),
        in chunks of patterns. Patterns longer than the exactness domain
        min(ov+1, shard_size) contribute 0 here: beyond ov+1 the window
        cannot hold every crossing start, and beyond shard_size a match
        could cross two seams and be counted twice.
        """
        ns, width = self.seam_windows.shape
        ov = self.seam_overlap
        B, L = patterns.shape
        if ns == 0 or ov == 0:
            return torch.zeros(B, dtype=torch.int32, device=self.device)
        lmax = min(ov + 1, self.shard_size)
        dev = self.device
        o = torch.arange(width, device=dev)                     # offsets
        t = torch.arange(L, device=dev)                         # positions
        idx = (o[:, None] + t[None, :]).clamp(max=width - 1)    # (O, L)
        win = self.seam_windows[:, idx]                         # (ns, O, L)
        lengths = lengths.long()
        ol = o[None, :] + lengths[:, None]                      # (B, O)
        span = ((o[None, :] < ov) & (ol > ov) & (ol <= width)
                & (lengths[:, None] <= lmax))                   # (B, O)
        seam_ok = (None if self.available is None
                   else self.available[:-1] & self.available[1:])
        out = torch.empty(B, dtype=torch.int32, device=dev)
        step = max(1, _SEAM_CHUNK // max(1, ns * width * L))
        for b0 in range(0, B, step):
            b1 = min(B, b0 + step)
            pat = patterns[b0:b1, None, None, :]                # (b,1,1,L)
            past_len = (t[None, :] >= lengths[b0:b1, None])[:, None, None]
            hit = ((win[None] == pat) | past_len).all(-1)       # (b, ns, O)
            crossing = hit & span[b0:b1, None, :]
            if seam_ok is not None:
                # seam s spans shards s and s+1: both must be available
                crossing &= seam_ok[None, :, None]
            out[b0:b1] = crossing.sum((1, 2)).to(torch.int32)
        return out

    def count_by_shard(self, patterns, lengths) -> torch.Tensor:
        """(S, B) per-shard match counts: one backward search over the
        stacked shard axis. Unavailable shards report 0."""
        per = fm_count(self.shards, *self._sanitize(patterns, lengths))
        if self.available is not None:
            per = torch.where(self.available[:, None], per, 0)
        return per

    def locate(self, patterns, lengths,
               max_hits_per_shard: int = 8) -> torch.Tensor:
        """Global match positions, (B, S·max_hits_per_shard) int32.

        Per-shard local hits are rebased by ``s · shard_size``; slots past
        each shard's true hit count are -1. Sorted ascending per pattern
        with the -1 padding swept to the back.
        """
        obs.counter("index.op", op="locate",
                    path="degraded" if self.degraded else "full").inc()
        patterns, lengths = self._sanitize(patterns, lengths)
        local = fm_locate(self.shards, patterns, lengths,
                          max_hits_per_shard)                   # (S, B, H)
        S = self.num_shards
        bases = (torch.arange(S, device=self.device)
                 << self.shard_bits)[:, None, None]
        ok = (local >= 0)
        if self.available is not None:
            ok &= self.available[:, None, None]
        hits = torch.where(ok, local.long() + bases, -1)
        flat = hits.transpose(0, 1).reshape(patterns.shape[0], -1)
        out = torch.sort(torch.where(flat < 0, _I32_MAX, flat), -1).values
        return torch.where(out == _I32_MAX, -1, out).to(torch.int32)


def seam_windows_from_tokens(tokens: np.ndarray, num_shards: int,
                             shard_size: int, seam_overlap: int) -> np.ndarray:
    """(num_shards-1, 2·seam_overlap) raw-stream windows around each
    internal shard boundary, ``_SEAM_PAD``-filled outside [0, n)."""
    n = len(tokens)
    ns = max(0, num_shards - 1)
    g = ((np.arange(1, ns + 1) * shard_size)[:, None] - seam_overlap
         + np.arange(2 * seam_overlap)[None, :])
    inside = (g >= 0) & (g < n)
    win = np.full(g.shape, _SEAM_PAD, np.int32)
    win[inside] = np.asarray(tokens)[g[inside]]
    return win


def build_sharded_index(tokens, sigma: int, *, shard_bits: int = 14,
                        sample_rate: int = 32, tau: int = 8,
                        big_step: str = "compose", bv_sample_rate: int = 512,
                        backend: str = "counting", seam_overlap: int = 15,
                        use_kernels: bool | None = None,
                        device: str | torch.device = "cuda"
                        ) -> ShardedTextIndex:
    """Shard the token stream and run the per-shard build pipeline (suffix
    array → BWT → wavelet matrix → SA samples) on every shard at once, the
    shard axis being the batch axis of every build step. The tail shard is
    padded with the out-of-alphabet symbol σ. ``seam_overlap`` sets the
    half-width of the boundary windows that make ``count`` exact across
    shard seams for pattern lengths ≤ seam_overlap + 1 (0 disables).
    ``use_kernels``: as in ``fm_index.build_fm_index``."""
    dev = resolve_device(device)
    toks = np.asarray(tokens)
    n = len(toks)
    shard_size = 1 << shard_bits
    num_shards = max(1, (n + shard_size - 1) // shard_size)
    if toks.size and (int(toks.min()) < 0 or int(toks.max()) >= sigma):
        raise ValueError(f"tokens outside [0, {sigma})")
    shards = F.pad(torch.from_numpy(toks.astype(np.int32)).to(dev),
                   (0, num_shards * shard_size - n), value=sigma)
    stacked = build_fm_index(shards.reshape(num_shards, shard_size),
                             sigma + 1, sample_rate=sample_rate, tau=tau,
                             big_step=big_step, bv_sample_rate=bv_sample_rate,
                             backend=backend, use_kernels=use_kernels,
                             device=dev)
    seams = seam_windows_from_tokens(toks, num_shards, shard_size,
                                     seam_overlap)
    return ShardedTextIndex(shards=stacked,
                            seam_windows=torch.from_numpy(seams).to(dev),
                            n=n, sigma=sigma, shard_bits=shard_bits,
                            seam_overlap=seam_overlap)
