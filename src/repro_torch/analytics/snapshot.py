"""Persisted analytics snapshots (port of ``repro.analytics.snapshot``):
save and restore a ``ShardedAnalytics`` through ``checkpoint`` so a serving
restart skips the build.

The stacked shard structure is written in the checkpoint layout
(``arrays.npz`` + ``meta.json``) with the reference's keys, dtypes and
checksums, so either package loads the other's snapshots; the corpus
geometry (n, sigma, shard_bits, select sample rate) travels in
``meta.json``. A restore makes the structure from the geometry alone (all
shards share one shape) as ``device="meta"`` tensors and loads the arrays
into it, bit-exactly.

Restores are verified (per-leaf crc32 from ``meta.json``) and self-healing:
corrupted *derived* leaves are recomputed from the level bitmaps and
re-checked against the recorded checksums; only primary bitmap corruption
escapes as ``IntegrityError`` (rebuild from source). A load records the
reference's ``analytics.load`` span (``.restore`` and ``.repair`` inside
it), its ``robust.restore{outcome}`` counter and, on a checksum mismatch,
the ``integrity.corrupt`` event.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.core.rank_select import (BLOCK_WORDS, SUPERBLOCK_WORDS,
                                          BinaryRank, BinarySelect, BitVector)
from repro_torch.core.wavelet_matrix import WaveletMatrix, num_levels

from .engine import ShardedAnalytics

_SNAPSHOT_STEP = 0


def _struct(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def shards_struct(num_shards: int, sigma: int, shard_size: int,
                  sample_rate: int) -> WaveletMatrix:
    """A stacked (S,)-leaf ``WaveletMatrix`` of ``device="meta"`` tensors:
    exactly what the build gives ``num_shards`` shards of ``shard_size``
    positions, the restore target of :func:`load_analytics`."""
    nbits = num_levels(sigma)
    W = (shard_size + 31) // 32
    nsb = (W + SUPERBLOCK_WORDS - 1) // SUPERBLOCK_WORDS
    nblk = (W + BLOCK_WORDS - 1) // BLOCK_WORDS
    nsamp = shard_size // sample_rate + 2
    lead = (num_shards, nbits)
    rank = BinaryRank(words=_struct(lead + (W,), torch.int32),
                      superblock=_struct(lead + (nsb,), torch.int32),
                      block=_struct(lead + (nblk,), torch.int16),
                      n=shard_size)

    def sel(zeros: bool) -> BinarySelect:
        return BinarySelect(sample=_struct(lead + (nsamp,), torch.int32),
                            n=shard_size, sample_rate=sample_rate,
                            zeros=zeros)

    bv = BitVector(rank=rank, sel1=sel(False), sel0=sel(True))
    return WaveletMatrix(bitvectors=bv, zeros=_struct(lead, torch.int32),
                         n=shard_size, nbits=nbits)


def save_analytics(engine: ShardedAnalytics, directory: str | Path,
                   extra_meta: Optional[dict] = None) -> Path:
    """Atomically persist the engine (stacked shards + geometry);
    ``extra_meta`` (e.g. a corpus seed) rides along in ``meta.json`` so a
    restore can be checked against the stream it is meant to serve."""
    meta = {
        "kind": "sharded_analytics",
        "n": int(engine.n),
        "sigma": int(engine.sigma),
        "shard_bits": int(engine.shard_bits),
        "num_shards": int(engine.num_shards),
        "sample_rate": int(engine.shards.bitvectors.sel1.sample_rate),
    }
    if extra_meta:
        meta.update(extra_meta)
    return save_checkpoint(directory, _SNAPSHOT_STEP, engine.shards,
                           extra_meta=meta, keep=1)


def snapshot_meta(directory: str | Path,
                  step: Optional[int] = None) -> dict:
    """A snapshot's ``meta.json`` (geometry and the caller's extras)
    without loading the arrays: the cheap check before a restore."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no snapshot under {directory}")
    meta = json.loads((Path(directory) / f"step_{step:08d}" /
                       "meta.json").read_text())
    if meta.get("kind") != "sharded_analytics":
        raise ValueError(f"{directory} does not hold an analytics snapshot "
                         f"(kind={meta.get('kind')!r})")
    return meta


def load_analytics(directory: str | Path, step: Optional[int] = None,
                   verify: bool = True, repair: bool = True,
                   device: str | torch.device = "cuda") -> ShardedAnalytics:
    """Restore a :func:`save_analytics` snapshot into a new engine on
    ``device``.

    The leaves are checked against ``meta.json``'s ``leaf_crc32``
    (``verify``). A mismatch confined to derived leaves (rank/select
    directories, ``zeros``) is repaired by recomputation from the level
    bitmaps (``rank_build_levels`` on the card) and re-checked against the
    recorded checksums, so the result is bit-identical to the engine saved.
    Corrupt primary bitmaps cannot be repaired from the snapshot:
    ``IntegrityError`` escapes and the caller rebuilds from source."""
    from repro_torch.robust.integrity import IntegrityError, tree_checksums
    from repro_torch.robust.repair import classify_bad_keys, repair_analytics
    meta = snapshot_meta(directory, step=step)
    target = shards_struct(meta["num_shards"], meta["sigma"],
                           1 << meta["shard_bits"], meta["sample_rate"])
    step = meta.get("step", _SNAPSHOT_STEP)

    def make(shards):
        return ShardedAnalytics(shards=shards, n=meta["n"],
                                sigma=meta["sigma"],
                                shard_bits=meta["shard_bits"])

    with obs.span("analytics.load", dir=str(directory), step=step) as lsp:
        try:
            with obs.span("analytics.load.restore", verify=verify):
                shards, _ = restore_checkpoint(directory, target, step=step,
                                               device=device, verify=verify)
            obs.counter("robust.restore", outcome="clean").inc()
            lsp.set("outcome", "clean")
            return make(shards)
        except IntegrityError as err:
            if not repair:
                obs.counter("robust.restore",
                            outcome="corrupt_norepair").inc()
                lsp.set("outcome", "corrupt_norepair")
                raise
            derived, primary = classify_bad_keys(err.bad_keys)
            obs.event("integrity.corrupt", derived=len(derived),
                      primary=len(primary))
            if primary:
                obs.counter("robust.restore",
                            outcome="primary_corrupt").inc()
                lsp.set("outcome", "primary_corrupt")
                raise IntegrityError(
                    primary, where=f"{directory} (primary bitmaps corrupt — "
                    "repair impossible, rebuild from source)") from err
            with obs.span("analytics.load.repair", bad_leaves=len(derived)):
                shards, _ = restore_checkpoint(directory, target, step=step,
                                               device=device, verify=False)
                engine = repair_analytics(make(shards))
                want = meta.get("leaf_crc32", {})
                got = tree_checksums(engine.shards)
            still_bad = sorted(k for k in derived
                               if got.get(k) != want.get(k))
            if still_bad:
                obs.counter("robust.restore",
                            outcome="repair_diverged").inc()
                lsp.set("outcome", "repair_diverged")
                raise IntegrityError(
                    still_bad, where=f"{directory} (repair did not converge)"
                ) from err
            obs.counter("robust.restore", outcome="repaired").inc()
            lsp.set("outcome", "repaired")
            return engine
