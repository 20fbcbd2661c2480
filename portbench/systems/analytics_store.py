"""The compressed analytics store of ``repro_torch``: builds through the
engine's entry ``repro_torch.analytics.engine.build_sharded_analytics``,
range queries on the engine it returns, and their checks against the plain
reference.

A build is checked by what the entry returns: every level's bitmap words
and zero counts and the rank and select directories of the engine's
shards. (The store's shard histograms, which the entry makes and drops,
are no part of its result.)
"""
from __future__ import annotations

import torch

from portbench import work
from portbench.reference import wavelet

CHECK_ROWS = 16          # shards the reference builds at a time


def build(cfg: dict, tokens, device):
    """One whole build through the engine's entry: the engine."""
    from repro_torch.analytics.engine import build_sharded_analytics
    return build_sharded_analytics(
        tokens, int(cfg["vocab_size"]), shard_bits=int(cfg["shard_bits"]),
        tau=int(cfg["tau"]), big_step=cfg["big_step"],
        sample_rate=int(cfg["sample_rate"]), device=device)


def serve(cfg: dict, tokens, device):
    """The engine that a query traffic's batches go to."""
    return build(cfg, tokens, device)


def structure(result) -> list:
    """Every tensor the build leaves resident: the engine's."""
    return [result]


def build_work(cfg: dict, tr) -> dict:
    """The hand-written launches of one build: kernel -> [(bytes, ops)]."""
    n = int(cfg["n_tokens"])
    size = 1 << int(cfg["shard_bits"])
    return work.matrix_build(-(-n // size), size, int(cfg["vocab_size"]))


def _stored_rows(engine, lo: int, hi: int) -> dict:
    wm = engine.shards
    bv = wm.bitvectors
    return {"words": bv.rank.words[lo:hi], "superblock":
            bv.rank.superblock[lo:hi], "block": bv.rank.block[lo:hi],
            "sel1": bv.sel1.sample[lo:hi], "sel0": bv.sel0.sample[lo:hi],
            "zeros": wm.zeros[lo:hi]}


def wrong(got, want) -> int:
    """Elements of ``got`` that differ from ``want`` (all of them where the
    shapes differ)."""
    if not isinstance(got, torch.Tensor) or tuple(got.shape) != tuple(
            want.shape):
        return int(want.numel())
    return int((got.to(want.device).long() != want.long()).sum())


def padded_shards(tokens: torch.Tensor, size: int) -> torch.Tensor:
    """(S, size) shards of the stream, the tail padded with 0."""
    n = tokens.shape[0]
    s = max(1, -(-n // size))
    out = torch.zeros(s * size, dtype=torch.int64, device=tokens.device)
    out[:n] = tokens
    return out.view(s, size)


def check_build(cfg: dict, tokens, result, device,
                stable: bool = True) -> dict:
    """Wrong elements of one build against the reference, by part.
    ``stable=False`` gives the reference the control's unordered
    partition."""
    sigma = int(cfg["vocab_size"])
    size = 1 << int(cfg["shard_bits"])
    tokens = torch.as_tensor(tokens, device=device).long()
    shards = padded_shards(tokens, size)
    out = {"wrong_bitmap_words": 0, "wrong_level_zeros": 0,
           "wrong_rank_entries": 0, "wrong_select_entries": 0}
    for lo in range(0, shards.shape[0], CHECK_ROWS):
        hi = min(lo + CHECK_ROWS, shards.shape[0])
        want = wavelet.matrix(shards[lo:hi], sigma, int(cfg["sample_rate"]),
                              stable)
        got = _stored_rows(result, lo, hi)
        out["wrong_bitmap_words"] += wrong(got["words"], want["words"])
        out["wrong_level_zeros"] += wrong(got["zeros"], want["zeros"])
        out["wrong_rank_entries"] += (
            wrong(got["superblock"], want["superblock"])
            + wrong(got["block"], want["block"]))
        out["wrong_select_entries"] += (wrong(got["sel1"], want["sel1"])
                                        + wrong(got["sel0"], want["sel0"]))
        del want
    out["wrong_geometry"] = int(
        (result.n, result.sigma, result.shard_bits)
        != (tokens.shape[0], sigma, int(cfg["shard_bits"])))
    return out


def control_build(cfg: dict, tokens, result, device) -> dict:
    """The control's readings: the build held against the reference with
    an unordered partition (each level's ones in reverse order, as atomic
    counters may leave them), which breaks the matrix's stable order."""
    return check_build(cfg, tokens, result, device, stable=False)
