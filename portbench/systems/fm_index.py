"""The sharded FM index of ``repro_torch`` (an n-gram count index over a
tokenized corpus): builds through ``repro_torch.index.sharded
.build_sharded_index``, and their check against the plain reference.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import work
from portbench.reference import suffix, wavelet
from portbench.systems.analytics_store import wrong

CHECK_ROWS = 16          # shards the reference indexes at a time
SEAM_PAD = -2            # the seam windows' filler outside the stream


def build(cfg: dict, tokens, device):
    """One whole index build from host tokens."""
    from repro_torch.index.sharded import build_sharded_index
    return build_sharded_index(
        tokens, int(cfg["vocab_size"]), shard_bits=int(cfg["shard_bits"]),
        sample_rate=int(cfg["sa_sample_rate"]), tau=int(cfg["tau"]),
        big_step=cfg["big_step"], bv_sample_rate=int(cfg["sample_rate"]),
        backend=cfg["sort_backend"], seam_overlap=int(cfg["seam_overlap"]),
        device=device)


def structure(result) -> list:
    return [result]


def build_work(cfg: dict, launches: dict) -> dict:
    """The hand-written launches of one build (``launches``: each kernel's
    launches a build in the trace, which gives the suffix sort's passes)."""
    n = int(cfg["n_tokens"])
    size = 1 << int(cfg["shard_bits"])
    return work.index_build(-(-n // size), size, int(cfg["vocab_size"]),
                            round(launches.get("radix_scan", 0)))


def _shards(tokens, sigma: int, size: int, device) -> torch.Tensor:
    """(S, size) int64 shards, the tail padded with sigma."""
    t = torch.as_tensor(np.asarray(tokens), device=device).long()
    s = max(1, -(-t.shape[0] // size))
    out = torch.full((s * size,), sigma, dtype=torch.int64, device=device)
    out[:t.shape[0]] = t
    return out.view(s, size)


def check_build(cfg: dict, tokens, result, device,
                short: bool = False) -> dict:
    """Wrong elements of one index build against the reference, by part.
    ``short=True`` stops the reference's suffix sort of each block of
    shards one doubling round before the rounds it needs (the control)."""
    sigma = int(cfg["vocab_size"])
    size = 1 << int(cfg["shard_bits"])
    rate, bv_rate = int(cfg["sa_sample_rate"]), int(cfg["sample_rate"])
    shards = _shards(tokens, sigma, size, device)
    fm = result.shards
    out = {"wrong_sa_samples": 0, "wrong_mark_entries": 0,
           "wrong_bwt_matrix_entries": 0, "wrong_c_entries": 0}
    for lo in range(0, shards.shape[0], CHECK_ROWS):
        hi = min(lo + CHECK_ROWS, shards.shape[0])
        text = suffix.terminated(shards[lo:hi])
        sa, rounds = suffix.suffix_arrays(text)
        if short:
            sa, _ = suffix.suffix_arrays(text, rounds - 1)
        marked, samples = suffix.sa_samples(sa, rate)
        out["wrong_sa_samples"] += wrong(fm.sa_sample[lo:hi], samples)
        words = wavelet.pack(marked)
        sb, blk = wavelet.rank_directory(marked)
        out["wrong_mark_entries"] += (wrong(fm.mark.words[lo:hi], words)
                                      + wrong(fm.mark.superblock[lo:hi], sb)
                                      + wrong(fm.mark.block[lo:hi], blk))
        out["wrong_c_entries"] += wrong(fm.C[lo:hi],
                                        suffix.c_table(text, sigma + 2))
        bwt = suffix.bwt(text, sa)
        del sa, marked, samples
        want = wavelet.matrix(bwt, sigma + 2, bv_rate)
        bv = fm.wm.bitvectors
        for got, key in ((bv.rank.words, "words"), (bv.rank.superblock,
                                                    "superblock"),
                         (bv.rank.block, "block"), (bv.sel1.sample, "sel1"),
                         (bv.sel0.sample, "sel0"), (fm.wm.zeros, "zeros")):
            out["wrong_bwt_matrix_entries"] += wrong(got[lo:hi], want[key])
        del want, bwt, text
    seams = suffix.seam_windows(np.asarray(tokens), shards.shape[0], size,
                                int(cfg["seam_overlap"]), SEAM_PAD)
    out["wrong_seam_entries"] = wrong(result.seam_windows,
                                      torch.as_tensor(seams, device=device))
    out["wrong_geometry"] = int(
        (result.n, result.sigma, result.shard_bits, fm.n, fm.sample_rate)
        != (len(tokens), sigma, int(cfg["shard_bits"]), size, rate))
    return out


def control_build(cfg: dict, tokens, result, device) -> dict:
    """The control's readings: the build held against the reference whose
    suffix sort stops a round short of what its text needs (ties left in
    text order), which breaks the exact suffix order."""
    return check_build(cfg, tokens, result, device, short=True)
