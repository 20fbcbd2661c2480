"""Range quantiles on the store's engine: the batches of a ``query``
traffic (a copy of the reference's mix), the call, the check against the
reference's descent, the quantile kernel's work, and the control.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import corpus, work
from portbench.reference import wavelet
from portbench.systems.analytics_store import padded_shards


def batches(cfg: dict, traffic: dict, seed: int) -> list:
    """The traffic's distinct batches of this seed, (lo, hi, k) numpy."""
    n = int(cfg["n_tokens"])
    return [corpus.make_queries(
        n, int(traffic["batch"]), corpus.substream(seed, 2, j),
        float(traffic["narrow_share"]), int(traffic["narrow_max"]),
        int(traffic["wide_div"])) for j in range(int(traffic["pool"]))]


def call(engine, lo, hi, k):
    """One batch (device answers)."""
    return engine.range_quantile(lo, hi, k)


def control(engine, lo, hi, k):
    """The control's answers: the program's own bracket path, the descent
    cut one level short, answering the bracket's low end (an approximate
    quantile where the configuration states an exact one)."""
    return engine.range_quantile_bracket(lo, hi, k,
                                         engine.shards.nbits - 1)[0]


def check(cfg: dict, tokens: torch.Tensor, batches: list,
          answers: list) -> dict:
    """Wrong answers of the kept batches against the reference's descent;
    ``batches`` (lo, hi, k) numpy, ``answers`` numpy or None where a
    batch's answers never came."""
    dev = tokens.device
    sigma = int(cfg["vocab_size"])
    want = wavelet.quantiles(
        tokens, sigma, [tuple(torch.as_tensor(x, device=dev) for x in b)
                        for b in batches])
    out = {"wrong_answers": 0, "missing_answers": 0}
    for got, ref in zip(answers, want):
        ref = ref.cpu().numpy()
        if got is None or got.shape != ref.shape:
            out["missing_answers"] += ref.shape[0]
        else:
            out["wrong_answers"] += int((np.asarray(got) != ref).sum())
    return out


def bounds_ms(cfg: dict, tokens: torch.Tensor, batches: list) -> list:
    """The quantile kernel's bound on each of ``batches`` ((lo, hi, k)
    tensors): the sharded count-then-refine descent of every batch, level
    by level on the reference's own per-shard matrices, counting the rank
    probes and distinct sectors of each level (``work.level_sectors``)."""
    size_bits = int(cfg["shard_bits"])
    size = 1 << size_bits
    nbits = wavelet.num_levels(int(cfg["vocab_size"]))
    n = tokens.shape[0]
    shards = padded_shards(tokens.long(), size)
    S = shards.shape[0]
    base = (torch.arange(S, device=tokens.device) * size)[:, None]
    state = []
    for lo, hi, k in batches:
        glo = lo.long().clamp(0, n)
        ghi = torch.maximum(hi.long().clamp(0, n), glo)
        los = (glo[None] - base).clamp(0, size)
        his = (ghi[None] - base).clamp(0, size)
        total = (his - los).sum(0)
        k = torch.minimum(k.long().clamp(min=0), (total - 1).clamp(min=0))
        state.append([los, his, k, 0, 0])
    for l, bits, zeros in wavelet.matrix_levels(shards, nbits):
        ones = torch.zeros((S, size + 1), dtype=torch.int64,
                           device=tokens.device)
        ones[:, 1:] = torch.cumsum(bits, 1)
        zl = zeros[:, None]
        for st in state:
            los, his, k = st[0], st[1], st[2]
            probes, sectors = work.level_sectors(los, his, l, nbits,
                                                 size_bits)
            st[3] += probes
            st[4] += sectors
            olo, ohi = ones.gather(1, los), ones.gather(1, his)
            lo0, hi0 = los - olo, his - ohi
            z = (hi0 - lo0).sum(0)
            bit = k >= z
            st[2] = torch.where(bit, k - z, k)
            st[0] = torch.where(bit, zl + olo, lo0)
            st[1] = torch.where(bit, zl + ohi, hi0)
        del ones
    return [work.quantile_bound_ms(b[0].shape[0], st[3], st[4], nbits)
            for b, st in zip(batches, state)]

