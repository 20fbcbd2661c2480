"""Corpus analytics on the port's compressed store — rank/select as a
feature.

The queries a data pipeline gets for free once the corpus is a wavelet
matrix: token frequencies without decompression, streak/position queries
via select, frequency-over-prefix drift via rank, and range analytics —
each checked against the raw stream.

PYTHONPATH=src python examples/torch_corpus_analytics.py           # the card
PYTHONPATH=src python examples/torch_corpus_analytics.py --device cpu \
    --n 16384
"""
import argparse

import numpy as np
import torch

from repro_torch.analytics.engine import sharded_range_quantile_fused
from repro_torch.data import (build_compressed_corpus, make_corpus,
                              token_histogram)
from repro_torch.device import resolve_device


def main(device: str = "cuda", n: int | None = None) -> None:
    dev = resolve_device(device)
    vocab = 8192
    n = n or 1 << 19
    # 8 shards of 2^16 at the default size
    shard_bits = min(16, n.bit_length() - 4)
    toks = make_corpus(n, vocab, seed=42, exponent=1.2)
    corpus = build_compressed_corpus(toks, vocab, shard_bits=shard_bits,
                                     device=dev)
    print(f"{n} tokens, vocab {vocab}: {corpus.bits_per_token():.2f} "
          f"bits/token ({32/corpus.bits_per_token():.2f}× vs uint32)\n")

    # 1. frequency table — no decompression, read off the shard histograms
    hist = token_histogram(corpus).cpu().numpy()
    top = np.argsort(hist)[::-1][:5]
    print("top-5 tokens:", [(int(t), int(hist[t])) for t in top])

    # 2. frequency drift across the corpus (rank prefix-counts):
    #    is token t distributed uniformly or bursty?
    t = int(top[0])
    quarters = [int(corpus.count(t, i * n // 4)) for i in range(1, 5)]
    per_q = np.diff([0] + quarters)
    print(f"token {t} per-quarter counts: {per_q.tolist()} "
          f"(uniform would be ~{hist[t] // 4})")

    # 3. locate occurrences (select): positions of the k-th occurrence,
    #    e.g. for span sampling around rare tokens
    rare = int(np.flatnonzero(hist > 4)[-1])
    k = torch.arange(min(5, int(hist[rare])), device=dev)
    pos = corpus.locate(torch.full(k.shape, rare, device=dev), k
                        ).cpu().numpy()
    print(f"rare token {rare} (count {int(hist[rare])}) first occurrences "
          f"at {pos.tolist()}")
    # verify against the raw stream
    assert np.array_equal(pos, np.flatnonzero(toks == rare)[:len(pos)])

    # 4. gap statistics via consecutive selects — sample 2048 occurrence
    #    pairs; each pair costs two select queries, never touching the
    #    other ~n tokens
    occ = int(hist[t])
    rng = np.random.default_rng(0)
    ks = np.sort(rng.choice(occ - 1, size=min(2048, occ - 1),
                            replace=False)).astype(np.int32)
    ks_t = torch.from_numpy(ks).to(dev)
    tt = torch.full(ks_t.shape, t, device=dev)
    p0 = corpus.locate(tt, ks_t).cpu().numpy()
    p1 = corpus.locate(tt, ks_t + 1).cpu().numpy()
    gaps = p1 - p0
    print(f"token {t} gap stats ({len(ks)} sampled pairs): "
          f"mean {gaps.mean():.1f}, p50 {np.percentile(gaps, 50):.0f}, "
          f"p99 {np.percentile(gaps, 99):.0f}")
    assert np.array_equal(p0, np.flatnonzero(toks == t)[ks])

    # 5. windowed decode — serving path (contiguous slice across shards)
    window = corpus.decode_slice(n // 2 - 8, 16).cpu().numpy()
    print("decoded window around midpoint:", window.tolist())
    assert np.array_equal(window, toks[n // 2 - 8:n // 2 + 8]
                          .astype(window.dtype))

    # 6. range analytics over the same shards: median token per region
    #    (one wm_quantile_sharded launch on the card), band counts,
    #    per-region vocabulary diversity, heaviest tokens of a slice — all
    #    O(logσ)-ish queries, no decode
    q = n // 4
    los = torch.tensor([0, q, 2 * q, 3 * q], device=dev)
    his = los + q
    med = sharded_range_quantile_fused(corpus.shards, corpus.shard_bits,
                                       corpus.n, los, his,
                                       (his - los) // 2).cpu().numpy()
    print(f"\nper-quarter median token: {med.tolist()}")
    band = corpus.range_count(los, his, 0, 256).cpu().numpy()
    print(f"tokens with id < 256 per quarter: {band.tolist()}")
    div = corpus.range_distinct(los, his).cpu().numpy()
    print(f"distinct tokens per quarter: {div.tolist()}")
    syms, cnts = corpus.range_topk(q, 3 * q, 3)
    print(f"top-3 tokens of the middle half: "
          f"{list(zip(syms.cpu().tolist(), cnts.cpu().tolist()))}")
    for i in range(4):
        seg = toks[i * q:(i + 1) * q]
        assert med[i] == np.sort(seg)[len(seg) // 2]
        assert band[i] == int((seg < 256).sum())
        assert div[i] == len(np.unique(seg))
    print("\nall analytics verified against the raw stream ✓")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=None,
                    help="corpus tokens (default 2^19)")
    a = ap.parse_args()
    main(a.device, a.n)
