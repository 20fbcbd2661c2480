"""Substring search over the corpus on the port — the FM-index as a
feature.

Builds a sharded FM-index over the synthetic Zipfian corpus and runs the
queries a retrieval/dedup pipeline needs: how often does this n-gram occur
(count), where (locate), and how is it distributed across shards — the
whole pattern batch one backward search over (shards, patterns), checked
against the raw stream.

PYTHONPATH=src python examples/torch_corpus_search.py              # the card
PYTHONPATH=src python examples/torch_corpus_search.py --device cpu --n 8192
"""
import argparse

import numpy as np
import torch

from repro_torch.data import make_corpus
from repro_torch.device import resolve_device
from repro_torch.index import build_sharded_index


def main(device: str = "cuda", n: int | None = None) -> None:
    dev = resolve_device(device)
    vocab = 2048
    n = n or 1 << 15
    # 8 shards of 2^12 at the default size
    shard_bits = min(12, n.bit_length() - 4)
    toks = np.asarray(make_corpus(n, vocab, seed=7), np.int64)
    idx = build_sharded_index(toks, vocab, shard_bits=shard_bits, device=dev)
    print(f"{n} tokens, vocab {vocab}: {idx.num_shards} shards, "
          f"{idx.bits_per_token():.1f} bits/token index\n")

    # 1. n-gram frequency: sample 32 bigrams/4-grams from the corpus plus
    #    a few random ones, count them all in one batch
    rng = np.random.default_rng(0)
    B, L = 32, 4
    pats = np.full((B, L), vocab, np.int32)
    lens = np.where(np.arange(B) % 2 == 0, 2, 4).astype(np.int32)
    for i in range(B - 4):
        s = int(rng.integers(0, n - lens[i]))
        pats[i, :lens[i]] = toks[s:s + lens[i]]
    for i in range(B - 4, B):                   # random → likely absent
        pats[i, :lens[i]] = rng.integers(0, vocab, lens[i])

    pats_t = torch.from_numpy(pats).to(dev)
    lens_t = torch.from_numpy(lens).to(dev)
    counts = idx.count(pats_t, lens_t).cpu().numpy()
    top = np.argsort(counts)[::-1][:5]
    print("most frequent sampled n-grams:")
    for i in top:
        print(f"  {pats[i, :lens[i]].tolist()}  ×{counts[i]}")
    print(f"random probes: {counts[B - 4:].tolist()} matches\n")

    # 2. duplication check: an exact repeated span is a dedup signal
    i_top = int(top[0])
    plen = int(lens[i_top])
    where = idx.locate(pats_t[i_top:i_top + 1], lens_t[i_top:i_top + 1],
                       max_hits_per_shard=8).cpu().numpy()[0]
    hits = where[where >= 0]
    print(f"n-gram {pats[i_top, :plen].tolist()} located at "
          f"{hits[:8].tolist()}{'…' if counts[i_top] > 8 else ''}")
    for p0 in hits[:8]:
        assert np.array_equal(toks[p0:p0 + plen], pats[i_top, :plen])

    # 3. shard skew: is the n-gram uniformly spread or bursty?
    by_shard = idx.count_by_shard(pats_t[i_top:i_top + 1],
                                  lens_t[i_top:i_top + 1]).cpu().numpy()[:, 0]
    print(f"per-shard counts: {by_shard.tolist()} "
          f"(uniform ≈ {int(counts[i_top]) / idx.num_shards:.1f})")

    # 4. verify a count against the raw stream — seam stitching makes
    #    count exact globally (shard-boundary-crossing matches included)
    want = int((np.lib.stride_tricks.sliding_window_view(toks, plen)
                == pats[i_top, :plen]).all(axis=1).sum())
    assert int(counts[i_top]) == want
    print("\ncount verified against naive scan of the raw stream ✓")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=None,
                    help="corpus tokens (default 2^15)")
    a = ap.parse_args()
    main(a.device, a.n)
