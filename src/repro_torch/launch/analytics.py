"""Range-analytics CLI of the port: build a sharded analytics store over the
synthetic corpus, serve a batch of range quantiles (through the
``wm_quantile_sharded`` kernel on a CUDA device) and range counts, and
verify a sample of both against numpy on the raw stream.

PYTHONPATH=src python -m repro_torch.launch.analytics --smoke --device cpu
PYTHONPATH=src python -m repro_torch.launch.analytics --n 134217728 \
    --vocab 151936 --shard-bits 20 --queries 4096

Snapshots, metrics and device traces (the reference's ``--snapshot-dir``,
``--metrics-dir``, ``--profile-dir``) are not ported yet.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.analytics import build_sharded_analytics
from repro_torch.data import make_corpus
from repro_torch.device import resolve_device


def make_queries(n: int, num: int, seed: int):
    """(lo, hi, k) batches: mixed narrow/wide ranges over the corpus (the
    reference's query mix, same stream for the same seed)."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, max(1, n - 1), num).astype(np.int32)
    width = np.where(rng.random(num) < 0.5,
                     rng.integers(1, 256, num),
                     rng.integers(256, max(512, n // 4), num))
    hi = np.minimum(lo + width, n).astype(np.int32)
    k = rng.integers(0, np.maximum(hi - lo, 1)).astype(np.int32)
    return lo, hi, k


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized build + query + verification")
    ap.add_argument("--n", type=int, default=1 << 18)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--shard-bits", type=int, default=14)
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--verify", type=int, default=16,
                    help="# of queries per op to check against numpy")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.smoke:
        args.n = min(args.n, 1 << 14)
        args.vocab = min(args.vocab, 512)
        args.shard_bits = min(args.shard_bits, 12)
        args.queries = min(args.queries, 256)
    dev = resolve_device(args.device)
    toks = make_corpus(args.n, args.vocab, seed=args.seed)

    t0 = time.perf_counter()
    eng = build_sharded_analytics(toks, args.vocab,
                                  shard_bits=args.shard_bits, device=dev)
    _sync(dev)
    t_build = time.perf_counter() - t0
    print(f"build: {args.n} tokens, vocab {args.vocab}, {eng.num_shards} "
          f"shards of {eng.shard_size} in {t_build:.3f}s "
          f"({args.n / t_build:.0f} tok/s, {eng.bits_per_token():.2f} "
          f"bits/token, device {dev})")

    lo, hi, k = make_queries(args.n, args.queries, args.seed + 1)
    sym_lo = (lo % args.vocab).astype(np.int32)
    sym_hi = np.minimum(sym_lo + 64, args.vocab).astype(np.int32)
    lo_t, hi_t, k_t, s0_t, s1_t = (torch.from_numpy(x).to(dev)
                                   for x in (lo, hi, k, sym_lo, sym_hi))
    results = {}
    for name, fn in (("quantile", lambda: eng.range_quantile(lo_t, hi_t, k_t)),
                     ("count", lambda: eng.range_count(lo_t, hi_t, s0_t,
                                                       s1_t))):
        t0 = time.perf_counter()
        results[name] = fn().cpu().numpy()
        t = time.perf_counter() - t0
        print(f"{name}: {args.queries} queries in {t * 1e3:.3f} ms "
              f"({args.queries / t:.0f} q/s)")

    bad = 0
    nv = min(args.verify, args.queries)
    for i in range(nv):
        sl = toks[lo[i]:hi[i]].astype(np.int64)
        want_q = np.partition(sl, k[i])[k[i]] if len(sl) else -1
        if results["quantile"][i] != want_q:
            bad += 1
            print(f"  QUANTILE MISMATCH query {i}")
        want_c = int(((sl >= sym_lo[i]) & (sl < sym_hi[i])).sum())
        if results["count"][i] != want_c:
            bad += 1
            print(f"  COUNT MISMATCH query {i}")
    if bad:
        raise SystemExit(f"{bad} verification failures")
    print(f"verified {nv} samples of each op against numpy")


if __name__ == "__main__":
    main()
