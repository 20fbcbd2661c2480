"""Full-text index CLI of the port: build a sharded FM-index over the
synthetic corpus and serve a batch of substring count/locate queries.

PYTHONPATH=src python -m repro_torch.launch.index --smoke --device cpu
PYTHONPATH=src python -m repro_torch.launch.index --n 262144 --vocab 4096 \
    --shard-bits 14 --patterns 256 --pattern-len 8
PYTHONPATH=src python -m repro_torch.launch.index --smoke --drop-shards 1,3
    # degraded mode: lost shards are served around with an explicit
    # coverage fraction and lower/upper count bounds
PYTHONPATH=src python -m repro_torch.launch.index --smoke --device cpu \
    --metrics-dir /tmp/m --profile-dir /tmp/p

Build: per-shard prefix-doubling suffix array → BWT → wavelet matrix
(paper Theorem 4.5) → sampled-SA directories, every shard at once (the
``radix_rank``, ``wm_level_step``, ``rank_build_levels`` and ``bitpack``
kernels on a CUDA device). Query: one backward search over (shards,
patterns); every step is two wavelet-matrix ranks. A sample of counts is
verified against naive numpy substring search on the raw stream.

``--metrics-dir`` captures the run through ``repro_torch.obs`` as the
reference's does: the ``index.build`` span, the count under
``obs.profiled_op`` (``serve.index.count.*`` and its ``prof.*`` gauges),
locate and the degraded bounds under ``obs.timed_op``, the coverage gauge
and the path counters. ``--profile-dir`` wraps the build and the count
each in a ``torch.profiler`` trace (``build_trace.json``, ``trace.json``);
``python -m repro_torch.launch.obs DIR --stages`` splits the build by
stage.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import obs
from repro_torch.data import make_corpus
from repro_torch.device import resolve_device
from repro_torch.index import build_sharded_index, sample_patterns
from repro_torch.obs.prof import BUILD_TRACE_FILE


def naive_count(toks: np.ndarray, pat: np.ndarray, plen: int,
                shard_size: int, stitch_max: int) -> int:
    """Count oracle matching the index's guarantee: global sliding count
    when seam stitching covers the pattern (plen ≤ stitch_max), else the
    within-shard count (crossing matches are out of the exactness domain
    and deliberately uncounted)."""
    if plen == 0 or plen > len(toks):
        return 0
    if plen <= stitch_max:
        win = np.lib.stride_tricks.sliding_window_view(toks, plen)
        return int((win == pat[:plen]).all(axis=1).sum())
    total = 0
    for s0 in range(0, len(toks), shard_size):
        sh = toks[s0:s0 + shard_size]
        if plen > len(sh):
            continue
        win = np.lib.stride_tricks.sliding_window_view(sh, plen)
        total += int((win == pat[:plen]).all(axis=1).sum())
    return total


def naive_count_degraded(toks: np.ndarray, pat: np.ndarray, plen: int,
                         shard_size: int, stitch_max: int,
                         avail: np.ndarray) -> int:
    """Degraded-mode count oracle: within-shard matches on available
    shards, plus boundary-crossing matches (when stitching covers the
    pattern) at seams whose BOTH shards are available."""
    if plen == 0 or plen > len(toks):
        return 0
    total = 0
    starts = list(range(0, len(toks), shard_size))
    for s, s0 in enumerate(starts):
        if not avail[s]:
            continue
        sh = toks[s0:s0 + shard_size]
        if plen > len(sh):
            continue
        win = np.lib.stride_tricks.sliding_window_view(sh, plen)
        total += int((win == pat[:plen]).all(axis=1).sum())
    if 2 <= plen <= stitch_max:
        for s in range(len(starts) - 1):
            if not (avail[s] and avail[s + 1]):
                continue
            b = (s + 1) * shard_size
            for p0 in range(max(0, b - plen + 1), b):
                if p0 + plen > len(toks):
                    break
                if np.array_equal(toks[p0:p0 + plen], pat[:plen]):
                    total += 1
    return total


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized build + query + verification")
    ap.add_argument("--n", type=int, default=1 << 17)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--shard-bits", type=int, default=13)
    ap.add_argument("--patterns", type=int, default=128)
    ap.add_argument("--pattern-len", type=int, default=8)
    ap.add_argument("--sample-rate", type=int, default=32)
    ap.add_argument("--verify", type=int, default=16,
                    help="# of counts to check against naive numpy")
    ap.add_argument("--drop-shards", type=str, default=None,
                    help="comma-separated shard ids to mark unavailable: "
                         "serves surviving shards with an explicit "
                         "coverage fraction and count bounds")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--metrics-dir", type=str, default=None,
                    help="export obs metrics snapshot + JSONL events here "
                         "(inspect with `python -m repro_torch.launch.obs`)")
    ap.add_argument("--profile-dir", type=str, default=None,
                    help="capture torch.profiler traces of the build and "
                         "of the query section into this directory")
    args = ap.parse_args(argv)
    if args.metrics_dir:
        obs.configure(args.metrics_dir)
    if args.smoke:
        args.n = min(args.n, 1 << 14)
        args.shard_bits = min(args.shard_bits, 11)
        args.patterns = min(args.patterns, 64)
    dev = resolve_device(args.device)

    toks = make_corpus(args.n, args.vocab, seed=args.seed).astype(np.int64)
    sw = obs.Stopwatch()
    with obs.trace(args.profile_dir, BUILD_TRACE_FILE), \
            obs.span("index.build", n=args.n, vocab=args.vocab,
                     shard_bits=args.shard_bits) as sp:
        idx = sp.sync(build_sharded_index(
            toks, args.vocab, shard_bits=args.shard_bits,
            sample_rate=args.sample_rate, device=dev))
    t_build = sw.lap()
    obs.gauge("serve.index.build_s").set(t_build)
    print(f"build: {args.n} tokens, vocab {args.vocab}, "
          f"{idx.num_shards} shards of {idx.shard_size} in {t_build:.3f}s "
          f"({args.n / t_build / 1e3:.0f} ktok/s, "
          f"{idx.bits_per_token():.1f} bits/token, device {dev})")

    pats, lens = sample_patterns(toks, args.patterns, args.pattern_len,
                                 pad=args.vocab, seed=args.seed + 1)
    pt, lt = torch.from_numpy(pats).to(dev), torch.from_numpy(lens).to(dev)

    with obs.trace(args.profile_dir):
        out, t_query, t_first = obs.profiled_op(
            "index", "count", lambda ix, p, l: ix.count(p, l), idx, pt, lt,
            batch=args.patterns)
    counts = out.cpu().numpy()
    print(f"count: {args.patterns} patterns in {t_query * 1e3:.1f} ms "
          f"({args.patterns / t_query:.0f} patterns/s; first call "
          f"{t_first:.3f} s); hits: "
          f"min {counts.min()} median {int(np.median(counts))} "
          f"max {counts.max()}")
    if args.profile_dir:
        print(f"device trace → {args.profile_dir}")

    out, t_loc, _ = obs.timed_op(
        "index", "locate", lambda ix, p, l: ix.locate(p, l, 4), idx, pt, lt,
        batch=args.patterns)
    pos = out.cpu().numpy()
    print(f"locate: {args.patterns} patterns × ≤{4 * idx.num_shards} hits "
          f"in {t_loc * 1e3:.1f} ms")

    bad = 0
    stitch_max = min(idx.seam_overlap + 1, idx.shard_size)
    nv = min(args.verify, args.patterns)
    for i in range(nv):
        want = naive_count(toks, pats[i], int(lens[i]), idx.shard_size,
                           stitch_max)
        if int(counts[i]) != want:
            bad += 1
            print(f"  MISMATCH pattern {i}: got {counts[i]}, want {want}")
        first = pos[i][pos[i] >= 0][:1]
        if first.size:
            p0 = int(first[0])
            if not np.array_equal(toks[p0:p0 + int(lens[i])],
                                  pats[i, :int(lens[i])]):
                bad += 1
                print(f"  BAD LOCATE pattern {i} at {p0}")
    if bad:
        raise SystemExit(f"{bad} verification failures")
    print(f"verified {nv} count/locate samples against naive numpy")

    if args.drop_shards:
        drop = sorted({int(x) for x in args.drop_shards.split(",") if x})
        out_of_range = [s for s in drop if not 0 <= s < idx.num_shards]
        if out_of_range:
            raise SystemExit(f"--drop-shards ids {out_of_range} outside "
                             f"[0, {idx.num_shards})")
        deg = idx.drop_shards(drop)
        cov = float(deg.coverage())
        obs.gauge("serve.index.coverage").set(cov)
        print(f"degraded mode: dropped shards {drop} "
              f"({cov * 100:.1f}% coverage)")
        (lower, upper, _), _, _ = obs.timed_op(
            "index", "count_bounds", lambda ix, p, l: ix.count_bounds(p, l),
            deg, pt, lt, batch=args.patterns)
        lower, upper = lower.cpu().numpy(), upper.cpu().numpy()
        avail = np.ones(idx.num_shards, bool)
        avail[drop] = False
        bad = 0
        for i in range(nv):
            plen = int(lens[i])
            want_deg = naive_count_degraded(toks, pats[i], plen,
                                            idx.shard_size, stitch_max,
                                            avail)
            full = naive_count(toks, pats[i], plen, idx.shard_size,
                               stitch_max)
            if int(lower[i]) != want_deg:
                bad += 1
                print(f"  DEGRADED MISMATCH pattern {i}: got {lower[i]}, "
                      f"want {want_deg}")
            if not int(lower[i]) <= full <= int(upper[i]):
                bad += 1
                print(f"  BOUNDS VIOLATION pattern {i}: true {full} outside "
                      f"[{lower[i]}, {upper[i]}]")
        if bad:
            raise SystemExit(f"{bad} degraded-mode verification failures")
        print("degraded counts verified against the surviving-shard oracle; "
              "bounds bracket the full-corpus truth")

    if args.metrics_dir:
        obs.write_snapshot()
        obs.configure(None)
        print(f"metrics → {args.metrics_dir}")


if __name__ == "__main__":
    main()
