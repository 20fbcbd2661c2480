"""The front-end's count and greedy top-k kernels against their first
designs, timed in turns on the card.

Builds the first CUDA forms, kept unchanged in ``launch/csrc/``
(``wm_count_v1.cu``: a thread a (query, shard) pair, both descents in
full; ``topk_greedy_v1.cu``: a warp a query's frontier, its intervals in a
global scratch allocated a launch), beside the serving kernels
(``kernels/csrc/wm_count.cu``, ``topk_greedy.cu``), on the full-width
engine: 2^27 tokens of ``make_corpus(n, 151936, seed=0)`` in 128 shards of
2^20. At each of the front-end's buckets (8, 32 and 128 queries of
``make_queries``, seed 1) the old and the new kernel answer the same local
ranges: the counts over every symbol, [0, σ), and over random [s0, s1)
pairs (seed 2); the greedy top-k at k = 8 and budgets 48 and 24 (ladder
levels 1 and 2, pruning), and the new one at 48 without its prune. Both must agree, with each other and with the
plain version. Each is timed by CUDA events over back-to-back calls of its
wrapper, and its kernel alone by ``torch.profiler``, in the order old,
new, new, old, so that a drift of the card's clock within the call falls
on both; the time of a kernel is the mean of its two turns, and
``new_over_old`` their ratio (of the wrappers). Noise between calls has
reached 40% (``PERF.md`` §7), so compare the two only within one run.

PYTHONPATH=src python -m repro_torch.launch.sweep_frontend [--out F.json]

Needs a CUDA device and ``nvcc``; there is nothing to measure on the CPU.
"""
from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

import torch

from repro_torch.analytics import build_sharded_analytics
from repro_torch.analytics.engine import local_ranges
from repro_torch.data import make_corpus
from repro_torch.device import resolve_device
from repro_torch.kernels import build, topk_greedy, wm_count
from repro_torch.launch.analytics import make_queries
from repro_torch.launch.sweep_quantile import (event_ms, finish,
                                               profiled_ms, start_source)

N_TOKENS, SIGMA, SHARD_BITS = 1 << 27, 151_936, 20
BUCKETS = (8, 32, 128)
TOPK, BUDGETS = 8, (48, 24)
REPS = 50

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the first designs' C entries (``launch/csrc/*_v1.cu``)
V1_ARGS = {
    "wm_count_v1": {"wm_count_sharded": build.SIGNATURES["wm_count"][
        "wm_count_sharded"]},
    "topk_greedy_v1": {"topk_greedy": ([_P, _P, _I, _I] + [_P, _L] * 3
                                       + [_I, _P] + [_I] * 4 + [_P] * 5)}}


def old_count(lib, op, los, his, a, b):
    """The first count kernel through the serving wrapper
    (``wm_count.wm_count_sharded``, its library swapped for the first
    design's, whose C entry takes the same arguments)."""
    serving = build.library("wm_count")
    build._loaded["wm_count"] = lib
    try:
        return wm_count.wm_count_sharded(op, los, his, a, b)
    finally:
        build._loaded["wm_count"] = serving


def old_topk(lib, op, los, his, k, budget):
    """The first greedy kernel's wrapper (its scratch allocated a
    launch)."""
    dev = op.words.device
    Q, S = los.shape
    cap = 2 * budget + 1
    syms = torch.empty((Q, k), dtype=torch.int32, device=dev)
    cnts = torch.empty((Q, k), dtype=torch.int32, device=dev)
    found = torch.empty((Q,), dtype=torch.int32, device=dev)
    scratch = torch.empty((Q * cap * (2 * S + 4),), dtype=torch.int32,
                          device=dev)
    build.check(lib, lib.topk_greedy(
        los.data_ptr(), his.data_ptr(), Q, S, *op.launch_args[:7],
        op.zeros.data_ptr(), op.nbits, k, budget, 1, scratch.data_ptr(),
        syms.data_ptr(), cnts.data_ptr(), found.data_ptr(),
        build.stream(dev)), "topk_greedy_v1")
    return syms, cnts, found


def turns(old, new, kernel: str) -> dict:
    """ms a call of ``old`` and ``new`` (their wrappers, back to back),
    timed old, new, new, old; and the device ms of their kernels alone
    (``torch.profiler``, the same order)."""
    t = [event_ms([f], REPS) for f in (old, new, new, old)]
    d = [profiled_ms(f, REPS // 2, kernel) for f in (old, new, new, old)]
    o, n = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    out = {"old_ms": o, "new_ms": n, "new_over_old": n / o, "turns_ms": t,
           "device_turns_ms": d}
    if None not in d:
        out["old_device_ms"] = (d[0] + d[3]) / 2
        out["new_device_ms"] = (d[1] + d[2]) / 2
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    started = {name: start_source(name) for name in V1_ARGS}
    toks = make_corpus(N_TOKENS, SIGMA, seed=0)
    eng = build_sharded_analytics(toks, SIGMA, shard_bits=SHARD_BITS,
                                  device=dev)
    del toks
    op = eng.quantile
    libs = {name: finish(st, V1_ARGS[name]) for name, st in started.items()}
    print(f"card: {torch.cuda.get_device_name(dev)}; engine: "
          f"{eng.num_shards} shards of 2^{SHARD_BITS}, {op.nbits} levels")
    lo, hi, _ = (torch.from_numpy(x).to(dev)
                 for x in make_queries(N_TOKENS, max(BUCKETS), 1))
    gen = torch.Generator(device=dev).manual_seed(2)
    rnd = torch.randint(0, SIGMA + 1, (2, max(BUCKETS)), generator=gen,
                        device=dev, dtype=torch.int32).sort(0).values
    rows = []
    for q in BUCKETS:
        # int32 and contiguous, as both C entries read them: the new
        # wrapper then converts nothing
        los, his = (t.T.to(torch.int32).contiguous() for t in local_ranges(
            SHARD_BITS, eng.num_shards, N_TOKENS, lo[:q], hi[:q], dev))
        ranges = {"all": (torch.zeros(q, dtype=torch.int32, device=dev),
                          torch.full((q,), SIGMA, dtype=torch.int32,
                                     device=dev)),
                  "random": (rnd[0, :q].contiguous(),
                             rnd[1, :q].contiguous())}
        for tag, (a, b) in ranges.items():
            want = wm_count.wm_count_plain(op, los, his, a, b)
            ok = (torch.equal(old_count(libs["wm_count_v1"], op, los, his, a,
                                        b), want)
                  and torch.equal(wm_count.wm_count_sharded(op, los, his, a,
                                                            b), want))
            row = {"kernel": "wm_count", "queries": q, "symbols": tag,
                   "equal": ok, **turns(
                       lambda: old_count(libs["wm_count_v1"], op, los, his,
                                         a, b),
                       lambda: wm_count.wm_count_sharded(op, los, his, a,
                                                         b),
                       "wm_count_kernel")}
            rows.append(row)
            print(json.dumps(row))
        # the new kernel without its prune, alone: what the prune costs
        row = {"kernel": "topk_greedy_no_prune", "queries": q, "budget": 48,
               "ms": event_ms([lambda: topk_greedy.topk_greedy(
                   op, los, his, TOPK, 48, False)], REPS),
               "device_ms": profiled_ms(lambda: topk_greedy.topk_greedy(
                   op, los, his, TOPK, 48, False), REPS // 2,
                   "topk_greedy_kernel")}
        rows.append(row)
        print(json.dumps(row))
        for budget in BUDGETS:
            want = topk_greedy.topk_greedy_plain(op, los, his, TOPK, budget)
            got_old = old_topk(libs["topk_greedy_v1"], op, los, his, TOPK,
                               budget)
            got_new = topk_greedy.topk_greedy(op, los, his, TOPK, budget)
            ok = all(torch.equal(x, y) and torch.equal(z, y)
                     for x, y, z in zip(got_old, want, got_new))
            row = {"kernel": "topk_greedy", "queries": q, "budget": budget,
                   "equal": ok, **turns(
                       lambda: old_topk(libs["topk_greedy_v1"], op, los, his,
                                        TOPK, budget),
                       lambda: topk_greedy.topk_greedy(op, los, his, TOPK,
                                                       budget),
                       "topk_greedy_kernel")}
            rows.append(row)
            print(json.dumps(row))
    if not all(r.get("equal", True) for r in rows):
        raise SystemExit("sweep_frontend: the kernels disagree")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))
    print(json.dumps({"sweep_frontend": {
        f"{r['kernel']}_{r['queries']}_{r.get('symbols', r.get('budget'))}":
            round(r["new_over_old"], 4) for r in rows
        if "new_over_old" in r}}))


if __name__ == "__main__":
    main()
