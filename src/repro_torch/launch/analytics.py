"""Range-analytics CLI of the port: build (or restore) a sharded analytics
store over the synthetic corpus, serve a batch of range quantiles (through
the ``wm_quantile_sharded`` kernel on a CUDA device), range counts, exact
top-k and distinct counts, and verify a sample of each against numpy on the
raw stream.

PYTHONPATH=src python -m repro_torch.launch.analytics --smoke --device cpu
PYTHONPATH=src python -m repro_torch.launch.analytics --smoke --device cpu \
    --snapshot-dir /tmp/snap      # twice: build + save, then restore
PYTHONPATH=src python -m repro_torch.launch.analytics --n 134217728 \
    --vocab 151936 --shard-bits 20 --queries 4096
PYTHONPATH=src python -m repro_torch.launch.analytics --smoke --device cpu \
    --metrics-dir /tmp/m
PYTHONPATH=src python -m repro_torch.launch.obs /tmp/m     # then inspect

``--snapshot-dir`` restores the engine when the snapshot's geometry and
corpus seed match the run (derived-leaf corruption is repaired on the way),
ignores a directory holding something else, warns and rebuilds when the
restore fails (a failure of the device, ``kernels.build.DEVICE_ERRORS``,
is raised instead), and saves after a build. The build is retried twice with
backoff (``robust.with_retry``), as the reference's is.

``--metrics-dir`` captures the run through ``repro_torch.obs``, as the
reference's does: per-op ``serve.analytics.*`` latency histograms, q/s and
first-call cost, the build and restore spans, the path-selection counters
and a JSONL event log, rendered by ``repro_torch.launch.obs``. Serving ops
run under ``obs.profiled_op``, and one shard build and a 16-query kernel
batch under ``obs.profile_op``, so the snapshot carries the ``prof.*``
gauges (bytes and int32 operations of the kernel wrappers' work model,
roofline utilization, peak device memory on a card). ``--profile-dir``
wraps the build and the serving section each in a ``torch.profiler`` trace
(``build_trace.json``, ``trace.json``), where the build's stages and the
quantile's ``engine.range_quantile`` stage line up with their kernels;
``python -m repro_torch.launch.obs DIR --stages`` splits them by stage.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import obs
from repro_torch.analytics import (build_sharded_analytics, load_analytics,
                                   save_analytics, snapshot_meta)
from repro_torch.data import make_corpus
from repro_torch.device import resolve_device
from repro_torch.kernels.build import DEVICE_ERRORS
from repro_torch.obs.prof import BUILD_TRACE_FILE
from repro_torch.obs.spans import wait_for
from repro_torch.robust import with_retry


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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized build + query + verification")
    ap.add_argument("--n", type=int, default=1 << 18)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--shard-bits", type=int, default=14)
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--topk", type=int, default=8)
    ap.add_argument("--verify", type=int, default=16,
                    help="# of queries per op to check against numpy")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--snapshot-dir", type=str, default=None,
                    help="persisted analytics snapshot: restore from here "
                         "when present (skipping the build), else build "
                         "and save here")
    ap.add_argument("--metrics-dir", type=str, default=None,
                    help="export obs metrics snapshot + JSONL events here "
                         "(inspect with `python -m repro_torch.launch.obs`)")
    ap.add_argument("--profile-dir", type=str, default=None,
                    help="capture torch.profiler traces of the build and "
                         "of the serving section into this directory")
    args = ap.parse_args(argv)
    if args.metrics_dir:
        obs.configure(args.metrics_dir)
    if args.smoke:
        args.n = min(args.n, 1 << 14)
        args.vocab = min(args.vocab, 512)
        args.shard_bits = min(args.shard_bits, 12)
        args.queries = min(args.queries, 256)
    dev = resolve_device(args.device)
    toks = make_corpus(args.n, args.vocab, seed=args.seed)

    sw = obs.Stopwatch()
    eng, restored, save_snapshot = None, False, bool(args.snapshot_dir)
    if args.snapshot_dir:
        # geometry AND corpus identity must match what this run verifies
        # against, else a stale snapshot would serve the wrong corpus
        try:
            meta = snapshot_meta(args.snapshot_dir)
            got = (meta["n"], meta["sigma"], meta["shard_bits"],
                   meta.get("corpus_seed"))
            want = (args.n, args.vocab, args.shard_bits, args.seed)
            if got == want:
                # derived-leaf corruption is repaired on the way; primary
                # corruption raises and the engine is rebuilt below
                eng = load_analytics(args.snapshot_dir, device=dev)
                restored = True
            else:
                print(f"snapshot (n, vocab, shard_bits, seed)={got} does "
                      f"not match requested {want} — rebuilding")
        except FileNotFoundError:
            pass
        except ValueError as e:
            # someone else's checkpoint: rebuild, and never overwrite it
            print(f"ignoring --snapshot-dir: {e}")
            save_snapshot = False
        except DEVICE_ERRORS:
            raise                       # the card failed, not the snapshot
        except Exception as e:                      # noqa: BLE001
            # an unusable snapshot (unrepairable corruption, torn write,
            # missing leaves) must not take serving down: rebuild
            print(f"WARNING: snapshot restore failed ({type(e).__name__}: "
                  f"{e}) — rebuilding from source")
    if not restored:
        with obs.trace(args.profile_dir, BUILD_TRACE_FILE), \
                obs.span("analytics.build", n=args.n, vocab=args.vocab,
                         shard_bits=args.shard_bits) as sp:
            eng = sp.sync(with_retry(
                lambda: build_sharded_analytics(toks, args.vocab,
                                                shard_bits=args.shard_bits,
                                                device=dev),
                retries=2, backoff_s=0.1,
                on_retry=lambda a, e: print(
                    f"build attempt {a + 1} failed ({e}) — retrying")))
    wait_for(eng)
    t_build = sw.lap()
    obs.gauge("serve.analytics.build_s").set(t_build)
    obs.gauge("serve.analytics.tokens_per_s").set(args.n / max(t_build,
                                                               1e-9))
    verb = "restore" if restored else "build"
    print(f"{verb}: {args.n} tokens, vocab {args.vocab}, {eng.num_shards} "
          f"shards of {eng.shard_size} in {t_build:.3f}s "
          f"({args.n / t_build:.0f} tok/s, {eng.bits_per_token():.2f} "
          f"bits/token, device {dev})")
    if save_snapshot and not restored:
        path = save_analytics(eng, args.snapshot_dir,
                              extra_meta={"corpus_seed": args.seed})
        print(f"snapshot saved → {path}")

    lo, hi, k = make_queries(args.n, args.queries, args.seed + 1)
    sym_lo = (lo % args.vocab).astype(np.int32)
    sym_hi = np.minimum(sym_lo + 64, args.vocab).astype(np.int32)
    lo_t, hi_t, k_t, s0_t, s1_t = (torch.from_numpy(x).to(dev)
                                   for x in (lo, hi, k, sym_lo, sym_hi))
    B = args.queries
    obs.gauge("serve.analytics.coverage").set(
        float(eng.coverage(0, args.n)))

    # the work-model profile of the construction path (one shard-sized
    # build) and of the quantile kernel, beside the serving ops below
    from repro_torch.core.wavelet_matrix import build_wavelet_matrix
    shard0 = torch.from_numpy(toks[:eng.shard_size].astype(np.int32)).to(dev)
    _, cstats = obs.profile_op(
        "analytics.construct_shard",
        lambda s: build_wavelet_matrix(s, eng.sigma, device=dev),
        shard0, work_elements=float(eng.shard_size))
    if "roofline_util" in cstats:
        print(f"construct_shard: roofline {cstats['roofline_util']:.1%} "
              f"({cstats.get('bound', '?')}-bound)")
    nk = min(16, B)
    _, kstats = obs.profile_op(
        "analytics.quantile_kernel",
        lambda e, a, b, c: e.range_quantile(a, b, c),
        eng, lo_t[:nk], hi_t[:nk], k_t[:nk], work_elements=float(nk))
    if "error" in kstats:
        print(f"quantile_kernel profile skipped: {kstats['error']}")

    results = {}
    with obs.span("analytics.serve", queries=B), obs.trace(args.profile_dir):
        ops = {
            "quantile": (lambda e, a, b, c: e.range_quantile(a, b, c),
                         (eng, lo_t, hi_t, k_t)),
            "count": (lambda e, a, b, s0, s1: e.range_count(a, b, s0, s1),
                      (eng, lo_t, hi_t, s0_t, s1_t)),
            "topk": (lambda e, a, b: e.range_topk(a, b, args.topk),
                     (eng, lo_t, hi_t)),
            "distinct": (lambda e, a, b: e.range_distinct(a, b),
                         (eng, lo_t, hi_t)),
        }
        for name, (fn, fargs) in ops.items():
            out, t, t_first = obs.profiled_op("analytics", name, fn, *fargs,
                                              batch=B)
            results[name] = (tuple(x.cpu().numpy() for x in out)
                             if isinstance(out, tuple)
                             else out.cpu().numpy())
            print(f"{name}: {B} queries in {t * 1e3:.3f} ms "
                  f"({B / t:.0f} q/s; first call {t_first:.3f} s)")
    if args.profile_dir:
        print(f"device trace → {args.profile_dir}")

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
        if results["distinct"][i] != len(np.unique(sl)):
            bad += 1
            print(f"  DISTINCT MISMATCH query {i}")
        bc = np.bincount(sl, minlength=args.vocab)
        want_top = np.sort(bc[bc > 0])[::-1][:args.topk]
        syms_i, cnts_i = results["topk"][0][i], results["topk"][1][i]
        if not (np.array_equal(cnts_i[syms_i >= 0], want_top)
                and np.array_equal(bc[syms_i[syms_i >= 0]],
                                   cnts_i[syms_i >= 0])):
            bad += 1
            print(f"  TOPK MISMATCH query {i}")
    if bad:
        raise SystemExit(f"{bad} verification failures")
    print(f"verified {nv} samples of each op against numpy ✓")
    if args.metrics_dir:
        obs.write_snapshot()
        obs.configure(None)
        print(f"metrics → {args.metrics_dir}")


if __name__ == "__main__":
    main()
