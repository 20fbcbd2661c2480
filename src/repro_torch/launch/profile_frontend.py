"""Where the serving front-end's deadline goes: each batch variant alone,
then the smoke trace's batches as the pump serves them.

    PYTHONPATH=src python -m repro_torch.launch.profile_frontend \\
        [--device cpu] [--runs 3] [--overload 5.0] [--out F.json]

The engine, trace and front-end are ``python -m
repro_torch.launch.frontend --smoke --overload X``'s, taken from that CLI
(``frontend.parse_args``, ``build_engine``, ``make_frontend``, ``run``):
8,192 tokens of ``make_corpus(n, 64, seed=0)``, 8 shards of 2^10, 300
requests of ``make_trace`` with seed 0, buckets 8 and 32, the 250 ms
deadline.

1. **Variants.** Every (op, ladder level, bucket) that the pump can run,
   on a batch of random queries: the median wall time of 5 calls through
   the ``BatchRunner`` (host packing and the answers' copy back
   included) and, on a card, under ``torch.profiler`` the device-busy
   share (the union of kernel and copy intervals over the wall time), the
   kernels launched and the host syncs (the synchronizing calls that
   ``torch.cuda.set_sync_debug_mode`` warns of).
2. **Runs.** The smoke trace at ``--overload`` driven ``--runs`` times
   by the CLI's own ``frontend.run`` (warm-up, paced submission and the
   pump thread, the answer and accounting checks) on one engine. Per batch it records the op, level,
   size, wall time, the port's kernels it launched, the queue wait of the
   requests it took (submission to take) and the admission's per-request
   service estimate at the take;
   per run, each op's accepted p50 and p99, the sheds by reason and the
   deadline misses.

Prints a table of each part and ends in one JSON line (``--out`` writes
it to a file too). On the CPU the launches and syncs read "not measured".
"""
from __future__ import annotations

import argparse
import json
import warnings
from pathlib import Path

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels import build
from repro_torch.launch import frontend as cli
from repro_torch.launch.profile_tree import _busy_us
from repro_torch.serving import QueryFrontend

REPS = 5


def smoke_args(device: str, overload: float):
    """The arguments of ``launch.frontend --smoke --overload X``."""
    return cli.parse_args(["--smoke", "--device", device, "--overload",
                           str(overload)])


def _queries(op: str, bucket: int, n: int, vocab: int, rng) -> np.ndarray:
    lo = rng.integers(0, n - 1, bucket)
    hi = np.minimum(n, lo + rng.integers(1, n, bucket))
    a = (hi - lo) // 2 if op == "quantile" else np.zeros(bucket, np.int64)
    b = np.full(bucket, vocab) if op == "count" else np.zeros(bucket, np.int64)
    return np.stack([lo, hi, a, b]).astype(np.int32)


def variant_rows(args, eng) -> list:
    """One row per (op, level, bucket) of the CLI's front-end: wall ms
    and, on a card, busy share, kernel launches and host syncs of one
    batch."""
    fe = cli.make_frontend(args, eng)
    rng = np.random.default_rng(1)
    rows = []
    for op in ("count", "quantile", "topk"):
        for level in (0, 1, 2):
            mode, fn = fe._op_fn(op, level)
            for bucket in fe.config.buckets:
                q = _queries(op, bucket, args.n, args.vocab, rng)

                def call():
                    return fe.runner.run((op, level), fn, eng, q, bucket)
                call()
                walls = []
                for _ in range(REPS):
                    sw = obs.Stopwatch()
                    call()
                    walls.append(sw.lap())
                row = {"op": op, "level": level, "mode": mode,
                       "bucket": bucket,
                       "wall_ms": float(np.median(walls)) * 1e3,
                       "busy_share": None, "launches": None, "syncs": None}
                if eng.quantile.words.is_cuda:
                    row.update(_card_counts(call))
                rows.append(row)
    return rows


def _card_counts(call) -> dict:
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        sw = obs.Stopwatch()
        call()
        torch.cuda.synchronize()
        wall = sw.lap()
    launches = sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy = _busy_us(prof.events()) / 1e6
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    return {"busy_share": busy / wall, "launches": launches, "syncs": syncs}


class _Recorder:
    """Wraps a front-end's ``queue.take`` and ``runner.run`` to record
    each batch: its op, level, size, queue waits, the service estimate
    at the take, its wall time and the port's kernels it launched
    (``kernels.build.launches``; the breakers' probes, outside the
    batch, are not counted)."""

    def __init__(self, fe: QueryFrontend):
        self.batches = []
        self.fe = fe
        take, run = fe.queue.take, fe.runner.run

        def rec_take(max_n):
            est = fe.queue.service_s
            depth = fe.queue.depth
            batch = take(max_n)
            if batch:
                now = fe.clock.now()
                self.batches.append({
                    "op": batch[0].op, "n": len(batch), "depth": depth,
                    "wait_ms": [1e3 * (now - r.submitted_t) for r in batch],
                    "est_service_ms": 1e3 * est})
            return batch

        def rec_run(key, fn, engine, qargs, n):
            before = dict(build.launches)
            sw = obs.Stopwatch()
            out = run(key, fn, engine, qargs, n)
            self.batches[-1].update(
                level=key[1], batch_ms=1e3 * sw.lap(),
                kernel_launches=sum(v - before[k]
                                    for k, v in build.launches.items()))
            return out

        fe.queue.take, fe.runner.run = rec_take, rec_run


def run_trace(args, toks, eng) -> dict:
    """One run of the CLI (``frontend.run``) on ``eng``, its batches
    recorded; its batches and summary."""
    rec = []
    run = cli.run(args, toks, eng,
                  on_frontend=lambda fe: rec.append(_Recorder(fe)))
    return {"steady_batch_ms": 1e3 * run["steady_s"],
            "summary": run["report"], "shed": run["fe"].stats()["shed"],
            "batches": rec[0].batches}


def _batch_table(batches: list) -> list:
    """Per (op, level): batches, requests, batch ms median and max, queue
    wait ms mean and max, and the estimate against the real per-request
    service ms."""
    rows = {}
    for b in batches:
        rows.setdefault((b["op"], b.get("level", -1)), []).append(b)
    out = []
    for (op, level), bs in sorted(rows.items()):
        ms = [b["batch_ms"] for b in bs if "batch_ms" in b]
        waits = [w for b in bs for w in b["wait_ms"]]
        n = sum(b["n"] for b in bs)
        out.append({
            "op": op, "level": level, "batches": len(bs), "requests": n,
            "kernel_launches_a_batch": sum(b.get("kernel_launches", 0)
                                           for b in bs) / len(bs),
            "batch_ms_median": float(np.median(ms)) if ms else None,
            "batch_ms_max": max(ms) if ms else None,
            "wait_ms_mean": float(np.mean(waits)),
            "wait_ms_max": max(waits),
            "real_service_ms": sum(ms) / n if ms else None,
            "est_service_ms": float(np.mean([b["est_service_ms"]
                                             for b in bs]))})
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--overload", type=float, default=5.0)
    ap.add_argument("--out", type=Path, default=None)
    opts = ap.parse_args(argv)
    args = smoke_args(opts.device, opts.overload)
    toks, eng = cli.build_engine(args)
    dev = eng.quantile.words.device
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"device: {name}")

    variants = variant_rows(args, eng)
    print("op        level mode              bucket  wall ms   busy  "
          "launches syncs")
    for r in variants:
        busy = "—" if r["busy_share"] is None else f"{r['busy_share']:.1%}"
        print(f"{r['op']:9s} {r['level']:5d} {r['mode']:17s} "
              f"{r['bucket']:6d} {r['wall_ms']:8.3f} {busy:>6s} "
              f"{r['launches'] if r['launches'] is not None else '—':>8} "
              f"{r['syncs'] if r['syncs'] is not None else '—':>5}")

    runs = []
    for i in range(opts.runs):
        run = run_trace(args, toks, eng)
        s = run["summary"]
        per = {op: (v["p50_ms"], v["p99_ms"], v["served"])
               for op, v in s["per_op"].items()}
        print(f"run {i + 1}: steady batch {run['steady_batch_ms']:.2f} ms; "
              f"served {s['served']}, shed {run['shed']}, "
              f"{s['deadline_misses']} deadline misses; per op (p50, p99 "
              f"ms, served) {per}")
        table = _batch_table(run["batches"])
        for r in table:
            print(f"    {r['op']:8s} L{r['level']} {r['batches']:3d} batches "
                  f"{r['requests']:4d} req, "
                  f"{r['kernel_launches_a_batch']:.1f} kernel launches a "
                  f"batch; batch ms median "
                  f"{r['batch_ms_median']:.2f} max {r['batch_ms_max']:.2f}; "
                  f"wait ms mean {r['wait_ms_mean']:.1f} max "
                  f"{r['wait_ms_max']:.1f}; service ms a request: real "
                  f"{r['real_service_ms']:.3f}, estimated "
                  f"{r['est_service_ms']:.3f}")
        runs.append({"summary": s, "shed": run["shed"],
                     "steady_batch_ms": run["steady_batch_ms"],
                     "by_op_level": table,
                     "batches": [{k: v for k, v in b.items()
                                  if k != "wait_ms"}
                                 | {"wait_ms_max": max(b["wait_ms"])}
                                 for b in run["batches"]]})
    line = json.dumps({"profile_frontend": {"device": name,
                                            "variants": variants,
                                            "runs": runs}})
    if opts.out:
        opts.out.parent.mkdir(parents=True, exist_ok=True)
        opts.out.write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
