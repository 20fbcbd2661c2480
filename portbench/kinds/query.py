"""The ``query`` traffic: a closed loop with one caller sending the
batches of its op (``portbench/ops/<op>.py``), and the check of the kept
answers."""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import corpus
from portbench.harness import (Profiled, Reading, corpora, load_op, peak,
                               span, sync)


def run(ctx: dict) -> dict:
    """A closed loop with one caller: each batch of the pool in turn goes
    to the engine, and its answers come to the host before the next is
    sent. A batch's latency runs from the event recorded as it is
    dispatched to the one recorded once its answers are on the host, on
    the device's clock. The answers of the pool's first round and of every
    batch the seed picks are kept for the check."""
    cfg, traffic, system, dev = (ctx[k] for k in ("cfg", "traffic", "system",
                                                  "dev"))
    op = load_op(traffic["op"])
    toks = corpora(cfg, traffic, ctx["seed"], dev)[0]
    engine = system.serve(cfg, toks, dev)
    pool = op.batches(cfg, traffic, ctx["seed"])
    on_dev = [tuple(torch.as_tensor(x, device=dev).contiguous() for x in b)
              for b in pool]
    for b in on_dev[:int(traffic["warmup"])]:
        op.call(engine, *b).cpu()
    sync(dev)
    ctx["setup_done"]()
    P, every = len(pool), int(traffic["keep_every"])
    pick = corpus.substream(ctx["seed"], 3) % every
    skip, units = int(traffic["trace_skip"]), int(traffic["trace_units"])
    prof = Profiled(dev) if ctx["trace"] else None
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
    lat, kept = [], {}
    done, t0 = 0, time.perf_counter()
    while True:
        tracing = prof is not None and skip <= done < skip + units
        if prof is not None and done == skip:
            prof.__enter__()
        b = on_dev[done % P]
        if cuda:
            e0.record()
        else:
            h0 = time.perf_counter()
        with span("batch", tracing):
            ans = op.call(engine, *b)
        with span("readback", tracing):
            ans = ans.cpu()
        if cuda:
            e1.record()
            e1.synchronize()
            lat.append(e0.elapsed_time(e1))
        else:
            lat.append((time.perf_counter() - h0) * 1e3)
        if done < P or (done + pick) % every == 0:
            kept[done] = ans.numpy()
        done += 1
        if prof is not None and done == skip + units:
            prof.__exit__(None, None, None)
        elapsed = time.perf_counter() - t0
        if elapsed >= ctx["seconds"] and (prof is None
                                          or done >= skip + units):
            break
    q = int(traffic["batch"])
    out = {"elapsed": elapsed, "attempted": done * q,
           "window_peak": peak(dev),
           "metrics": {"query_q_s": done * q / elapsed,
                       "query_p95_ms": float(np.percentile(lat, 95))},
           "latencies": lat}
    del engine, ans
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if prof is not None:
        traced = [j % P for j in range(skip, skip + units)]
        distinct = sorted(set(traced))
        bounds = dict(zip(distinct, op.bounds_ms(
            cfg, toks, [on_dev[j] for j in distinct])))
        out["reading"] = Reading(
            trace=prof.trace, units=units,
            bound_ms={"wm_quantile": sum(bounds[j] for j in traced)})
    out["toks"], out["pool"], out["kept"] = toks, pool, kept
    return out


def check(ctx: dict, out: dict) -> dict:
    """The kept batches' answers against the reference."""
    pool, kept = out["pool"], out["kept"]
    idx = sorted(kept)
    wrong = load_op(ctx["traffic"]["op"]).check(
        ctx["cfg"], out["toks"], [pool[i % len(pool)] for i in idx],
        [kept[i] for i in idx])
    checks = {k: (v, 0) for k, v in wrong.items()}
    checks["unchecked_batches"] = (int(len(idx) == 0), 0)
    return checks
