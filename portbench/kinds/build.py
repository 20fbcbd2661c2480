"""The ``build`` traffic: whole builds back to back, the corpora of the
seed in turn, and the check of each corpus's last build."""
from __future__ import annotations

import time

import torch

from portbench import trace, work
from portbench.harness import (Profiled, Reading, corpora, peak, span,
                               storage_bytes, sync)


def run(ctx: dict) -> dict:
    """Whole builds back to back, the corpora in turn, for the window's
    seconds and at least one build of each corpus: tokens built a second,
    named by the configuration's ``rate_metric``. The window's last build
    of each corpus is kept for the check."""
    cfg, traffic, system, dev = (ctx[k] for k in ("cfg", "traffic", "system",
                                                  "dev"))
    toks = corpora(cfg, traffic, ctx["seed"], dev)
    n = int(cfg["n_tokens"])
    kept = [None] * len(toks)
    for i, t in enumerate(toks):          # warm-up: every shape, every slot
        kept[i] = system.build(cfg, t, dev)
        sync(dev)
    ctx["setup_done"]()
    fresh = [False] * len(toks)
    skip, units = int(traffic["trace_skip"]), int(traffic["trace_units"])
    prof = Profiled(dev) if ctx["trace"] else None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    built, t0 = 0, time.perf_counter()
    while True:
        tracing = prof is not None and skip <= built < skip + units
        if prof is not None and built == skip:
            prof.__enter__()
        i = built % len(toks)
        with span("build", tracing):
            kept[i] = None
            kept[i] = system.build(cfg, toks[i], dev)
            sync(dev)
        fresh[i] = True
        built += 1
        if prof is not None and built == skip + units:
            prof.__exit__(None, None, None)
        elapsed = time.perf_counter() - t0
        if (elapsed >= ctx["seconds"] and built >= len(toks)
                and (prof is None or built >= skip + units)):
            break
    out = {"elapsed": elapsed, "attempted": built, "window_peak": peak(dev),
           "metrics": {cfg["rate_metric"]: built * n / elapsed}}
    if prof is not None:
        tr = prof.trace
        per_build = {k: trace.launches(tr, k) / units
                     for k in work.KERNEL_SYMBOLS}
        bound = {k: units * work.launches_bound_ms(v)
                 for k, v in system.build_work(cfg, per_build).items()}
        out["reading"] = Reading(
            trace=tr, units=units, bound_ms=bound,
            bits_per_token=8 * storage_bytes(system.structure(kept[0])) / n)
    out["toks"], out["kept"], out["fresh"] = toks, kept, fresh
    return out


def check(ctx: dict, out: dict) -> dict:
    """Each corpus's kept build against the reference; a corpus that no
    window build refreshed counts as unchecked."""
    system, cfg, dev = ctx["system"], ctx["cfg"], ctx["dev"]
    totals: dict[str, int] = {}
    unchecked = 0
    for toks, res, fresh in zip(out["toks"], out["kept"], out["fresh"]):
        if not fresh:
            unchecked += 1
            continue
        wrong = system.check_build(cfg, toks, res, dev)
        for k, v in wrong.items():
            totals[k] = totals.get(k, 0) + v
    checks = {k: (v, 0) for k, v in totals.items()}
    checks["unchecked_corpora"] = (unchecked, 0)
    return checks
