"""Query front-end CLI of the port: drive a bursty request trace at the
overload-hardened serving front-end, report shed/degrade/latency behaviour,
and check the answers.

PYTHONPATH=src python -m repro_torch.launch.frontend --smoke --device cpu
PYTHONPATH=src python -m repro_torch.launch.frontend --overload 5.0 \\
    --requests 2000 --deadline-ms 50
PYTHONPATH=src python -m repro_torch.launch.frontend --smoke \\
    --record-trace /tmp/burst.jsonl                # record the trace
PYTHONPATH=src python -m repro_torch.launch.frontend --smoke \\
    --replay /tmp/burst.jsonl --overload 5.0       # replay it 5× faster

The trace is a bursty arrival process (quiet base load with periodic
storm windows, seeded) of mixed count/quantile/top-k queries, the
reference's for the same seed; ``--replay`` drives a recorded trace
instead, and ``--overload X`` compresses either in time by X (the same
requests offered X× faster). Submission is paced on the shared
``robust.Clock`` with catch-up: a submitter behind schedule submits at
once rather than thinning the offered load. The run ends in a check:
every sampled exact answer equals numpy's on the raw stream, every
sampled degraded answer brackets it, and ``submitted == served + shed +
queued``. Metrics and device traces (the reference's ``--metrics-dir`` and
``--profile-dir``) are not ported yet.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from repro_torch.analytics.engine import build_sharded_analytics
from repro_torch.data import make_corpus
from repro_torch.device import resolve_device
from repro_torch.ingest.serving import GenerationServer
from repro_torch.serving import (BreakerConfig, FrontendConfig, QueryFrontend,
                                 ShedError)

#: sampled answers a check holds against the oracle, per op and kind
MAX_CHECKS = 64

#: the CLI's breaker timings: the library defaults (50 ms logical
#: deadline, 250 ms interval) are sized for FakeClock chaos tests; a real
#: probe costs milliseconds to tens of them, so keep a margin or every
#: breaker opens spuriously
CLI_BREAKER = BreakerConfig(probe_timeout_s=2.0, probe_interval_s=5.0,
                            reset_after_s=2.0)


def make_trace(n: int, requests: int, seed: int, *, base_qps: float,
               burst_qps: float, burst_every_s: float, burst_len_s: float,
               deadline_s: float, topk_k: int) -> list:
    """Bursty arrival schedule: quiet base load punctuated by storm
    windows. Returns [{t, op, lo, hi, k, deadline_s}, ...] sorted by t
    (the reference's trace for the same arguments)."""
    rng = np.random.default_rng(seed)
    events, t = [], 0.0
    ops = ("count", "quantile", "topk")
    while len(events) < requests:
        in_burst = (t % burst_every_s) < burst_len_s
        rate = burst_qps if in_burst else base_qps
        t += float(rng.exponential(1.0 / rate))
        lo = int(rng.integers(0, max(1, n - 1)))
        hi = int(rng.integers(lo + 1, n + 1))
        op = ops[int(rng.integers(0, len(ops)))]
        events.append({
            "t": round(t, 6), "op": op, "lo": lo, "hi": hi,
            "k": (int(rng.integers(0, hi - lo)) if op == "quantile"
                  else (topk_k if op == "topk" else None)),
            "deadline_s": deadline_s,
        })
    return events


def load_trace(path: str) -> list:
    return [json.loads(ln) for ln in Path(path).read_text().splitlines()
            if ln.strip()]


def save_trace(path: str, trace: list) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text("".join(json.dumps(e) + "\n" for e in trace))


def drive(fe: QueryFrontend, trace: list, overload: float, sigma: int):
    """Paced catch-up submission of the (time-compressed) trace; returns
    the tickets in submission order."""
    clock = fe.clock
    t0 = clock.now()
    tickets = []
    for ev in trace:
        target = t0 + ev["t"] / max(overload, 1e-9)
        lag = target - clock.now()
        if lag > 0:
            clock.sleep(lag)         # on schedule; behind ⇒ submit now
        kw = {"deadline_s": ev.get("deadline_s")}
        if ev["op"] == "quantile":
            kw["k"] = ev["k"]
        elif ev["op"] == "count":
            kw["sym_lo"], kw["sym_hi"] = 0, sigma
        tickets.append(fe.submit(ev["op"], ev["lo"], ev["hi"], **kw))
    return tickets


def _summary(results: list, wall_s: float) -> dict:
    """Counts, rates and accepted latency of (answer or ShedError) results."""
    answers = [r for r in results if not isinstance(r, ShedError)]
    reasons: dict = {}
    for r in results:
        if isinstance(r, ShedError):
            reasons[r.reason] = reasons.get(r.reason, 0) + 1
    lats = [a.latency_s for a in answers]
    shed = len(results) - len(answers)
    return {
        "offered": len(results),
        "served": len(answers),
        "shed": shed,
        "shed_rate": shed / max(1, len(results)),
        "shed_reasons": reasons,
        "degraded": sum(bool(a.degraded) for a in answers),
        "deadline_misses": sum(not a.deadline_met for a in answers),
        "qps": len(answers) / max(wall_s, 1e-9),
        "p50_ms": float(np.percentile(lats, 50)) * 1e3 if lats else 0.0,
        "p99_ms": float(np.percentile(lats, 99)) * 1e3 if lats else 0.0,
    }


def collect(tickets: list) -> list:
    """Every ticket's Answer, or its ShedError (any other error raises)."""
    out = []
    for t in tickets:
        try:
            out.append(t.result(timeout=60.0))
        except ShedError as e:
            out.append(e)
    return out


def report(fe: QueryFrontend, trace: list, results: list,
           wall_s: float) -> dict:
    """The run's numbers, overall and per op; ``wall_s`` spans the first
    submit to the last result (the q/s denominator)."""
    out = _summary(results, wall_s)
    out["final_level"] = fe.ladder.level
    out["per_op"] = {op: _summary([r for ev, r in zip(trace, results)
                                   if ev["op"] == op], wall_s)
                     for op in ("count", "quantile", "topk")}
    return out


def check_answers(toks: np.ndarray, sigma: int, trace: list,
                  results: list, max_checks: int = MAX_CHECKS) -> int:
    """Hold up to ``max_checks`` exact and as many degraded answers of
    each op against numpy on the raw stream: an exact answer at full
    coverage must equal it, any other must bracket it (a count's
    bounds, or a masked count below it; a quantile bracket; a top-k's
    counts must be true counts). Raises on a mismatch; returns the
    answers checked."""
    seen: dict = {}
    for ev, a in zip(trace, results):
        if isinstance(a, ShedError):
            continue
        exact = a.mode == "exact" and a.coverage == 1.0
        kind = (ev["op"], exact)
        if seen.get(kind, 0) >= max_checks:
            continue
        seen[kind] = seen.get(kind, 0) + 1
        sl = toks[ev["lo"]:ev["hi"]].astype(np.int64)
        if ev["op"] == "count":
            want = int(((sl >= 0) & (sl < sigma)).sum())
            lower, upper = (a.value if isinstance(a.value, tuple)
                            else (a.value, a.value if exact else want))
            ok = lower <= want <= upper
        elif ev["op"] == "quantile":
            want = int(np.partition(sl, ev["k"])[ev["k"]]) if sl.size else -1
            if exact:
                ok = a.value == want
            else:       # a bracket; a masked quantile names no bound
                ok = (not isinstance(a.value, tuple)
                      or a.value[0] <= want < a.value[1])
        else:
            bc = np.bincount(sl, minlength=sigma)
            syms, cnts = a.value
            live = syms >= 0
            want = np.sort(bc[bc > 0])[::-1][:len(cnts)]
            ok = bool(np.array_equal(bc[syms[live]], cnts[live])) and (
                not exact or bool(np.array_equal(cnts[live], want)))
        if not ok:
            raise AssertionError(f"{ev['op']} [{ev['lo']}, {ev['hi']}) "
                                 f"({a.mode}): {a.value} against numpy "
                                 f"{want}")
    return sum(seen.values())


def warm_up(fe: QueryFrontend, n: int, sigma: int) -> float:
    """Run every (op, level, bucket) once and re-seed the admission EWMA
    from a steady-state batch, as the reference does: warm-up pumps feed
    first-call service times into the EWMA, which would otherwise shed
    the trace as over_budget before it starts. Returns the steady batch's
    seconds."""
    eng = fe.server.engine
    warm = (("count", {"sym_hi": sigma}), ("quantile", {"k": 0}),
            ("topk", {}))
    for op, kw in warm:
        for bucket in fe.config.buckets:
            for _ in range(bucket):
                fe.submit(op, 0, n, deadline_s=600.0, **kw)
            while fe.queue.depth:
                fe.pump()
            for level in (1, 2):
                mode, fn = fe._op_fn(op, level)
                fe.runner.run((op, level), fn, eng,
                              np.zeros((4, bucket), np.int32), bucket)
    batch = fe.runner.max_batch
    steady_s = 0.0
    for _ in range(2):       # the first batch may absorb a probe refresh
        for _ in range(batch):
            fe.submit("count", 0, n, deadline_s=600.0, sym_hi=sigma)
        t0 = time.perf_counter()
        fe.pump()
        steady_s = time.perf_counter() - t0
    for _ in range(30):
        fe.queue.observe_service(steady_s, batch)
    return steady_s


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized corpus + short trace")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=1 << 16)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--shard-bits", type=int, default=12)
    ap.add_argument("--requests", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--overload", type=float, default=1.0,
                    help="compress the trace in time by this factor "
                         "(5.0 ⇒ the same requests offered 5× faster)")
    ap.add_argument("--base-qps", type=float, default=200.0)
    ap.add_argument("--burst-qps", type=float, default=2000.0)
    ap.add_argument("--deadline-ms", type=float, default=250.0)
    ap.add_argument("--capacity", type=int, default=256)
    ap.add_argument("--topk-k", type=int, default=8)
    ap.add_argument("--replay", type=str, default=None,
                    help="drive a recorded trace (JSONL) instead of "
                         "generating one")
    ap.add_argument("--record-trace", type=str, default=None,
                    help="write the generated trace here (JSONL) for "
                         "later --replay")
    args = ap.parse_args(argv)
    if args.smoke:
        args.n = min(args.n, 1 << 13)
        args.vocab = min(args.vocab, 64)
        args.shard_bits = min(args.shard_bits, 10)
        args.requests = min(args.requests, 300)
    dev = resolve_device(args.device)

    toks = np.asarray(make_corpus(args.n, args.vocab, seed=args.seed),
                      np.int64)
    t0 = time.perf_counter()
    eng = build_sharded_analytics(toks, args.vocab,
                                  shard_bits=args.shard_bits, device=dev)
    eng.probe_shard(0)   # first call before the breakers time it
    print(f"engine: {args.n} tokens, {eng.num_shards} shards "
          f"in {time.perf_counter() - t0:.2f}s (device {dev})")

    if args.replay:
        trace = load_trace(args.replay)
        print(f"replaying {len(trace)} requests from {args.replay} "
              f"at {args.overload:.1f}× speed")
    else:
        trace = make_trace(args.n, args.requests, args.seed,
                           base_qps=args.base_qps,
                           burst_qps=args.burst_qps,
                           burst_every_s=2.0, burst_len_s=0.5,
                           deadline_s=args.deadline_ms / 1e3,
                           topk_k=args.topk_k)
        if args.record_trace:
            save_trace(args.record_trace, trace)
            print(f"trace → {args.record_trace} ({len(trace)} requests)")

    fe = QueryFrontend(
        GenerationServer(eng),
        config=FrontendConfig(
            capacity=args.capacity, topk_k=args.topk_k,
            buckets=(8, 32) if args.smoke else (8, 32, 128),
            breaker=CLI_BREAKER))
    t0 = time.perf_counter()
    steady_s = warm_up(fe, args.n, args.vocab)
    print(f"warmup: {fe.runner.compiled} variants run in "
          f"{time.perf_counter() - t0:.2f}s (steady batch "
          f"{steady_s * 1e3:.2f}ms)")

    fe.start()
    t0 = time.perf_counter()
    try:
        tickets = drive(fe, trace, args.overload, args.vocab)
        results = collect(tickets)
        out = report(fe, trace, results, time.perf_counter() - t0)
    finally:
        fe.stop(drain=True)

    print(f"offered {out['offered']} requests "
          f"({args.overload:.1f}× pacing): served {out['served']} "
          f"({out['qps']:.0f} q/s), shed {out['shed']} "
          f"({out['shed_rate']:.0%}), {out['degraded']} degraded, "
          f"{out['deadline_misses']} deadline misses")
    print(f"accepted latency p50 {out['p50_ms']:.2f}ms / "
          f"p99 {out['p99_ms']:.2f}ms; final degrade level "
          f"{out['final_level']}; shed reasons {fe.stats()['shed']}")
    checked = check_answers(toks, args.vocab, trace, results)
    st = fe.stats()
    if st["submitted"] != st["served"] + st["total_shed"] + st["queued"]:
        raise SystemExit(f"accounting identity broken: {st}")
    print(f"verified {checked} answers against numpy (exact equal, "
          f"degraded bracket it); submitted {st['submitted']} == served "
          f"{st['served']} + shed {st['total_shed']} + queued "
          f"{st['queued']} ✓")


if __name__ == "__main__":
    main()
