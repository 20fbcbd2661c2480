"""Chaos CLI: inject every fault class against snapshots and live engines
and prove each one is detected, repaired bit-identically, or served
degraded with an honest coverage report — never a silent wrong answer.

The port of ``repro.launch.chaos``: the same scenario matrix, in the same
order and under the same row names, over the port's modules, on
``--device`` (default ``cuda``; ``cpu`` runs the plain versions).

PYTHONPATH=src python -m repro_torch.launch.chaos --smoke --device cpu
PYTHONPATH=src python -m repro_torch.launch.chaos --seed 7 --dir /tmp/chaos
PYTHONPATH=src python -m repro_torch.launch.chaos --smoke \
    --metrics-dir /tmp/m   # then: python -m repro_torch.launch.obs /tmp/m --tree

Scenario matrix (each seeded, each independently pass/fail, nonzero exit
on any failure):

* clean restore                   — bit-identical round trip
* derived-leaf corruption         — rank tables / select samples / zeros
  flipped inside ``arrays.npz``: detected by the leaf checksums, repaired
  by recomputation, restored engine bit-identical to the saved one
* primary-bitmap corruption       — detected, classified unrepairable,
  restore raises and the caller rebuilds from source
* truncated / half-deleted steps  — skipped by ``latest_step``; restore
  falls back (older valid step or rebuild), never reads a torn file
* stale partial ``.tmp`` writes   — invisible to step discovery
* in-memory corruption            — structural verify localizes it with
  no checksum at all, repair restores bit-identity
* FM-index corruption             — C table / mark / SA samples re-derived
  from the BWT bitmaps (O(m) LF-walk SA reconstruction)
* shard loss                      — degraded serving with exact coverage
  fraction and count bounds that bracket the full-corpus truth
* ingest crash points             — the ingester is killed after every
  step of the two-phase shard commit protocol; journal replay + re-feed
  must reconverge to a serving state bit-identical to a clean build
* torn journal tail               — a crashed manifest append is dropped,
  the stream resumes from the last durable offset
* ingest quarantine / hot swap    — permanently failing shard builds are
  quarantined (honest coverage bounds), and epoch-fenced generation
  swaps never show a query batch a mixed corpus
* overload (serving front-end)    — a 5× request storm against the
  bounded admission queue: shed requests get explicit rejections, served
  requests beat their deadline or carry a degraded-mode tag whose
  bounds/brackets contain the numpy oracle, accepted p99 stays within
  the declared SLO
* slow shard (front-end)          — chaos-injected per-shard latency
  times out the hedged probes, the circuit breaker opens, and answers
  match the availability-mask oracle until the half-open probe recovers
* deadline storm                  — every hopeless request is explicitly
  rejected before dispatch; nothing is silently dropped
* stuck generation swap           — a swap whose drain fence never
  clears stalls only the *swapper*: the front-end keeps serving (new
  epoch), the pinned old session keeps its generation's truth
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch

from repro_torch import obs
from repro_torch.analytics import load_analytics, save_analytics
from repro_torch.analytics.engine import build_sharded_analytics
from repro_torch.data import make_corpus
from repro_torch.device import resolve_device
from repro_torch.index import build_sharded_index
from repro_torch.obs.spans import wait_for
from repro_torch.robust import (IntegrityError, corrupt_snapshot_leaf,
                                delete_file, flip_leaf_bit,
                                inject_partial_tmp, repair_analytics,
                                repair_sharded_index, trees_identical,
                                truncate_file, verify_analytics,
                                verify_sharded_index)


class Check:
    """Collects scenario outcomes; prints a pass/fail matrix at the end."""

    def __init__(self):
        self.rows = []

    def record(self, name: str, ok: bool, detail: str = ""):
        self.rows.append((name, ok, detail))
        obs.counter("chaos.scenario",
                    outcome="pass" if ok else "fail").inc()
        obs.event("scenario", scenario=name, ok=ok,
                  detail=detail or None)
        mark = "PASS" if ok else "FAIL"
        print(f"  [{mark}] {name}" + (f" — {detail}" if detail else ""))

    @property
    def failures(self) -> int:
        return sum(1 for _, ok, _ in self.rows if not ok)


def _fresh_snapshot(eng, directory: Path, seed: int) -> Path:
    if directory.exists():
        shutil.rmtree(directory)
    return save_analytics(eng, directory, extra_meta={"corpus_seed": seed})


def _queries_match(a, b, lo, hi, k) -> bool:
    return (torch.equal(a.range_quantile(lo, hi, k),
                        b.range_quantile(lo, hi, k))
            and torch.equal(a.range_histogram(lo, hi),
                            b.range_histogram(lo, hi)))


def run_snapshot_scenarios(eng, snap_dir: Path, seed: int, check: Check):
    dev = eng.device
    lo = torch.tensor([0, 17, 1000], dtype=torch.int32, device=dev)
    hi = torch.tensor([64, 900, 4000], dtype=torch.int32, device=dev)
    k = torch.tensor([3, 100, 7], dtype=torch.int32, device=dev)

    # -- clean restore ----------------------------------------------------
    with obs.span("chaos.scenario", scenario="clean_restore"):
        _fresh_snapshot(eng, snap_dir, seed)
        restored = load_analytics(snap_dir, device=dev)
        check.record("clean restore bit-identical",
                     trees_identical(restored.shards, eng.shards))

    # -- derived-leaf corruption: detected + repaired bit-identically -----
    for frag in ("superblock", "block", "sel1/sample", "sel0/sample",
                 "zeros"):
        with obs.span("chaos.scenario", scenario="derived_corruption",
                      leaf=frag):
            _fresh_snapshot(eng, snap_dir, seed)
            where = corrupt_snapshot_leaf(snap_dir, seed=seed,
                                          leaf_match=frag)
            try:
                healed = load_analytics(snap_dir, device=dev)
                ok = (trees_identical(healed.shards, eng.shards)
                      and _queries_match(healed, eng, lo, hi, k))
                check.record(f"derived corruption repaired [{frag}]", ok,
                             where)
            except IntegrityError as e:
                check.record(f"derived corruption repaired [{frag}]", False,
                             f"unexpected {e}")

    # -- primary corruption: detected, classified, rebuild signalled ------
    with obs.span("chaos.scenario", scenario="primary_corruption"):
        _fresh_snapshot(eng, snap_dir, seed)
        where = corrupt_snapshot_leaf(snap_dir, seed=seed,
                                      leaf_match="bitvectors/rank/words")
        try:
            load_analytics(snap_dir, device=dev)
            check.record("primary corruption raises", False,
                         "corrupt bitmap restored without error")
        except IntegrityError as e:
            check.record("primary corruption raises", "primary" in str(e),
                         where)

    # -- truncated npz: step skipped, restore falls back ------------------
    _fresh_snapshot(eng, snap_dir, seed)
    truncate_file(snap_dir, "arrays.npz", keep_frac=0.25)
    try:
        load_analytics(snap_dir, device=dev)
        check.record("truncated npz skipped", False,
                     "restored from a torn file")
    except FileNotFoundError:
        check.record("truncated npz skipped", True,
                     "no valid step → caller rebuilds from source")

    # -- deleted meta.json: same escalation -------------------------------
    _fresh_snapshot(eng, snap_dir, seed)
    delete_file(snap_dir, "meta.json")
    try:
        load_analytics(snap_dir, device=dev)
        check.record("half-deleted step skipped", False,
                     "restored from a half-deleted step")
    except FileNotFoundError:
        check.record("half-deleted step skipped", True)

    # -- stale partial .tmp + bare step dir: invisible to discovery -------
    _fresh_snapshot(eng, snap_dir, seed)
    inject_partial_tmp(snap_dir, step=99)
    try:
        restored = load_analytics(snap_dir, device=dev)
        check.record("partial .tmp write ignored",
                     trees_identical(restored.shards, eng.shards))
    except Exception as e:                                # noqa: BLE001
        check.record("partial .tmp write ignored", False, str(e))


def run_memory_scenarios(eng, seed: int, check: Check):
    # structural verify needs no checksum: corrupt a live engine's rank
    # directory, localize it, repair, and recover bit-identity
    bad, where = flip_leaf_bit(eng, seed=seed, leaf_match="rank/block")
    report = verify_analytics(bad)
    detected = (not report.ok) and report.repairable
    healed = repair_analytics(bad)
    ok = (detected and verify_analytics(healed).ok
          and trees_identical(healed.shards, eng.shards))
    check.record("in-memory corruption verify+repair", ok, where)

    # primary bitmap flip: structural verify must detect it, and the
    # checksum backstop must refuse any "repair" built on the corrupt
    # bitmap — the chain that makes silent wrong answers impossible
    from repro_torch.robust import tree_checksums
    want = tree_checksums(eng.shards)
    bad, where = flip_leaf_bit(eng, seed=seed + 1, leaf_match="rank/words")
    report = verify_analytics(bad)
    attempted = repair_analytics(bad)
    got = tree_checksums(attempted.shards)
    caught = any(got[k] != want[k] for k in want)
    check.record("in-memory primary flip detected + repair refused",
                 (not report.ok) and caught, where)


def run_index_scenarios(seed: int, check: Check, dev):
    rng = np.random.default_rng(seed)
    n, vocab = 1 << 11, 64
    toks = rng.integers(0, vocab, n).astype(np.int64)
    idx = build_sharded_index(toks, vocab, shard_bits=9, sample_rate=32,
                              seam_overlap=7, device=dev)

    # FM-index derived leaves (C, mark, sa_sample) re-derive from bitmaps
    for frag in ("C", "mark", "sa_sample"):
        bad, where = flip_leaf_bit(idx, seed=seed, leaf_match=frag)
        report = verify_sharded_index(bad)
        healed = repair_sharded_index(bad, deep=True)
        ok = ((not report.ok) and report.repairable
              and trees_identical(healed.shards, idx.shards))
        check.record(f"fm-index corruption repaired [{frag}]", ok, where)

    # shard loss: degraded counts + honest bounds
    pat = toks[100:104].astype(np.int32)
    deg = idx.drop_shards(np.asarray([1], np.int32))
    lower, upper, cov = deg.count_bounds(pat[None, :], np.asarray([4]))
    full = int(idx.count(pat[None, :], np.asarray([4]))[0])
    win = np.lib.stride_tricks.sliding_window_view(toks, 4)
    hits = np.nonzero((win == pat).all(axis=1))[0]
    sh = hits >> 9
    end_sh = (hits + 3) >> 9
    want_deg = int(np.sum((sh != 1) & (end_sh != 1)))
    ok = (int(lower[0]) == want_deg
          and int(lower[0]) <= full <= int(upper[0])
          and 0.0 < float(cov) < 1.0)
    check.record("degraded index serves with bounds", ok,
                 f"coverage {float(cov):.2f}, "
                 f"count ∈ [{int(lower[0])}, {int(upper[0])}], true {full}")


def run_ingest_scenarios(seed: int, scratch: Path, check: Check, dev):
    """Crash-point sweep over the two-phase shard commit protocol.

    For every protocol step: arm ``crash_after(step)``, feed the stream,
    die, then recover in a "new process" (fresh ingester, journal
    replay), re-feed from ``resume_offset``, and demand the served engine
    is *bit-identical* to a clean from-scratch build — plus torn-journal,
    quarantine-coverage and hot-swap generation checks.
    """
    from repro_torch.analytics.engine import ShardedAnalytics
    from repro_torch.data.compressed_store import build_compressed_corpus
    from repro_torch.ingest import (COMMIT_STEPS, GenerationServer,
                                    ShardIngester, analytics_ingester,
                                    read_journal)
    from repro_torch.robust import CrashInjected, crash_after, verify_manifest

    rng = np.random.default_rng(seed)
    n, vocab, shard_bits = 1 << 11, 64, 8
    toks = rng.integers(0, vocab, n).astype(np.int64)
    ref = ShardedAnalytics.from_corpus(
        build_compressed_corpus(toks, vocab, shard_bits=shard_bits,
                                device=dev))

    def fresh(d):
        return analytics_ingester(d, vocab, shard_bits=shard_bits,
                                  backoff_s=0.0, device=dev)

    # -- crash after every protocol step → recover → bit-identical --------
    for step in COMMIT_STEPS:
        with obs.span("chaos.scenario", scenario="ingest_crash", step=step):
            d = scratch / f"ingest_{step}"
            ing = fresh(d)
            ing.recover()
            died = False
            try:
                with crash_after(step):
                    ing.append_tokens(toks)
                    ing.flush()
            except CrashInjected:
                died = True
            ing2 = fresh(d)
            rep = ing2.recover()
            ing2.append_tokens(toks[rep.resume_offset:])
            ing2.flush()
            eng = ing2.engine()
            ok = (died and eng.available is None
                  and trees_identical(eng.shards, ref.shards)
                  and verify_manifest(d).ok)
            check.record(f"ingest crash@{step} recovers bit-identical", ok,
                         rep.summary())

    # -- torn journal tail: dropped, stream resumes -----------------------
    with obs.span("chaos.scenario", scenario="ingest_torn_tail"):
        d = scratch / "ingest_torn"
        ing = fresh(d)
        ing.recover()
        ing.append_tokens(toks)
        ing.flush()
        j = d / "manifest.jsonl"
        j.write_bytes(j.read_bytes()[:-7])          # crash mid-append
        _, torn = read_journal(j, strict=False)
        ing2 = fresh(d)
        rep = ing2.recover()
        ing2.append_tokens(toks[rep.resume_offset:])
        ing2.flush()
        eng = ing2.engine()
        check.record("ingest torn journal tail dropped + resumed",
                     torn and trees_identical(eng.shards, ref.shards),
                     rep.summary())

    # -- permanent build failure: quarantined, served with bounds ---------
    with obs.span("chaos.scenario", scenario="ingest_quarantine"):
        d = scratch / "ingest_quarantine"
        calls = {"n": 0}

        def build(s):
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("poisoned batch")
            from repro_torch.core.wavelet_matrix import build_wavelet_matrix
            return build_wavelet_matrix(s, vocab, sample_rate=512,
                                        device=dev)

        ing = ShardIngester(d, build, shard_bits, sigma=vocab,
                            kind="analytics", token_dtype=np.uint32,
                            retries=0, backoff_s=0.0, device=dev)
        ing.recover()
        ing.append_tokens(toks)
        ing.flush()
        eng = ing.engine()
        lower, upper, cov = eng.range_count_bounds(0, n, 0, vocab // 2)
        truth = int(ref.range_count(0, n, 0, vocab // 2))
        ok = (eng.degraded
              and int(lower) <= truth <= int(upper)
              and 0.0 < float(cov) < 1.0
              and verify_manifest(d).ok)
        check.record("ingest quarantine serves honest bounds", ok,
                     f"coverage {float(cov):.2f}, "
                     f"count ∈ [{int(lower)}, {int(upper)}], true {truth}")

    # -- hot swap: fenced generation bump, no mixed-corpus answer ---------
    with obs.span("chaos.scenario", scenario="ingest_hot_swap"):
        d = scratch / "ingest_swap"
        ing = fresh(d)
        ing.recover()
        cut = (n >> shard_bits >> 1) << shard_bits
        ing.append_tokens(toks[:cut])
        srv = GenerationServer(ing.engine())
        with srv.session() as (gen0, eng0):
            ing.append_tokens(toks[cut:])
            ing.flush()
            new = ing.serve_entries()[cut >> shard_bits:]
            eng1 = eng0.add_shards(ing.stack(new), n - cut)
            srv.swap_generation(eng1, wait_drain=False)
            # the pinned session still sees the old corpus…
            old_n = int(eng0.range_count(0, eng0.n, 0, vocab))
        gen1, eng_now = srv.pin()
        ok = (old_n == cut and gen1 == gen0 + 1
              and eng_now.n == n
              and trees_identical(eng_now.shards, ref.shards))
        check.record("ingest hot swap fences generations", ok,
                     f"gen {gen0}→{gen1}, n {cut}→{eng_now.n}")


def run_overload_scenarios(seed: int, check: Check, dev):
    """Serving front-end under overload, on a fake clock: request storms,
    slow shards, deadline storms, stuck generation swaps. Every decision
    (shed, degrade, breaker trip) is asserted against explicit rejections
    and numpy oracles — overload must produce bounded, honest answers,
    never silence or stalls.
    """
    import threading

    from repro_torch.ingest.serving import GenerationServer
    from repro_torch.robust import FakeClock, inject_shard_latency
    from repro_torch.serving import (FrontendConfig, LadderConfig,
                                     QueryFrontend, ShedError)

    rng = np.random.default_rng(seed)
    n, vocab, shard_bits = 1 << 11, 64, 8
    toks = rng.integers(0, vocab, n).astype(np.uint32)
    eng = build_sharded_analytics(toks, vocab, shard_bits=shard_bits,
                                  device=dev)
    srt = np.sort(toks)
    half_exact = int(np.sum(toks < vocab // 2))

    # -- 5× request storm: bounded, honest, explicit ----------------------
    # One modeled worker: a batch of b requests occupies it b·service_s of
    # logical time, during which arrivals (at 5× the service rate) pile
    # into the bounded queue — the sustained-overload regime where every
    # defense (queue_full, over_budget, expired, the ladder) must engage.
    with obs.span("chaos.scenario", scenario="overload_storm"):
        clock = FakeClock()
        fe = QueryFrontend(
            GenerationServer(eng),
            config=FrontendConfig(capacity=64, buckets=(8, 32),
                                  probe_shards=False,
                                  ladder=LadderConfig(up_pressure=0.5)),
            clock=clock)
        service_s = 2e-3             # modeled per-request service cost
        slo_s = 0.08                 # per-request deadline = declared SLO
        for _ in range(30):          # converge the sojourn EWMA
            fe.queue.observe_service(8 * service_s, 8)
        arrival_s = service_s / 5.0  # 5× the modeled capacity
        storm = []
        next_free = 0.0
        for i in range(400):
            if i % 2 == 0:
                t = fe.submit("count", 0, n, sym_lo=0, sym_hi=vocab // 2,
                              deadline_s=slo_s)
                storm.append(("count", 0, t))
            else:
                k = int(rng.integers(0, n))
                t = fe.submit("quantile", 0, n, k=k, deadline_s=slo_s)
                storm.append(("quantile", k, t))
            clock.advance(arrival_s)
            if clock.now() >= next_free:
                served = fe.pump()
                next_free = clock.now() + served * service_s
        while True:                  # drain the tail
            if clock.now() < next_free:
                clock.advance(next_free - clock.now())
            served = fe.pump()
            if not served:
                break
            next_free = clock.now() + served * service_s
        st = fe.stats()
        reasons = set()
        lats, bad = [], []
        degraded = 0
        for op, k, t in storm:
            if t.shed:
                try:
                    t.result(0)
                except ShedError as e:
                    reasons.add(e.reason)
                continue
            a = t.result(0)
            lats.append(a.latency_s)
            if a.degraded:
                degraded += 1
            if not (a.deadline_met or a.degraded):
                bad.append((op, "late exact answer"))
            if op == "count":
                if a.mode == "exact":
                    ok_v = a.value == half_exact
                else:
                    lo_c, up_c = a.value
                    ok_v = lo_c <= half_exact <= up_c
            else:
                oracle = int(srt[k])
                if a.mode == "exact":
                    ok_v = a.value == oracle
                else:
                    lo_s, hi_s = a.value
                    ok_v = lo_s <= oracle < hi_s
            if not ok_v:
                bad.append((op, a.mode, a.value))
        accounted = (st["submitted"] == 400
                     and st["submitted"] == st["served"] + st["total_shed"]
                     and st["queued"] == 0)
        shed_rate = st["total_shed"] / 400
        p99 = float(np.percentile(lats, 99)) if lats else 0.0
        check.record(
            "overload storm: bounded queue, explicit sheds, full accounting",
            accounted and st["total_shed"] > 0
            and reasons <= {"queue_full", "over_budget", "expired"},
            f"served {st['served']}, shed {st['total_shed']} "
            f"({shed_rate:.0%}: {sorted(reasons)})")
        check.record(
            "overload answers honest: deadline met or degraded-tagged, "
            "bounds bracket oracle",
            not bad and degraded > 0,
            f"{degraded} degraded answers, {len(bad)} violations")
        check.record("overload accepted p99 within SLO",
                     bool(lats) and p99 <= slo_s,
                     f"p99 {p99 * 1e3:.1f}ms ≤ {slo_s * 1e3:.0f}ms "
                     f"over {len(lats)} accepted")
        fe.breakers.close_pool()

    # -- chaos shard latency: hedged timeout → breaker → mask oracle ------
    with obs.span("chaos.scenario", scenario="overload_slow_shard"):
        clock = FakeClock()
        fe = QueryFrontend(GenerationServer(eng),
                           config=FrontendConfig(probe_shards=True),
                           clock=clock)
        with inject_shard_latency(3, 9.0):
            for _ in range(fe.config.breaker.fail_threshold):
                fe.submit("count", 0, n, deadline_s=1e6)
                fe.pump()
        opened = fe.stats()["open_breakers"] == [3]
        t = fe.submit("count", 0, n, deadline_s=1e6)
        fe.pump()
        a = t.result(0)
        oracle = int(eng.drop_shards([3]).range_count(0, n, 0, vocab))
        clock.advance(fe.config.breaker.reset_after_s + 1.0)
        fe.submit("count", 0, n, deadline_s=1e6)
        fe.pump()
        recovered = fe.stats()["open_breakers"] == []
        check.record(
            "slow shard: breaker opens, answers match availability-mask "
            "oracle, half-open recovers",
            opened and recovered and a.degraded and a.value == oracle
            and float(a.coverage) < 1.0,
            f"coverage {float(a.coverage):.2f}, count {a.value} "
            f"(oracle {oracle})")
        fe.breakers.close_pool()

    # -- deadline storm: all hopeless work explicitly rejected ------------
    with obs.span("chaos.scenario", scenario="deadline_storm"):
        clock = FakeClock()
        fe = QueryFrontend(GenerationServer(eng),
                           config=FrontendConfig(probe_shards=False),
                           clock=clock)
        storm = [fe.submit("count", 0, n, deadline_s=0.01)
                 for _ in range(32)]
        clock.advance(1.0)           # every deadline blows while queued
        while fe.pump():
            pass
        reasons = set()
        for t in storm:
            try:
                t.result(0)
                reasons.add("SERVED")
            except ShedError as e:
                reasons.add(e.reason)
        check.record(
            "deadline storm: every request explicitly rejected pre-dispatch",
            all(t.shed for t in storm) and fe.stats()["served"] == 0
            and "SERVED" not in reasons,
            f"reasons {sorted(reasons)}")
        fe.breakers.close_pool()

    # -- stuck swap_generation: stalls the swapper, never the queue -------
    with obs.span("chaos.scenario", scenario="stuck_swap"):
        srv = GenerationServer(eng)
        clock = FakeClock()
        fe = QueryFrontend(srv, config=FrontendConfig(probe_shards=False),
                           clock=clock)
        eng2 = build_sharded_analytics(
            np.concatenate([toks, toks]), vocab, shard_bits=shard_bits,
            device=dev)
        entered, release = threading.Event(), threading.Event()
        old_answer = []

        def holder():
            with srv.session() as (_, e0):
                old_answer.append(int(e0.range_count(0, e0.n, 0, vocab)))
                entered.set()
                release.wait(30)

        h = threading.Thread(target=holder)
        h.start()
        entered.wait(5)
        swap_done = threading.Event()

        def swapper():
            srv.swap_generation(eng2, wait_drain=True, timeout_s=30)
            swap_done.set()

        sw = threading.Thread(target=swapper)
        sw.start()
        answers = []
        for _ in range(4):           # swapper is fenced on the holder…
            t = fe.submit("count", 0, 2 * n, deadline_s=10.0)
            fe.pump()
            answers.append(t.result(5))
        stuck = not swap_done.is_set()
        release.set()
        h.join(10)
        sw.join(10)
        served_new = all(a.generation == 1 and a.value == 2 * n
                         for a in answers)
        check.record(
            "stuck swap: front-end serves on (new epoch), pinned session "
            "keeps old truth, fence completes on drain",
            stuck and served_new and old_answer == [n]
            and swap_done.is_set(),
            f"{len(answers)} answers served while fence blocked")
        fe.breakers.close_pool()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run (sizes are already small)")
    ap.add_argument("--n", type=int, default=1 << 12)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--shard-bits", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the engines live (cpu runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--dir", type=str, default=None,
                    help="scratch directory for snapshot faults "
                         "(default: a fresh tempdir)")
    ap.add_argument("--metrics-dir", type=str, default=None,
                    help="export obs metrics + the correlated "
                         "injection→detection→repair span tree here "
                         "(inspect with `python -m repro_torch.launch.obs "
                         "<dir> --tree`)")
    ap.add_argument("--profile-dir", type=str, default=None,
                    help="capture a torch.profiler trace of the scenario "
                         "run into this directory")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.metrics_dir:
        obs.configure(args.metrics_dir)
    obs.start_trace(args.profile_dir)

    toks = np.asarray(make_corpus(args.n, args.vocab, seed=args.seed),
                      np.int64)
    eng = wait_for(build_sharded_analytics(toks, args.vocab,
                                           shard_bits=args.shard_bits,
                                           device=dev))
    print(f"chaos target: {args.n} tokens, {eng.num_shards} shards, "
          f"seed {args.seed}, device {dev}")

    scratch = Path(args.dir) if args.dir else Path(
        tempfile.mkdtemp(prefix="chaos_"))
    snap_dir = scratch / "snapshot"
    check = Check()
    try:
        print("snapshot fault injection:")
        with obs.span("chaos.snapshot"):
            run_snapshot_scenarios(eng, snap_dir, args.seed, check)
        print("in-memory fault injection:")
        with obs.span("chaos.memory"):
            run_memory_scenarios(eng, args.seed, check)
        print("text-index fault injection:")
        with obs.span("chaos.index"):
            run_index_scenarios(args.seed, check, dev)
        print("streaming-ingest crash injection:")
        with obs.span("chaos.ingest"):
            run_ingest_scenarios(args.seed, scratch / "ingest", check, dev)
        print("serving front-end overload injection:")
        with obs.span("chaos.overload"):
            run_overload_scenarios(args.seed, check, dev)
    finally:
        if not args.dir:
            shutil.rmtree(scratch, ignore_errors=True)

    total = len(check.rows)
    trace_path = obs.stop_trace()
    if trace_path:
        print(f"device trace → {trace_path}")
    if args.metrics_dir:
        obs.write_snapshot()
        obs.configure(None)
        print(f"metrics → {args.metrics_dir}")
    if check.failures:
        raise SystemExit(
            f"chaos: {check.failures}/{total} scenarios FAILED")
    print(f"chaos: all {total} scenarios survived ✓")
    return check


if __name__ == "__main__":
    main()
