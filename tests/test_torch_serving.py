"""The port's query front-end (``repro_torch.serving``) on ``device="cpu"``,
held to the JAX reference (``repro.serving``).

The scenarios of ``tests/test_serving_frontend.py`` run on the port under
a ``FakeClock`` (deadlines, sojourn estimates, ladder cooldowns and
injected shard latency advance logical time, so every shed, degrade and
breaker decision is exact, with no real sleeping; the hot-swap test runs
real threads). One scripted ``FakeClock`` scenario runs through both
front-ends and must give equal answers, every ``Answer`` field, and equal
``stats()``; the reference engine builds through its XLA route
(``default_use_kernels`` patched; nothing under ``src/repro`` changes) and
serves one bucket of 8, so it compiles each op variant once. Also here:
``with_retry``'s backoffs against the reference's, both ``probe_shard``s,
a probe's device fault raised instead of opening a breaker, the staging of
``BatchRunner`` and the CLI smoke.
"""
import threading

import numpy as np
import pytest
import torch

import repro.core.wavelet_matrix as jwm
import repro.robust as jrobust
import repro.serving as jserving
from repro.analytics.engine import \
    build_sharded_analytics as jbuild_sharded_analytics
from repro.ingest.serving import GenerationServer as JGenerationServer
from repro.robust import faults as jfaults
from repro_torch.analytics import build_sharded_analytics
from repro_torch.index import build_sharded_index
from repro_torch.ingest import GenerationServer
from repro_torch.kernels.build import KernelError
from repro_torch.robust import FakeClock, faults, inject_shard_latency
from repro_torch.serving import (AdmissionQueue, BatchRunner, FrontendConfig,
                                 LadderConfig, QueryFrontend, Request,
                                 ShedError, Ticket)
from repro_torch.serving.ladder import DegradeLadder

N, SIGMA, SHARD_BITS = 1024, 64, 8


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(7).integers(0, 50, N).astype(np.uint32)


@pytest.fixture(scope="module")
def engine(tokens):
    return build_sharded_analytics(tokens, SIGMA, shard_bits=SHARD_BITS,
                                   device="cpu")


@pytest.fixture(scope="module")
def jengine(tokens):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwm, "default_use_kernels", lambda seq: False)
        return jbuild_sharded_analytics(tokens, SIGMA, shard_bits=SHARD_BITS)


@pytest.fixture
def frontend(engine):
    """Factory: (clock, **config overrides) → a front-end that started
    nothing; every instance's probe pool is shut down at teardown."""
    made = []

    def make(clock=None, **over):
        over.setdefault("probe_shards", False)
        fe = QueryFrontend(GenerationServer(engine),
                           config=FrontendConfig(**over),
                           clock=clock or FakeClock())
        made.append(fe)
        return fe

    yield make
    for fe in made:
        fe.breakers.close_pool()


def _drain(fe, want):
    served = 0
    for _ in range(1000):
        served += fe.pump()
        if served >= want:
            return served
    raise AssertionError(f"only {served}/{want} served")


# ---------------------------------------------------------------------------
# admission queue: bounds, reject-early, shed-before-dispatch
# ---------------------------------------------------------------------------

def test_queue_bounded_and_explicitly_rejecting(frontend):
    fe = frontend(capacity=4)
    tickets = [fe.submit("count", 0, N, deadline_s=10.0) for _ in range(9)]
    shed = [t for t in tickets if t.shed]
    assert len(shed) == 5 and fe.queue.depth == 4
    with pytest.raises(ShedError) as ei:
        shed[0].result(0)
    assert ei.value.reason == "queue_full"
    _drain(fe, 4)
    assert all(t.done() for t in tickets)


def test_codel_over_budget_shed_at_submit(frontend):
    fe = frontend(capacity=64)
    fe.queue.observe_service(5.0, 1)            # ~1s/request after EWMA
    assert fe.queue.service_s > 0.5
    backlog = [fe.submit("count", 0, N, deadline_s=60.0) for _ in range(10)]
    t = fe.submit("count", 0, N, deadline_s=0.5)   # 10 × ~1s wait ahead
    with pytest.raises(ShedError) as ei:
        t.result(0)
    assert ei.value.reason == "over_budget" and ei.value.est_wait_s > 0.5
    assert not any(b.shed for b in backlog)


def test_expired_requests_shed_before_dispatch(frontend):
    clock = FakeClock()
    fe = frontend(clock=clock)
    dead = fe.submit("count", 0, N, deadline_s=0.3)
    clock.advance(0.5)
    live = fe.submit("count", 0, N, deadline_s=10.0)
    assert fe.pump() == 1
    assert dead.shed and fe.queue.shed_counts["expired"] == 1
    with pytest.raises(ShedError) as ei:
        dead.result(0)
    assert ei.value.reason == "expired"
    assert live.result(0).deadline_met
    st = fe.stats()
    assert st["submitted"] == st["served"] + st["total_shed"]


def test_ticket_timeout_and_unknown_op(frontend):
    fe = frontend()
    t = fe.submit("count", 0, N, deadline_s=10.0)
    with pytest.raises(TimeoutError):
        t.result(timeout=0.01)                  # never pumped
    with pytest.raises(ValueError):
        fe.submit("median", 0, N)
    with pytest.raises(ValueError):
        fe.submit("quantile", 0, N)             # k required
    with pytest.raises(ValueError):
        fe.submit("topk", 0, N, k=3)            # k is the config's
    fe.pump()
    assert t.result(0).mode == "exact"


def test_admission_queue_takes_one_op_in_order():
    q = AdmissionQueue(8, clock=FakeClock())
    reqs = [Request(op=op, args=(0, 1, 0, 0), deadline_t=10.0,
                    submitted_t=0.0, ticket=Ticket())
            for op in ("count", "topk", "count", "quantile", "count")]
    for r in reqs:
        q.submit(r)
    assert q.take(2) == [reqs[0], reqs[2]]
    assert q.take(8) == [reqs[1]]
    assert q.take(8) == [reqs[3]] and q.take(8) == [reqs[4]]


# ---------------------------------------------------------------------------
# deadline propagation through batching
# ---------------------------------------------------------------------------

def test_deadline_miss_tagged_not_dropped(frontend):
    clock = FakeClock()
    fe = frontend(clock=clock, probe_shards=True)
    with inject_shard_latency(0, 2.0):          # the probe advances the clock
        t = fe.submit("count", 0, N, deadline_s=1.0)
        fe.pump()
    a = t.result(0)
    assert a.deadline_met is False and a.latency_s >= 2.0
    assert fe.stats()["deadline_misses"] == 1


def test_deadline_met_within_budget(frontend):
    clock = FakeClock()
    fe = frontend(clock=clock)
    t = fe.submit("count", 0, N, deadline_s=1.0)
    clock.advance(0.25)
    fe.pump()
    a = t.result(0)
    assert a.deadline_met and a.latency_s == pytest.approx(0.25)


# ---------------------------------------------------------------------------
# degradation ladder
# ---------------------------------------------------------------------------

def test_ladder_monotone_within_burst():
    clock = FakeClock()
    lad = DegradeLadder(LadderConfig(up_pressure=0.75, down_pressure=0.25,
                                     cooldown_s=1.0), clock=clock)
    levels = []
    for p in [0.8, 0.5, 0.9, 0.4, 0.8, 0.3]:    # burst: never calm
        levels.append(lad.observe(p))
        clock.advance(0.2)
    assert levels == sorted(levels) and levels[-1] == 2
    assert lad.observe(0.0) == 2                # calm, inside cooldown
    clock.advance(1.5)
    assert lad.observe(0.0) == 1                # one rung per window
    assert lad.observe(0.0) == 1
    clock.advance(1.5)
    assert lad.observe(0.0) == 0


def test_burst_degrades_answers_and_tags_them(frontend, tokens):
    fe = frontend(capacity=16, ladder=LadderConfig(up_pressure=0.5))
    tickets = [fe.submit("quantile", 0, N, k=i * 37, deadline_s=50.0)
               for i in range(14)]
    _drain(fe, 14)
    srt = np.sort(tokens)
    degraded = 0
    for i, t in enumerate(tickets):
        a = t.result(0)
        oracle = int(srt[i * 37])
        if a.mode == "exact":
            assert a.value == oracle
        else:
            assert a.mode == "quantile_bracket" and a.degraded
            assert a.value[0] <= oracle < a.value[1]
            degraded += 1
    assert degraded > 0


def test_op_variants_bracket_numpy_oracle(frontend, tokens):
    fe = frontend()
    eng = fe.server.engine
    lo, hi = 37, 1001
    q = torch.tensor([[lo, lo, lo], [hi, hi, hi], [5, 200, 0], [30, 700, 0]],
                     dtype=torch.int32)
    window = tokens[lo:hi]
    for level in (1, 2):
        mode, fn = fe._op_fn("count", level)
        lo_c, up_c, cov = fn(eng, q)
        exact = int(np.sum((window >= 5) & (window < 30)))
        assert mode == "count_bounds"
        assert int(lo_c[0]) <= exact <= int(up_c[0])
        assert float(cov[0]) == 1.0

        mode, fn = fe._op_fn("quantile", level)
        a, b, _ = fn(eng, q)
        assert mode == "quantile_bracket"
        oracle = int(np.sort(window)[200])
        assert int(a[1]) <= oracle < int(b[1])

        mode, fn = fe._op_fn("topk", level)
        syms, counts, _ = fn(eng, q)
        assert mode == "topk_greedy"
        hist = np.bincount(window, minlength=SIGMA)
        for s, c in zip(syms[2].tolist(), counts[2].tolist()):
            if s >= 0:                          # greedy counts are true
                assert hist[s] == c


# ---------------------------------------------------------------------------
# batching: buckets, padding neutrality, staging, variants
# ---------------------------------------------------------------------------

def test_bucket_padding_is_neutral_and_variants_reused(frontend, tokens):
    fe = frontend(buckets=(4, 16))
    assert fe.runner.bucket_for(3) == 4 and fe.runner.bucket_for(9) == 16
    t3 = [fe.submit("count", i, N - i, deadline_s=10.0) for i in range(3)]
    fe.pump()
    assert fe.runner.compiled == 1              # bucket 4
    t2 = [fe.submit("count", i, N - i, deadline_s=10.0) for i in range(2)]
    fe.pump()
    assert fe.runner.compiled == 1              # the same variant
    for i, t in enumerate(t3 + t2):
        i = i % 3 if i < 3 else i - 3
        assert t.result(0).value == int(np.sum(tokens[i:N - i] < SIGMA))


def test_padding_lanes_answer_neutrally(engine):
    """lo == hi == 0 lanes: count 0, quantile −1, empty top-k."""
    fe_cfg = QueryFrontend(GenerationServer(engine), clock=FakeClock(),
                           config=FrontendConfig(probe_shards=False))
    q = torch.zeros((4, 8), dtype=torch.int32)
    q[:, 0] = torch.tensor([0, N, 0, SIGMA])
    for op in ("count", "quantile", "topk"):
        for level in (0, 1, 2):
            _, fn = fe_cfg._op_fn(op, level)
            a, b, cov = fn(engine, q)
            assert (cov[1:] == 1.0).all()
            if op == "topk":
                assert (a[1:] == -1).all() and (b[1:] == 0).all()
            elif op == "quantile":
                assert (a[1:] == -1).all() and (b[1:] == -1).all()
            else:
                assert (a[1:] == 0).all() and (b[1:] == 0).all()
    fe_cfg.breakers.close_pool()


def test_batch_runner_stages_back_to_back_batches(engine):
    """Batches of different contents in a row: each call sees its own
    contents, padded with zeros."""
    runner = BatchRunner((4, 8))
    seen = []

    def fn(eng, q):
        seen.append(q.clone())
        return q[0], q[1], q[2].float()

    first = np.arange(12, dtype=np.int32).reshape(4, 3) + 1
    second = -np.arange(20, dtype=np.int32).reshape(4, 5) - 1
    a, _, _ = runner.run("k", fn, engine, first, 3)
    b, _, _ = runner.run("k", fn, engine, second, 5)
    assert seen[0].shape == (4, 4) and seen[1].shape == (4, 8)
    assert np.array_equal(seen[0][:, :3].numpy(), first)
    assert np.array_equal(seen[1][:, :5].numpy(), second)
    assert (seen[0][:, 3:] == 0).all() and (seen[1][:, 5:] == 0).all()
    assert isinstance(a, np.ndarray) and np.array_equal(b[:5], second[0])
    runner.run("k", fn, engine, first, 3)
    assert np.array_equal(seen[2][:, :3].numpy(), first)
    assert runner.compiled == 2
    with pytest.raises(ValueError):
        runner.run("k", fn, engine, first, 0)
    with pytest.raises(ValueError):
        runner.run("k", fn, engine, np.zeros((4, 9), np.int32), 9)


def test_mixed_ops_batch_homogeneously(frontend):
    fe = frontend()
    tc = fe.submit("count", 0, N, deadline_s=10.0)
    tq = fe.submit("quantile", 0, N, k=5, deadline_s=10.0)
    tc2 = fe.submit("count", 0, N, deadline_s=10.0)
    assert fe.pump() == 2                       # both counts
    assert tc.done() and tc2.done() and not tq.done()
    assert fe.pump() == 1
    assert tq.done()


# ---------------------------------------------------------------------------
# hedged shard timeout vs availability-mask oracle
# ---------------------------------------------------------------------------

def test_slow_shard_opens_breaker_matches_drop_shards_oracle(frontend,
                                                             engine):
    clock = FakeClock()
    fe = frontend(clock=clock, probe_shards=True)
    thresh = fe.config.breaker.fail_threshold
    with inject_shard_latency(2, 9.0):
        for _ in range(thresh):
            fe.submit("count", 0, N, deadline_s=1e6)
            fe.pump()
    assert fe.stats()["open_breakers"] == [2]
    t = fe.submit("count", 0, N, deadline_s=1e6)
    tq = fe.submit("quantile", 0, N, k=500, deadline_s=1e6)
    fe.pump()
    fe.pump()
    a = t.result(0)
    oracle = engine.drop_shards([2])
    assert a.value == int(oracle.range_count(0, N, 0, SIGMA))
    assert a.degraded and a.coverage == pytest.approx(0.75)
    assert tq.result(0).value == int(oracle.range_quantile([0], [N],
                                                           [500])[0])
    clock.advance(fe.config.breaker.reset_after_s + 1)
    fe.submit("count", 0, N, deadline_s=1e6)
    fe.pump()
    assert fe.stats()["open_breakers"] == []



def test_failed_probe_opens_breaker(frontend, engine, monkeypatch):
    """A probe that fails for any reason but the device's is a failed
    probe: after ``fail_threshold`` of them the shard's breaker opens."""
    def probe(self, s, clock=None):
        if s == 1:
            raise RuntimeError("shard 1 unreachable")
        return True

    monkeypatch.setattr(type(engine), "probe_shard", probe)
    clock = FakeClock()
    fe = frontend(clock=clock, probe_shards=True)
    for _ in range(fe.config.breaker.fail_threshold):
        fe.submit("count", 0, N, deadline_s=1e6)
        fe.pump()
        clock.advance(fe.config.breaker.probe_interval_s)
    assert fe.stats()["open_breakers"] == [1]


@pytest.mark.parametrize("error", [KernelError, torch.AcceleratorError,
                                   torch.OutOfMemoryError])
def test_probe_device_error_raises_not_opens_breaker(error, frontend, engine,
                                                     monkeypatch):
    """A probe that fails on the device (a kernel that cannot be built or
    launched, a CUDA error, the card's memory running out) is no slow
    shard: ``pump`` raises it and rejects the batch's tickets, no breaker
    opens, and the worker stops on it and hands it to ``stop``."""
    def probe(self, s, clock=None):
        raise error("CUDA kernel wm_quantile_sharded failed: an illegal "
                    "memory access was encountered (700)")

    monkeypatch.setattr(type(engine), "probe_shard", probe)
    fe = frontend(probe_shards=True)
    t = fe.submit("count", 0, N, deadline_s=1e6)
    with pytest.raises(error):
        fe.pump()
    with pytest.raises(error):
        t.result(0)
    assert fe.stats()["open_breakers"] == [] and fe.served == 0
    t = fe.submit("count", 0, N, deadline_s=1e6)
    fe.start()
    with pytest.raises(error):
        t.result(10.0)
    with pytest.raises(error):
        fe.stop()
    assert fe.stats()["open_breakers"] == []

# ---------------------------------------------------------------------------
# epoch-pinned serving across hot swaps (real threads, system clock)
# ---------------------------------------------------------------------------

def test_concurrent_hot_swap_answers_pin_one_generation(tokens):
    shard = 1 << SHARD_BITS
    engines = {g: build_sharded_analytics(tokens[:(g + 2) * shard], SIGMA,
                                          shard_bits=SHARD_BITS,
                                          device="cpu")
               for g in range(3)}
    expected = {g: (g + 2) * shard for g in range(3)}
    srv = GenerationServer(engines[0])
    fe = QueryFrontend(srv, config=FrontendConfig(probe_shards=False,
                                                  capacity=2048))
    fe.start()
    tickets = []
    try:
        stop = threading.Event()

        def swapper():
            for g in (1, 2):
                srv.swap_generation(engines[g], wait_drain=True,
                                    timeout_s=30)
            stop.set()

        sw = threading.Thread(target=swapper)
        sw.start()
        while not stop.is_set() or len(tickets) < 50:
            tickets.append(fe.submit("count", 0, 2 ** 30, deadline_s=30.0))
            if len(tickets) > 3000:
                break
        sw.join(30)
        assert not sw.is_alive()
    finally:
        fe.stop(drain=True)
    gens_seen = set()
    for t in tickets:
        try:
            a = t.result(5)
        except ShedError:
            continue
        gens_seen.add(a.generation)
        assert a.value == expected[a.generation]
    assert 2 in gens_seen and srv.generation == 2


def test_stats_accounting_identity(frontend):
    clock = FakeClock()
    fe = frontend(clock=clock, capacity=8)
    for i in range(20):
        fe.submit("count", 0, N, deadline_s=(0.1 if i % 3 else 5.0))
        if i % 5 == 0:
            clock.advance(0.2)
            fe.pump()
    while fe.pump():
        pass
    st = fe.stats()
    assert st["submitted"] == 20
    assert st["submitted"] == st["served"] + st["total_shed"] + st["queued"]


# ---------------------------------------------------------------------------
# one scripted FakeClock scenario through both front-ends
# ---------------------------------------------------------------------------

def _script(fe, clock, latency):
    """Drive a front-end through every path: a mixed queue at level 0, a
    burst that climbs the ladder (brackets, greedy top-k, count bounds),
    an expired and an over-budget shed, the calm that steps the ladder
    down, a slow shard that opens its breaker (answers on the surviving
    shards) and the reset that closes it. Returns the tickets."""
    tickets = []

    def sub(op, lo, hi, **kw):
        tickets.append(fe.submit(op, lo, hi, **kw))

    def drain(step):
        while fe.pump():
            clock.advance(step)

    sub("count", 0, N, deadline_s=10.0)
    sub("quantile", 5, 900, k=17, deadline_s=10.0)
    sub("count", 37, 1001, sym_lo=5, sym_hi=30, deadline_s=10.0)
    sub("topk", 100, 800, deadline_s=10.0)
    sub("quantile", 0, 0, k=0, deadline_s=10.0)        # empty range
    clock.advance(0.01)
    drain(0.01)
    for i in range(12):
        sub("quantile", i * 7, N - i * 5, k=i * 31, deadline_s=50.0)
    for i in range(4):
        sub("topk", i * 100, i * 100 + 500, deadline_s=50.0)
    sub("count", 3, 999, sym_lo=1, sym_hi=40, deadline_s=50.0)
    drain(0.02)
    sub("count", 0, N, deadline_s=0.05)
    clock.advance(0.1)
    fe.pump()                                           # sheds it: expired
    fe.queue.observe_service(5.0, 1)                   # ~1 s a request
    for i in range(3):
        sub("count", i, N, deadline_s=0.4)      # all but the first shed
    drain(0.01)
    for _ in range(3):                                  # calm: step down
        clock.advance(1.0)
        fe.pump()
    with latency(2, 9.0):
        for _ in range(fe.config.breaker.fail_threshold):
            sub("count", 0, N, deadline_s=1e6)
            fe.pump()
        sub("count", 0, N, deadline_s=1e6)
        sub("quantile", 100, 1000, k=300, deadline_s=1e6)
        sub("topk", 0, N, deadline_s=1e6)
        drain(0.01)
    clock.advance(fe.config.breaker.reset_after_s + 1)
    sub("count", 0, N, deadline_s=1e6)
    drain(0.01)
    return tickets


def _outcome(ticket):
    try:
        a = ticket.result(0)
    except (ShedError, jserving.ShedError) as e:
        return ("shed", e.reason, e.queue_depth, e.est_wait_s)
    value = a.value
    if isinstance(value, tuple) and isinstance(value[0], np.ndarray):
        value = tuple(v.tolist() for v in value)
    return (value, a.mode, a.degraded, a.coverage, a.level, a.generation,
            a.latency_s, a.deadline_met)


def test_scripted_scenario_equals_the_reference(engine, jengine):
    cfg = dict(buckets=(8,), capacity=16, probe_shards=True)
    clock, jclock = FakeClock(), jrobust.FakeClock()
    fe = QueryFrontend(GenerationServer(engine), clock=clock,
                       config=FrontendConfig(
                           ladder=LadderConfig(up_pressure=0.5), **cfg))
    jfe = jserving.QueryFrontend(
        JGenerationServer(jengine), clock=jclock,
        config=jserving.FrontendConfig(
            ladder=jserving.LadderConfig(up_pressure=0.5), **cfg))
    try:
        got = [_outcome(t) for t in _script(fe, clock,
                                            inject_shard_latency)]
        want = [_outcome(t) for t in _script(jfe, jclock,
                                             jrobust.inject_shard_latency)]
    finally:
        fe.breakers.close_pool()
        jfe.breakers.close_pool()
    assert got == want
    assert fe.stats() == jfe.stats()
    # the script reached every path
    modes = {o[1] for o in got}
    assert {"exact", "count_bounds", "quantile_bracket", "topk_greedy",
            "expired", "over_budget", "queue_full"} <= modes
    assert any(o[0] != "shed" and o[3] < 1.0 for o in got)
    assert clock.now() == jclock.now()


# ---------------------------------------------------------------------------
# with_retry, probes, CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(retries=4, backoff_s=0.1),
                                dict(retries=3, backoff_s=0.2, jitter=False),
                                dict(retries=6, backoff_s=1.0,
                                     deadline_s=2.5),
                                dict(retries=2, backoff_s=0.05,
                                     exceptions=(KeyError,))])
def test_with_retry_backoffs_equal_the_reference(kw):
    runs = []
    for mod, clock in ((faults, FakeClock()), (jfaults, jrobust.FakeClock())):
        calls, retried = [], []

        def fn():
            calls.append(clock.now())
            clock.advance(0.25)
            raise ValueError("transient") if len(calls) < 4 else \
                KeyError("later")

        with pytest.raises((ValueError, KeyError)) as ei:
            mod.with_retry(fn, rng=np.random.default_rng(3), clock=clock,
                           on_retry=lambda a, e: retried.append(
                               (a, type(e).__name__)), **kw)
        runs.append((clock.sleeps, calls, retried, ei.type))
    assert runs[0] == runs[1]


def test_with_retry_returns_after_transient_failures():
    clock = FakeClock()
    calls = []

    def fn():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("flaky")
        return "built"

    assert faults.with_retry(fn, retries=2, backoff_s=0.1, clock=clock,
                             rng=np.random.default_rng(0)) == "built"
    assert len(calls) == 3 and len(clock.sleeps) == 2
    assert all(0.0 <= s <= 0.1 * 2 ** i for i, s in enumerate(clock.sleeps))


def test_probe_shard_sleeps_armed_latency_on_its_clock(engine, jengine):
    clock, jclock = FakeClock(), jrobust.FakeClock()
    assert engine.probe_shard(1, clock) and clock.sleeps == []
    with inject_shard_latency(1, 3.0), jrobust.inject_shard_latency(1, 3.0):
        assert engine.probe_shard(1, clock) == jengine.probe_shard(1, jclock)
        assert engine.probe_shard(2, clock)
    assert clock.sleeps == jclock.sleeps == [3.0]
    assert engine.probe_shard(3)                # the system clock


def test_index_probe_shard(tokens):
    idx = build_sharded_index(tokens[:600], SIGMA, shard_bits=SHARD_BITS,
                              sample_rate=16, seam_overlap=7, device="cpu")
    clock = FakeClock()
    with inject_shard_latency(2, 0.5):
        assert all(idx.probe_shard(s, clock) for s in range(idx.num_shards))
    assert clock.sleeps == [0.5]


def test_frontend_cli_smoke(capsys):
    from repro_torch.launch import frontend as cli
    cli.main(["--smoke", "--device", "cpu", "--requests", "120"])
    out = capsys.readouterr().out
    assert "offered 120 requests" in out and out.rstrip().endswith("✓")


def test_trace_equals_the_reference(tmp_path):
    from repro.launch import frontend as jcli
    from repro_torch.launch import frontend as cli
    kw = dict(base_qps=200.0, burst_qps=2000.0, burst_every_s=2.0,
              burst_len_s=0.5, deadline_s=0.25, topk_k=8)
    trace = cli.make_trace(1 << 20, 500, 3, **kw)
    assert trace == jcli.make_trace(1 << 20, 500, 3, **kw)
    cli.save_trace(tmp_path / "t.jsonl", trace)
    assert cli.load_trace(tmp_path / "t.jsonl") == trace
