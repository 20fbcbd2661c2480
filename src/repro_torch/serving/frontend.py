"""The overload-hardened query front-end: queue → ladder → batch → answer
(port of ``repro.serving.frontend``).

``QueryFrontend`` is the serving loop that turns a ragged, bursty stream
of analytics requests into the fixed-shape batches the sharded ops want,
while staying up, and honest, when offered load exceeds capacity. One
pump iteration:

1. read queue pressure, fold it into the :class:`~.ladder.DegradeLadder`
   (the level the batch will serve at);
2. refresh the per-shard :class:`~.breakers.ShardBreakers` (hedged
   probes; a chaos-stalled shard opens its breaker);
3. take one homogeneous batch from the :class:`~.admission.AdmissionQueue`
   (expired requests shed *before* dispatch, with explicit rejections);
4. pin an epoch via ``GenerationServer.session()``: the batch runs
   entirely against one ``(generation, engine)`` pair, so a concurrent
   ``swap_generation`` (even one stuck on its drain fence) never tears
   or stalls it;
5. fold the breaker mask into the engine's availability mask and run the
   ladder-selected op variant through the :class:`~.batching.BatchRunner`
   (bucket-padded);
6. resolve every ticket with an :class:`~.admission.Answer` tagged with
   mode / coverage / level / generation / deadline outcome.

The exact quantile goes through ``ShardedAnalytics.range_quantile``: the
``wm_quantile_sharded`` kernel on a card engine with every shard
available, the plain descent under a mask (the reference takes its XLA
descent here; the answers are the same). The counts and count bounds run
through the port's ``wm_count`` kernel and the greedy top-k through its
``topk_greedy`` kernel, on the engine's quantile operands, masked or not:
one launch a batch where the plain descents made some 1,800 and 13,000
small launches on the H100, which cost the 250 ms deadline (``PERF.md``
§6). The quantile bracket and the exact top-k are the engine's
plain torch functions.

Telemetry (the reference's, across this package): ``serve.frontend.
{submitted{op}, served{op,mode}, shed{reason}, deadline_miss{op},
degrade{direction}, breaker_open, breaker_close, compile, pump_error}``
counters, the ``queue_depth``, ``qps``, ``shed_rate``, ``degrade_level``
and ``breakers_open`` gauges, one ``serve.frontend.<op>.latency_s``
histogram per op and the ``frontend.pump`` span.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.analytics import engine as eng_mod
from repro_torch.ingest.serving import GenerationServer
from repro_torch.kernels.build import DEVICE_ERRORS
from repro_torch.robust.clock import SYSTEM_CLOCK, Clock

from .admission import AdmissionQueue, Answer, Request, Ticket
from .batching import BatchRunner
from .breakers import BreakerConfig, ShardBreakers
from .ladder import DegradeLadder, LadderConfig

#: mode tag per (op, ladder level) — level indexes clamp to the last entry.
_MODES = {
    "count": ("exact", "count_bounds", "count_bounds"),
    "quantile": ("exact", "quantile_bracket", "quantile_bracket"),
    "topk": ("exact", "topk_greedy", "topk_greedy"),
}


@dataclass(frozen=True)
class FrontendConfig:
    buckets: Tuple[int, ...] = (8, 32, 128)
    capacity: int = 256
    default_deadline_s: float = 0.25
    topk_k: int = 8                   # static k every top-k request shares
    #: greedy frontier budget per ladder level, × k (level 0 unused).
    greedy_budget_factors: Tuple[int, ...] = (0, 6, 3)
    #: bit levels *shaved* off the quantile descent per ladder level.
    quantile_shave: Tuple[int, ...] = (0, 2, 4)
    idle_sleep_s: float = 1e-3
    probe_shards: bool = True
    ladder: LadderConfig = field(default_factory=LadderConfig)
    breaker: BreakerConfig = field(default_factory=BreakerConfig)


class QueryFrontend:
    """Deadline-aware admission + degradation ladder over a
    ``GenerationServer`` holding a ``ShardedAnalytics`` engine."""

    def __init__(self, server: GenerationServer, *,
                 config: FrontendConfig = FrontendConfig(),
                 clock: Clock = SYSTEM_CLOCK):
        self.server = server
        self.config = config
        self.clock = clock
        self.queue = AdmissionQueue(config.capacity, clock=clock)
        self.ladder = DegradeLadder(config.ladder, clock=clock)
        self.runner = BatchRunner(config.buckets)
        engine = server.engine
        self.breakers = ShardBreakers(
            engine.num_shards,
            lambda s: self.server.engine.probe_shard(s, self.clock),
            config=config.breaker, clock=clock)
        self.served = 0
        self.deadline_misses = 0
        self.degraded_served = 0
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._error: Optional[BaseException] = None

    # ---- submission -----------------------------------------------------
    def submit(self, op: str, lo: int, hi: int, *,
               sym_lo: int = 0, sym_hi: Optional[int] = None,
               k: Optional[int] = None,
               deadline_s: Optional[float] = None) -> Ticket:
        """Admit one request; returns its ticket (already rejected with
        :class:`ShedError` if admission shed it).

        * ``count``    — symbols in ``[sym_lo, sym_hi)`` within positions
          ``[lo, hi)`` (``sym_hi`` defaults to σ);
        * ``quantile`` — ``k``-th smallest symbol in ``[lo, hi)``;
        * ``topk``     — the config-static ``topk_k`` heaviest symbols
          (a per-request ``k`` must match — k is a compiled shape).
        """
        if op not in _MODES:
            raise ValueError(f"unknown op {op!r} "
                             f"(expected one of {sorted(_MODES)})")
        if op == "count":
            b = int(self.server.engine.sigma if sym_hi is None else sym_hi)
            args = (int(lo), int(hi), int(sym_lo), b)
        elif op == "quantile":
            if k is None:
                raise ValueError("quantile requires k")
            args = (int(lo), int(hi), int(k), 0)
        else:                                     # topk
            if k is not None and int(k) != self.config.topk_k:
                raise ValueError(
                    f"topk k={k} != configured static k="
                    f"{self.config.topk_k}")
            args = (int(lo), int(hi), 0, 0)
        now = self.clock.now()
        budget = (self.config.default_deadline_s if deadline_s is None
                  else float(deadline_s))
        obs.counter("serve.frontend.submitted", op=op).inc()
        req = Request(op=op, args=args, deadline_t=now + budget,
                      submitted_t=now, ticket=Ticket())
        return self.queue.submit(req)

    # ---- op variants (ladder level → callable) --------------------------
    def _op_fn(self, op: str, level: int):
        """(mode, fn) where ``fn(engine, q)`` maps a (4, B) int32 query
        block on the engine's device to ``(a, b, coverage)`` tensors. All
        degraded variants return honest brackets; coverage comes from the
        same masked ranges the answer used."""
        cfg = self.config
        mode = _MODES[op][min(level, len(_MODES[op]) - 1)]

        def cov(eng, q):
            return eng_mod.sharded_coverage(
                eng.shard_bits, eng.num_shards, eng.n, q[0], q[1],
                eng.available, eng.device)

        if op == "count":
            if mode == "exact":
                def fn(eng, q):
                    c = eng_mod.sharded_range_count(
                        eng.shards, eng.shard_bits, eng.n,
                        q[0], q[1], q[2], q[3], eng.available,
                        eng.quantile)
                    return c, c, cov(eng, q)
            else:
                def fn(eng, q):
                    return eng_mod.sharded_range_count_bounds(
                        eng.shards, eng.shard_bits, eng.n,
                        q[0], q[1], q[2], q[3], eng.available,
                        eng.quantile)
        elif op == "quantile":
            if mode == "exact":
                def fn(eng, q):
                    # the kernel with every shard available, the plain
                    # descent under a mask
                    s = eng.range_quantile(q[0], q[1], q[2])
                    hi = torch.where(s < 0, s, s + 1)
                    return s, hi, cov(eng, q)
            else:
                shave = cfg.quantile_shave[
                    min(level, len(cfg.quantile_shave) - 1)]

                def fn(eng, q):
                    lvl = max(1, eng.shards.nbits - shave)
                    a, b = eng_mod.sharded_range_quantile_bracket(
                        eng.shards, eng.shard_bits, eng.n,
                        q[0], q[1], q[2], lvl, eng.available)
                    return a, b, cov(eng, q)
        else:                                     # topk
            if mode == "exact":
                def fn(eng, q):
                    syms, counts = eng_mod.sharded_range_topk(
                        eng.shards, eng.shard_bits, eng.n,
                        q[0], q[1], cfg.topk_k, eng.available)
                    return syms, counts, cov(eng, q)
            else:
                factor = cfg.greedy_budget_factors[
                    min(level, len(cfg.greedy_budget_factors) - 1)]
                budget = max(cfg.topk_k, factor * cfg.topk_k)

                def fn(eng, q):
                    syms, counts = eng_mod.sharded_range_topk_greedy(
                        eng.shards, eng.shard_bits, eng.n,
                        q[0], q[1], cfg.topk_k, budget=budget,
                        prune=True, available=eng.available,
                        operands=eng.quantile)
                    return syms, counts, cov(eng, q)
        return mode, fn

    # ---- serving loop ---------------------------------------------------
    def _effective_engine(self, engine, bmask):
        """Engine availability ∧ breaker mask — tripped breakers degrade
        coverage through the exact same masking path as lost shards."""
        if bmask is None or bool(bmask.all()):
            return engine
        base = (np.ones(engine.num_shards, bool)
                if engine.available is None
                else engine.available.cpu().numpy())
        return engine.with_availability(base & bmask[:engine.num_shards])

    def pump(self) -> int:
        """Serve one batch; returns the number of requests resolved.

        Safe to call from tests (synchronous, fake-clock friendly) or
        from the :meth:`start` worker thread.
        """
        pressure = self.queue.pressure
        level = self.ladder.observe(pressure)
        batch = self.queue.take(self.runner.max_batch)
        obs.gauge("serve.frontend.queue_depth").set(float(self.queue.depth))
        if not batch:
            self._publish_rates()
            return 0
        op = batch[0].op
        t0 = self.clock.now()
        with obs.span("frontend.pump", op=op, n=len(batch),
                      level=level) as sp:
            with self.server.session() as (gen, engine):
                mode, fn = self._op_fn(op, level)
                qargs = np.asarray([r.args for r in batch],
                                   np.int32).T          # (4, n)
                try:
                    if engine.num_shards != self.breakers.num_shards:
                        self.breakers.resize(engine.num_shards)
                    # a probe's device fault is raised here and, like a
                    # failed batch, rejects the tickets taken
                    bmask = (self.breakers.refresh()
                             if self.config.probe_shards else None)
                    eng = self._effective_engine(engine, bmask)
                    a, b, cov = self.runner.run((op, level), fn, eng,
                                                qargs, len(batch))
                except Exception as e:                    # noqa: BLE001
                    for r in batch:
                        r.ticket.reject(e)
                    raise
            batch_s = self.clock.now() - t0
            self.queue.observe_service(batch_s, len(batch))
            self._resolve(batch, op, mode, level, gen, a, b, cov)
            sp.set("gen", gen)
            sp.set("mode", mode)
        self._publish_rates(batch_s=batch_s, batch_n=len(batch))
        return len(batch)

    def _resolve(self, batch, op, mode, level, gen, a, b, cov) -> None:
        finish = self.clock.now()
        for i, r in enumerate(batch):
            coverage = float(cov[i])
            if op == "topk":
                value = (a[i], b[i])
            elif mode == "exact":
                value = int(a[i])
            else:
                value = (int(a[i]), int(b[i]))
            degraded = mode != "exact" or coverage < 1.0
            met = finish <= r.deadline_t
            lat = finish - r.submitted_t
            if not met:
                self.deadline_misses += 1
                obs.counter("serve.frontend.deadline_miss", op=op).inc()
            if degraded:
                self.degraded_served += 1
            self.served += 1
            obs.counter("serve.frontend.served", op=op, mode=mode).inc()
            obs.histogram(f"serve.frontend.{op}.latency_s").observe(lat)
            r.ticket.resolve(Answer(
                value=value, mode=mode, degraded=degraded,
                coverage=coverage, level=level, generation=gen,
                latency_s=lat, deadline_met=met))

    def _publish_rates(self, batch_s: float = 0.0, batch_n: int = 0
                       ) -> None:
        if batch_n and batch_s > 0:
            obs.gauge("serve.frontend.qps").set(batch_n / batch_s)
        sub = max(1, self.queue.submitted)
        obs.gauge("serve.frontend.shed_rate").set(
            self.queue.total_shed / sub)

    # ---- background worker ---------------------------------------------
    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._loop,
                                        name="frontend-pump", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while self._running:
            try:
                if self.pump() == 0:
                    self.clock.sleep(self.config.idle_sleep_s)
            except DEVICE_ERRORS as e:
                # a kernel or CUDA fault is no bad batch: stop serving and
                # hand it to ``stop``, which raises it
                self._error = e
                self._running = False
            except Exception:                             # noqa: BLE001
                # the failing batch's tickets were already rejected;
                # keep the loop alive for the rest of the stream.
                obs.counter("serve.frontend.pump_error").inc()

    def stop(self, drain: bool = True) -> None:
        """Stop the worker; with ``drain`` serve what is still queued.
        Raises the device fault that stopped the worker, if one did."""
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            self.breakers.close_pool()
            raise err
        if drain:
            while self.pump():
                pass
        self.breakers.close_pool()

    # ---- reporting ------------------------------------------------------
    def stats(self) -> dict:
        """Point-in-time accounting — ``submitted == served + shed +
        queued`` always holds (every request is resolved exactly once)."""
        return {
            "submitted": self.queue.submitted,
            "served": self.served,
            "degraded_served": self.degraded_served,
            "shed": dict(self.queue.shed_counts),
            "total_shed": self.queue.total_shed,
            "queued": self.queue.depth,
            "deadline_misses": self.deadline_misses,
            "degrade_level": self.ladder.level,
            "open_breakers": self.breakers.open_shards,
            "compiled": self.runner.compiled,
            "service_ewma_s": self.queue.service_s,
        }
