"""Per-shard circuit breakers with hedged liveness probes (port of
``repro.serving.breakers``).

One slow or stuck shard must cost *coverage*, never queue time. Each
shard gets a three-state breaker:

* **closed** — serveable; probed at most every ``probe_interval_s``.
* **open** — recently failed; the shard is masked out of serving (the
  front-end folds the breaker mask into the engine's availability mask,
  so the bounds/coverage machinery reports the loss honestly) and no
  probes run until ``reset_after_s`` elapses.
* **half-open** — the reset window passed; exactly one trial probe runs.
  Success closes the breaker (full coverage restored), failure re-opens
  it for another window.

Probes are **hedged**: each runs on a worker thread with a generous wall
timeout (so a probe stuck inside a real device call cannot stall the
pump), and the *decision* timeout is measured on the shared injectable
``robust.Clock`` — chaos-armed ``inject_shard_latency`` stalls the probe
on that clock, so a ``FakeClock`` test sees the exact same "slow shard →
probe timeout → breaker opens" path with zero real sleeping.

A probe that fails on the device (``kernels.build.DEVICE_ERRORS``: a
kernel that cannot be built or launched, a CUDA error, the card's memory
running out) is no slow shard: it is raised out of :meth:`refresh`, so
the front-end stops instead of masking every shard and serving around a
broken card.
"""
from __future__ import annotations

import concurrent.futures
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from repro_torch import obs
from repro_torch.kernels.build import DEVICE_ERRORS
from repro_torch.robust.clock import SYSTEM_CLOCK, Clock

_CLOSED, _OPEN = 0, 1


@dataclass(frozen=True)
class BreakerConfig:
    fail_threshold: int = 2       # consecutive probe failures to open
    reset_after_s: float = 1.0    # open → half-open trial window
    probe_timeout_s: float = 0.05  # logical (clock) probe deadline
    probe_interval_s: float = 0.25  # min spacing of closed-state probes
    wall_timeout_s: float = 5.0   # hard wall cap per hedged probe


class ShardBreakers:
    """Breaker state for ``num_shards`` shards + the serveable mask.

    ``probe(shard) -> bool`` is the injected liveness check (the engines'
    ``probe_shard``, which honours chaos latency on the shared clock).
    ``refresh()`` advances due probes/state transitions and returns the
    mask; ``mask()`` returns the last result (``None`` when everything is
    closed — no pytree-structure churn for the jit cache).
    """

    def __init__(self, num_shards: int, probe: Callable[[int], bool], *,
                 config: BreakerConfig = BreakerConfig(),
                 clock: Clock = SYSTEM_CLOCK):
        self.config = config
        self.clock = clock
        self._probe = probe
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="breaker-probe")
        self.resize(num_shards)

    def resize(self, num_shards: int) -> None:
        """(Re)initialize for a generation with ``num_shards`` shards —
        all breakers start closed and immediately probe-eligible."""
        self.num_shards = int(num_shards)
        self._state = np.full(self.num_shards, _CLOSED, np.int8)
        self._fails = np.zeros(self.num_shards, np.int32)
        self._opened_t = np.zeros(self.num_shards, np.float64)
        self._next_probe_t = np.full(self.num_shards, -np.inf)
        self._mask = np.ones(self.num_shards, bool)

    # ---- hedged probe ---------------------------------------------------
    def _hedged_probe(self, s: int) -> bool:
        cfg = self.config
        t0 = self.clock.now()
        fut = self._pool.submit(self._probe, s)
        try:
            ok = bool(fut.result(timeout=cfg.wall_timeout_s))
        except concurrent.futures.TimeoutError:
            fut.cancel()
            ok = False
        except DEVICE_ERRORS:
            raise
        except Exception:                                  # noqa: BLE001
            ok = False
        # the decision deadline lives on the injectable clock: a chaos
        # latency slept on a FakeClock is invisible to the wall timeout
        # but lands here, and a real stall lands in both.
        if self.clock.now() - t0 > cfg.probe_timeout_s:
            ok = False
        return ok

    # ---- state machine --------------------------------------------------
    def refresh(self) -> np.ndarray:
        """Run due probes, advance breaker states, return the mask."""
        cfg = self.config
        for s in range(self.num_shards):
            now = self.clock.now()
            if self._state[s] == _OPEN:
                if now - self._opened_t[s] < cfg.reset_after_s:
                    continue                       # still cooling off
                # half-open: one trial probe decides
                if self._hedged_probe(s):
                    self._close(s)
                else:
                    self._open(s, half_open_retrial=True)
                continue
            if now < self._next_probe_t[s]:
                continue
            self._next_probe_t[s] = now + cfg.probe_interval_s
            if self._hedged_probe(s):
                self._fails[s] = 0
            else:
                self._fails[s] += 1
                if self._fails[s] >= cfg.fail_threshold:
                    self._open(s)
        self._mask = self._state == _CLOSED
        obs.gauge("serve.frontend.breakers_open").set(
            float(np.sum(~self._mask)))
        return self._mask

    def _open(self, s: int, half_open_retrial: bool = False) -> None:
        self._state[s] = _OPEN
        self._opened_t[s] = self.clock.now()
        self._fails[s] = 0
        obs.counter("serve.frontend.breaker_open").inc()
        obs.event("frontend.breaker_open", shard=int(s),
                  retrial=half_open_retrial)

    def _close(self, s: int) -> None:
        self._state[s] = _CLOSED
        self._fails[s] = 0
        self._next_probe_t[s] = (self.clock.now()
                                 + self.config.probe_interval_s)
        obs.counter("serve.frontend.breaker_close").inc()
        obs.event("frontend.breaker_close", shard=int(s))

    # ---- serving-side view ---------------------------------------------
    def mask(self) -> Optional[np.ndarray]:
        """(S,) bool serveable mask from the last refresh, or ``None``
        when every breaker is closed."""
        return None if bool(self._mask.all()) else self._mask.copy()

    @property
    def open_shards(self) -> list:
        return [int(s) for s in np.flatnonzero(self._state == _OPEN)]

    def close_pool(self) -> None:
        self._pool.shutdown(wait=False)
