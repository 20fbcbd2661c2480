"""Bounded admission with per-request deadlines and reject-early shedding
(port of ``repro.serving.admission``, the same classes).

The queue is the *only* place a request can wait, so it is also the only
place overload shows up — and the contract is that overload turns into
explicit, early rejections rather than unbounded latency:

* **bounded**: at most ``capacity`` requests queue; a submit beyond that
  is shed immediately (``queue_full``) — memory and tail latency stay
  bounded no matter the offered load.
* **deadline-aware, reject-early (CoDel-style)**: every request carries
  an absolute deadline on the shared ``robust.Clock``. At submit time the
  queue estimates the sojourn ahead of the request (queue depth × an EWMA
  of observed per-request service time) and sheds ``over_budget`` work
  whose deadline cannot survive the wait — the request is rejected in
  microseconds instead of timing out after burning queue space (the
  tail-drop failure CoDel exists to prevent). At dispatch time anything
  whose deadline has already passed is shed as ``expired`` *before* it
  reaches a batch.
* **explicit rejection**: every shed resolves the caller's ticket with a
  :class:`ShedError` naming the reason — callers are never left hanging
  and never silently dropped.

``Ticket`` is the caller's handle: ``result()`` blocks (real time) until
the worker resolves it with an :class:`Answer` or a shed/failure.
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

from repro_torch.robust.clock import SYSTEM_CLOCK, Clock


class ShedError(Exception):
    """Explicit admission rejection — the request was never dispatched.

    ``reason`` is one of ``queue_full`` / ``over_budget`` / ``expired``;
    ``est_wait_s`` reports the sojourn estimate that condemned an
    over-budget request.
    """

    def __init__(self, reason: str, *, queue_depth: int = 0,
                 est_wait_s: Optional[float] = None):
        self.reason = reason
        self.queue_depth = queue_depth
        self.est_wait_s = est_wait_s
        extra = (f", est_wait={est_wait_s:.4f}s"
                 if est_wait_s is not None else "")
        super().__init__(f"request shed: {reason} "
                         f"(queue_depth={queue_depth}{extra})")


@dataclass
class Answer:
    """One resolved request — always tagged with *how* it was answered.

    ``mode`` names the op variant that produced ``value`` (``exact``,
    ``count_bounds``, ``quantile_bracket``, ``topk_greedy``);
    ``degraded`` is True whenever the ladder downgraded the op or
    coverage < 1, so callers are never silently lied to. ``coverage`` is
    the fraction of the queried range on available shards,
    ``generation`` the epoch pin the batch ran under.
    """
    value: Any
    mode: str
    degraded: bool
    coverage: float
    level: int
    generation: int
    latency_s: float
    deadline_met: bool


@dataclass
class Request:
    """One admitted query: op name + normalized int32 args + deadline."""
    op: str
    args: Tuple[int, int, int, int]      # (lo, hi, a, b) — op-specific
    deadline_t: float                    # absolute, on the shared clock
    submitted_t: float
    ticket: "Ticket" = field(repr=False, default=None)


class Ticket:
    """Caller-side future for one request (thread-safe, wait via Event)."""

    def __init__(self) -> None:
        self._event = threading.Event()
        self._answer: Optional[Answer] = None
        self._error: Optional[BaseException] = None

    # -- worker side --
    def resolve(self, answer: Answer) -> None:
        self._answer = answer
        self._event.set()

    def reject(self, error: BaseException) -> None:
        self._error = error
        self._event.set()

    # -- caller side --
    def done(self) -> bool:
        return self._event.is_set()

    @property
    def shed(self) -> bool:
        return self._event.is_set() and isinstance(self._error, ShedError)

    def result(self, timeout: Optional[float] = None) -> Answer:
        if not self._event.wait(timeout):
            raise TimeoutError("ticket not resolved in time")
        if self._error is not None:
            raise self._error
        return self._answer


class AdmissionQueue:
    """Bounded FIFO with submit-time and dispatch-time shedding.

    ``observe_service(batch_s, batch_n)`` feeds the per-request service
    EWMA the sojourn estimator uses; until the first observation the
    estimate is ``init_service_s`` (optimistic — a cold queue admits).
    """

    def __init__(self, capacity: int = 256, *,
                 clock: Clock = SYSTEM_CLOCK,
                 init_service_s: float = 1e-4,
                 ewma_alpha: float = 0.2):
        self.capacity = int(capacity)
        self.clock = clock
        self._dq: deque[Request] = deque()
        self._lock = threading.Lock()
        self._service_s = float(init_service_s)
        self._alpha = float(ewma_alpha)
        self.submitted = 0
        self.shed_counts = {"queue_full": 0, "over_budget": 0, "expired": 0}

    # ---- sizing / pressure ---------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._dq)

    @property
    def depth(self) -> int:
        return len(self)

    @property
    def pressure(self) -> float:
        """Queue fullness in [0, 1] — the degradation ladder's input."""
        return min(1.0, len(self) / max(1, self.capacity))

    @property
    def service_s(self) -> float:
        return self._service_s

    def observe_service(self, batch_s: float, batch_n: int) -> None:
        if batch_n <= 0:
            return
        per = max(0.0, float(batch_s) / batch_n)
        self._service_s += self._alpha * (per - self._service_s)

    # ---- submit-time admission -----------------------------------------
    def submit(self, req: Request) -> Ticket:
        """Admit or shed ``req``; always returns its (possibly already
        rejected) ticket."""
        ticket = req.ticket = req.ticket or Ticket()
        with self._lock:
            self.submitted += 1
            depth = len(self._dq)
            if depth >= self.capacity:
                self._shed_locked(req, "queue_full", depth)
                return ticket
            est_wait = depth * self._service_s
            budget = req.deadline_t - self.clock.now()
            if est_wait > budget:
                self._shed_locked(req, "over_budget", depth,
                                  est_wait_s=est_wait)
                return ticket
            self._dq.append(req)
        return ticket

    def _shed_locked(self, req: Request, reason: str, depth: int,
                     est_wait_s: Optional[float] = None) -> None:
        self.shed_counts[reason] += 1
        req.ticket.reject(ShedError(reason, queue_depth=depth,
                                    est_wait_s=est_wait_s))

    # ---- dispatch-time take --------------------------------------------
    def take(self, max_n: int) -> List[Request]:
        """Pop up to ``max_n`` same-op requests, shedding expired ones.

        Scans FIFO order: requests whose deadline has already passed are
        shed (``expired``) *before* dispatch; the first live request
        fixes the batch's op, later live requests of other ops stay
        queued (order preserved) so each pump serves one homogeneous,
        bucketable batch.
        """
        now = self.clock.now()
        batch: List[Request] = []
        keep: List[Request] = []
        op: Optional[str] = None
        with self._lock:
            while self._dq:
                req = self._dq.popleft()
                if req.deadline_t <= now:
                    self._shed_locked(req, "expired", len(self._dq))
                    continue
                if op is None:
                    op = req.op
                if req.op == op and len(batch) < max_n:
                    batch.append(req)
                else:
                    keep.append(req)
            self._dq.extendleft(reversed(keep))
        return batch

    @property
    def total_shed(self) -> int:
        return sum(self.shed_counts.values())
