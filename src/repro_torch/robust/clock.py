"""One clock abstraction for every deadline in the stack (port of
``repro.robust.clock``, the same classes).

``with_retry``'s ``deadline_s``, the ingester's per-shard build budget,
and the serving front-end's per-request deadlines all measure the same
thing — monotonic elapsed time — and all need to be injectable so chaos
scenarios and unit tests can run deadline logic without real sleeps.
Before this module each caller threaded its own ``sleep=``/``now=``
kwargs; now they share :class:`Clock` (real monotonic time) and tests
inject :class:`FakeClock` (manually advanced, sleeps recorded).

The contract deadline users rely on:

* ``now()`` is monotonic — never steps backwards, unaffected by wall
  clock adjustments, so ``deadline = now() + budget`` comparisons are
  safe across NTP slews.
* ``sleep(s)`` advances ``now()`` by *at least* ``s`` (exactly ``s`` on
  the fake clock), so a sleep can never leave a deadline check behind
  the time it thinks it waited.
"""
from __future__ import annotations

import time
from typing import List


class Clock:
    """Real monotonic time. Stateless — share the module singleton."""

    def now(self) -> float:
        """Monotonic seconds (``time.monotonic`` epoch — only differences
        are meaningful)."""
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


#: the default clock every deadline-taking API shares.
SYSTEM_CLOCK = Clock()


class FakeClock(Clock):
    """Deterministic clock for tests and chaos scenarios.

    ``sleep`` records the request and advances virtual time instantly, so
    retry/backoff/deadline logic runs at full speed while every timing
    decision stays observable (``sleeps``) and controllable
    (``advance``).
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)
        #: every sleep duration requested, in order.
        self.sleeps: List[float] = []

    def now(self) -> float:
        return self._t

    def sleep(self, seconds: float) -> None:
        self.sleeps.append(float(seconds))
        if seconds > 0:
            self._t += float(seconds)

    def advance(self, seconds: float) -> float:
        """Step virtual time forward; returns the new ``now()``."""
        self._t += float(seconds)
        return self._t
