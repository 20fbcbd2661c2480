"""Queue-pressure-driven graceful-degradation ladder with hysteresis (port
of ``repro.serving.ladder``, the same classes).

Three rungs, applied per op by the front-end (the ladder itself only
tracks the *level*; the op → variant mapping lives in ``frontend``):

====== ==================== ======================== =======================
level  ``range_count``      ``range_quantile``       ``range_topk``
====== ==================== ======================== =======================
0      exact                exact (full refinement)  exact (full histogram)
1      ``count_bounds``     bracket, nbits−2 levels  greedy frontier, wide
                                                     budget
2      ``count_bounds``     bracket, ⌈nbits/2⌉       greedy frontier, tight
                            levels                   budget
====== ==================== ======================== =======================

Every downgraded answer is honest — bounds/brackets provably contain the
exact answer and greedy counts are true per-symbol counts — and tagged
with its mode, so the ladder trades *precision*, never correctness.

Transitions are asymmetric (hysteresis), which is what makes the ladder
monotone within a burst:

* pressure ≥ ``up_pressure``  → step **up** immediately (one rung per
  observation — overload response is prompt but not a cliff);
* pressure ≤ ``down_pressure`` *sustained for* ``cooldown_s`` → step
  down one rung. Any pressure excursion above ``down_pressure`` resets
  the cooldown, so mid-burst the ladder can only hold or climb — answer
  quality never flaps upward between two overloaded batches.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.robust.clock import SYSTEM_CLOCK, Clock


@dataclass(frozen=True)
class LadderConfig:
    up_pressure: float = 0.75     # step up at/above this queue fullness
    down_pressure: float = 0.25   # eligible to step down at/below this
    cooldown_s: float = 0.5       # sustained-calm time per downward step
    max_level: int = 2


class DegradeLadder:
    """Current degradation level, driven by ``observe(pressure)``."""

    def __init__(self, config: LadderConfig = LadderConfig(), *,
                 clock: Clock = SYSTEM_CLOCK):
        self.config = config
        self.clock = clock
        self._level = 0
        # last instant pressure was NOT low — the cooldown anchor.
        self._calm_since = clock.now()

    @property
    def level(self) -> int:
        return self._level

    def observe(self, pressure: float) -> int:
        """Fold one pressure sample into the level; returns the level the
        *next* batch must serve at."""
        cfg = self.config
        now = self.clock.now()
        if pressure > cfg.down_pressure:
            self._calm_since = now
        if pressure >= cfg.up_pressure and self._level < cfg.max_level:
            self._level += 1
        elif (pressure <= cfg.down_pressure and self._level > 0
              and now - self._calm_since >= cfg.cooldown_s):
            self._level -= 1
            self._calm_since = now          # one rung per cooldown window
        return self._level
