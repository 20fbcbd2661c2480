"""Process-global metrics registry: counters, gauges, streaming histograms.

The port's own copy of ``repro.obs.metrics`` (stdlib only — it imports
nothing of either package, so every layer of the port can instrument
itself without cycles). Names, label encoding and snapshot layout are the
reference's, so either package's ``launch.obs`` reads the other's capture.
Three instrument kinds:

* ``Counter``   — monotone event count (path selections, fault injections,
                  new shape signatures, op invocations).
* ``Gauge``     — last-written value (coverage fraction, q/s, batch size,
                  compile seconds).
* ``Histogram`` — streaming latency/value distribution over fixed
                  log-spaced buckets. The first ``raw_cap`` observations
                  are additionally kept verbatim, so p50/p95/p99/max
                  export is *exact* for runs under the cap (every CLI in
                  this repo) and falls back to bucket-resolution estimates
                  (relative error ≤ the bucket growth factor) beyond it.
                  min/max/sum/count are always exact.

Instruments are identified by ``name`` plus sorted ``key=value`` labels,
canonicalized as ``name{k=v,...}``. ``counter()/gauge()/histogram()`` are
get-or-create and thread-safe; each instrument carries its own lock (the
front-end's pump, breaker probes, hot-swap readers and other background
threads may all record concurrently).

Disabled mode (``disable()`` / env ``REPRO_OBS=0``) is a true no-op: every
record path returns before touching any state — no locks, no attribute
writes — so instrumented hot paths cost one global-flag read.

What differs from the reference: the port runs eagerly, so an
instrumented call site looks its instrument up on every call, not once a
trace. The registry keeps a cache from ``(name, label items)`` to the
instrument in front of the canonical key, and the module-level
``counter``/``gauge``/``histogram`` are the global registry's bound
methods, so a lookup is one tuple and one dict read. Keys, instruments
and snapshots are the reference's.
"""
from __future__ import annotations

import math
import os
import threading
from typing import Dict, Iterator, List, Optional, Tuple


class _State:
    enabled: bool = os.environ.get("REPRO_OBS", "1").lower() not in (
        "0", "off", "false")


_state = _State()


def enabled() -> bool:
    """True when metric recording is active (the global on/off flag)."""
    return _state.enabled


def enable() -> None:
    _state.enabled = True


def disable() -> None:
    _state.enabled = False


class disabled:
    """Context manager: metrics off inside the block (for overhead
    benches and disabled-mode tests). Restores the prior state."""

    def __enter__(self):
        self._prev = _state.enabled
        _state.enabled = False
        return self

    def __exit__(self, *exc):
        _state.enabled = self._prev
        return False


def _key(name: str, labels: Dict[str, object]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


def parse_key(key: str) -> Tuple[str, Dict[str, str]]:
    """Inverse of the canonical encoding: ``name{k=v,...}`` → (name, labels)."""
    if not key.endswith("}") or "{" not in key:
        return key, {}
    name, _, inner = key.partition("{")
    labels = {}
    for part in inner[:-1].split(","):
        if "=" in part:
            k, _, v = part.partition("=")
            labels[k] = v
    return name, labels


class Counter:
    __slots__ = ("key", "value", "_lock")

    def __init__(self, key: str):
        self.key = key
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        if not _state.enabled:
            return
        with self._lock:
            self.value += n


class Gauge:
    __slots__ = ("key", "value", "_lock")

    def __init__(self, key: str):
        self.key = key
        self.value: Optional[float] = None
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        if not _state.enabled:
            return
        with self._lock:
            self.value = float(value)


# log-spaced bucket geometry shared by every histogram: 16 buckets per
# octave (relative width 2^(1/16) ≈ 4.4%) spanning [1e-7, 1e4) — ns-scale
# kernel launches up to multi-hour builds — plus under/overflow buckets.
_BUCKET_LO = 1e-7
_BUCKET_HI = 1e4
_BUCKETS_PER_OCTAVE = 16
_NBUCKETS = int(math.ceil(
    math.log2(_BUCKET_HI / _BUCKET_LO) * _BUCKETS_PER_OCTAVE))
_GROWTH = 2.0 ** (1.0 / _BUCKETS_PER_OCTAVE)


def bucket_upper_edge(i: int) -> float:
    """Upper value edge of log bucket ``i`` (0-based, underflow excluded)."""
    return _BUCKET_LO * (_GROWTH ** (i + 1))


class Histogram:
    """Streaming distribution: fixed log-spaced buckets + exact raw head.

    ``observe`` is O(1): one log2, one list index. Quantiles are exact
    (nearest-rank over the raw buffer) while ``count ≤ raw_cap``, else
    bucket-resolution (geometric midpoint of the covering bucket,
    relative error ≤ 2^(1/16)).
    """

    __slots__ = ("key", "count", "sum", "min", "max", "_buckets", "_raw",
                 "raw_cap", "_lock")

    def __init__(self, key: str, raw_cap: int = 8192):
        self.key = key
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._buckets: Optional[List[int]] = None   # lazy: underflow + N + overflow
        self._raw: List[float] = []
        self.raw_cap = raw_cap
        self._lock = threading.Lock()

    @staticmethod
    def bucket_index(value: float) -> int:
        """0 = underflow (< 1e-7, incl. ≤0), 1..N = log buckets, N+1 = overflow."""
        if value < _BUCKET_LO:
            return 0
        if value >= _BUCKET_HI:
            return _NBUCKETS + 1
        return 1 + min(_NBUCKETS - 1,
                       int(math.log2(value / _BUCKET_LO)
                           * _BUCKETS_PER_OCTAVE))

    def observe(self, value: float) -> None:
        if not _state.enabled:
            return
        value = float(value)
        b = self.bucket_index(value)
        with self._lock:
            if self._buckets is None:
                self._buckets = [0] * (_NBUCKETS + 2)
            self._buckets[b] += 1
            self.count += 1
            self.sum += value
            self.min = value if self.min is None else min(self.min, value)
            self.max = value if self.max is None else max(self.max, value)
            if len(self._raw) < self.raw_cap:
                self._raw.append(value)

    @property
    def exact(self) -> bool:
        """True while quantiles come from the verbatim raw buffer."""
        return self.count <= self.raw_cap

    def quantile(self, q: float) -> Optional[float]:
        """Nearest-rank quantile: the ceil(q·count)-th smallest observation
        (numpy's ``method="inverted_cdf"``). Exact under ``raw_cap``."""
        with self._lock:
            if self.count == 0:
                return None
            rank = max(1, math.ceil(q * self.count))
            if self.count <= self.raw_cap:
                return sorted(self._raw)[rank - 1]
            cum = 0
            for i, c in enumerate(self._buckets):
                cum += c
                if cum >= rank:
                    if i == 0:
                        return self.min
                    if i == _NBUCKETS + 1:
                        return self.max
                    lo = _BUCKET_LO * (_GROWTH ** (i - 1))
                    return lo * math.sqrt(_GROWTH)      # geometric midpoint
            return self.max

    def summary(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": self.sum / self.count if self.count else None,
            "min": self.min,
            "max": self.max,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
            "exact": self.exact,
        }


class MetricsRegistry:
    """Flat name→instrument map with get-or-create accessors."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}
        # (kind, name, label items) -> instrument: the per-call lookup
        self._fast: Dict[tuple, object] = {}

    def _get(self, kind: str, table: dict, make, name: str, labels: dict):
        fast = (kind, name, *labels.items())
        try:
            return self._fast[fast]
        except (KeyError, TypeError):          # new, or unhashable labels
            pass
        key = _key(name, labels)
        with self._lock:
            inst = table.get(key)
            if inst is None:
                inst = table[key] = make(key)
            try:
                self._fast[fast] = inst
            except TypeError:
                pass
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get("c", self.counters, Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("g", self.gauges, Gauge, name, labels)

    def histogram(self, name: str, raw_cap: int = 8192, **labels) -> Histogram:
        return self._get("h", self.histograms,
                         lambda key: Histogram(key, raw_cap=raw_cap), name,
                         labels)

    def iter_counters(self) -> Iterator[Tuple[str, int]]:
        for k in sorted(self.counters):
            yield k, self.counters[k].value

    def snapshot(self) -> dict:
        """Point-in-time view of every instrument (plain JSON types)."""
        with self._lock:
            counters = dict(self.counters)
            gauges = dict(self.gauges)
            hists = dict(self.histograms)
        return {
            "counters": {k: c.value for k, c in sorted(counters.items())},
            "gauges": {k: g.value for k, g in sorted(gauges.items())
                       if g.value is not None},
            "histograms": {k: h.summary() for k, h in sorted(hists.items())
                           if h.count},
        }

    def reset(self) -> None:
        """Drop every instrument (tests and fresh CLI runs)."""
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.histograms.clear()
            self._fast.clear()


#: the process-global registry every instrumented layer records into.
REGISTRY = MetricsRegistry()


#: get-or-create on the global registry (its bound methods: one call less
#: on every instrumented call site).
counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
