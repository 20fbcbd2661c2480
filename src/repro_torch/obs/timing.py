"""Timing helpers shared by the CLIs, plus shape-signature tracking keyed by
(op, input shapes).

``time_compiled`` is THE timer: the first call timed apart, then ``iters``
steady-state calls, the median reported; every call ends in a wait for the
device work of its outputs (``spans.wait_for``, as ``sp.sync`` waits). The
port compiles nothing ahead of a call, so ``compile_s`` is the first
call's whole cost: on a fresh ``kernels/build`` directory that includes the
``nvcc`` build of the CUDA kernels (``kernels.build.library``), and it
always includes the first launch's module load and any allocator growth.
The name stays the reference's so the ``serve.*`` families line up.

``timed_op`` wraps one serving-op execution into the standard per-op
metric family::

    serve.<layer>.<op>.latency_s   histogram (steady-state seconds)
    serve.<layer>.<op>.compile_s   gauge     (first-call cost)
    serve.<layer>.<op>.qps         gauge     (batch / steady seconds)
    serve.<layer>.<op>.batch       gauge
    serve.<layer>.<op>.calls       counter

``track_shapes`` counts *distinct input-shape signatures* per op, walking
the tensor leaves of the arguments (``spans.tensor_leaves``: tensors,
tuples, lists, dicts and the port's dataclasses through
``repro_torch.tree``). The counters keep the reference's ``jit.calls``,
``jit.shapes`` and ``jit.recompile`` names so dashboards stay comparable;
in the port nothing recompiles, and they count the shape signatures that
the bucketed ``serving.BatchRunner`` sees: a high ``jit.shapes``-to-traffic
ratio means ragged batches escape the buckets.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Tuple

from .metrics import _state, counter, gauge, histogram
from .spans import tensor_leaves, wait_for


class Stopwatch:
    """Tiny perf_counter wrapper so call sites need no ad-hoc ``time``
    arithmetic."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self._start = self.t0

    def lap(self) -> float:
        """Seconds since construction or the previous ``lap``."""
        now = time.perf_counter()
        dt = now - self.t0
        self.t0 = now
        return dt

    def total(self) -> float:
        """Seconds since construction (laps don't reset this)."""
        return time.perf_counter() - self._start


def time_compiled(fn: Callable, *args, iters: int = 1,
                  block=None) -> Tuple[object, float, float]:
    """Run ``fn(*args)`` once (timed: the first call, see the module doc),
    then ``iters`` steady-state repeats; returns ``(out, steady_s,
    compile_s)`` with ``steady_s`` the median. Each call ends in a wait for
    its outputs' device work; ``block`` overrides what to wait for."""

    def _wait(out):
        wait_for(out if block is None else block(out))
        return out

    sw = Stopwatch()
    out = _wait(fn(*args))
    compile_s = sw.lap()
    ts = []
    for _ in range(max(1, iters)):
        sw.lap()
        out = _wait(fn(*args))
        ts.append(sw.lap())
    ts.sort()
    return out, ts[len(ts) // 2], compile_s


def record_op(layer: str, op: str, args: tuple, steady_s: float,
              compile_s: float, batch: int, iters: int) -> None:
    """Record one timed op into the ``serve.<layer>.<op>.*`` family."""
    prefix = f"serve.{layer}.{op}"
    track_shapes(f"{layer}.{op}", *args)
    counter(prefix + ".calls").inc(1 + max(1, iters))
    histogram(prefix + ".latency_s").observe(steady_s)
    gauge(prefix + ".compile_s").set(compile_s)
    gauge(prefix + ".batch").set(batch)
    if steady_s > 0:
        gauge(prefix + ".qps").set(batch / steady_s)


def timed_op(layer: str, op: str, fn: Callable, *args, batch: int = 1,
             iters: int = 1):
    """One instrumented serving-op execution (see module doc for the
    metric family). Returns ``(out, steady_s, compile_s)``."""
    out, steady_s, compile_s = time_compiled(fn, *args, iters=iters)
    record_op(layer, op, args, steady_s, compile_s, batch, iters)
    return out, steady_s, compile_s


_shape_lock = threading.Lock()
_seen_shapes: dict[str, set] = {}


def _signature(args) -> tuple:
    """(shape, dtype) of every tensor leaf of each argument; an argument
    without tensors signs as its Python type."""
    sig = []
    for a in args:
        leaves = tensor_leaves(a)
        sig += ([(tuple(t.shape), str(t.dtype)) for t in leaves] if leaves
                else [("py", type(a).__name__)])
    return tuple(sig)


def track_shapes(op: str, *args) -> bool:
    """Record the shape signature of one call to ``op``; returns True (and
    bumps ``jit.shapes{op=...}`` + ``jit.recompile``) when it is new."""
    if not _state.enabled:
        return False
    sig = _signature(args)
    with _shape_lock:
        seen = _seen_shapes.setdefault(op, set())
        new = sig not in seen
        if new:
            seen.add(sig)
    counter("jit.calls", op=op).inc()
    if new:
        counter("jit.shapes", op=op).inc()
        counter("jit.recompile").inc()
    return new


def reset_shape_tracking() -> None:
    with _shape_lock:
        _seen_shapes.clear()
