"""Epoch-fenced hot-swap serving: generation swaps that never tear a query
(port of ``repro.ingest.serving``).

``GenerationServer`` holds the current ``(generation, engine)`` pair and
hands out *pinned epochs*: a query batch enters through :meth:`session`,
reads one atomic pair, and runs every op of the batch against that one
engine object — so a batch can never observe a mixed-generation corpus,
no matter when :meth:`swap_generation` lands. Swaps are wait-free for
readers (they keep the old reference; Python object lifetime does the
rest) and the swapper can optionally *fence*: block until every session
pinned to an older generation drains, which is the point after which the
old engine is unreachable and its memory reclaimable. The fence duration
is the "hot-swap pause": it stalls the *swapper*, never the queries.

The server is engine-agnostic: anything with value semantics swaps
(``ShardedAnalytics``, ``ShardedTextIndex``). Every reader thread
launches on the engine's own device (the engines name it in each call),
not on a thread's current device. ``ShardedAnalytics.add_shards`` and
``ShardedTextIndex.add_shards`` produce the next generation's engine from
the previous one plus the newly committed shard trees;
``swap_generation`` publishes it.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Optional, Tuple


class GenerationServer:
    """Atomic (generation, engine) pair + epoch fencing for hot swaps."""

    def __init__(self, engine: Any, generation: int = 0):
        self._lock = threading.Condition()
        self._engine = engine
        self._gen = int(generation)
        self._inflight: dict[int, int] = {}      # generation -> open sessions

    # ---- reader side ----------------------------------------------------
    @property
    def generation(self) -> int:
        with self._lock:
            return self._gen

    @property
    def engine(self) -> Any:
        """The current engine (point-in-time read; batches that need
        epoch consistency across several ops must use :meth:`session`)."""
        with self._lock:
            return self._engine

    def pin(self) -> Tuple[int, Any]:
        """One atomic (generation, engine) read with no fencing — for
        single-op callers; the engine reference stays valid for as long
        as the caller holds it."""
        with self._lock:
            return self._gen, self._engine

    def session(self) -> "_Session":
        """Context manager yielding one pinned (generation, engine) pair;
        the session is fenced — a draining swap waits for its exit."""
        return _Session(self)

    def query(self, fn: Callable[[Any], Any]) -> Tuple[Any, int]:
        """Run ``fn(engine)`` inside a pinned session → (result, gen)."""
        with self.session() as (gen, eng):
            return fn(eng), gen

    # ---- swapper side ---------------------------------------------------
    def swap_generation(self, engine: Any, *, wait_drain: bool = True,
                        timeout_s: Optional[float] = None) -> int:
        """Publish ``engine`` as the next generation.

        New sessions see it immediately; in-flight sessions finish
        against the generation they pinned. ``wait_drain=True`` blocks
        the *swapper* until every older-generation session exits (the
        epoch fence); ``timeout_s`` bounds that wait (TimeoutError — the
        swap itself has already happened and is not rolled back).
        Returns the new generation number.
        """
        with self._lock:
            self._gen += 1
            new_gen = self._gen
            self._engine = engine
            if wait_drain:
                def drained() -> bool:
                    return not any(g < new_gen and c > 0
                                   for g, c in self._inflight.items())
                if not self._lock.wait_for(drained, timeout=timeout_s):
                    raise TimeoutError(
                        f"generation {new_gen - 1} did not drain within "
                        f"{timeout_s}s")
        return new_gen

    # ---- session bookkeeping -------------------------------------------
    def _enter(self) -> Tuple[int, Any]:
        with self._lock:
            self._inflight[self._gen] = self._inflight.get(self._gen, 0) + 1
            return self._gen, self._engine

    def _exit(self, gen: int) -> None:
        with self._lock:
            left = self._inflight.get(gen, 0) - 1
            if left <= 0:
                self._inflight.pop(gen, None)
            else:
                self._inflight[gen] = left
            self._lock.notify_all()


class _Session:
    def __init__(self, server: GenerationServer):
        self._server = server
        self._gen: Optional[int] = None

    def __enter__(self) -> Tuple[int, Any]:
        gen, engine = self._server._enter()
        self._gen = gen
        return gen, engine

    def __exit__(self, *exc) -> None:
        if self._gen is not None:
            self._server._exit(self._gen)
            self._gen = None
