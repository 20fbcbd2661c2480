"""Pad-and-bucket batch execution: ragged streams → a few fixed shapes
(port of ``repro.serving.batching``).

The sharded ops underneath want whole batches; a ragged request stream
wants to be served now. The runner reconciles the two:

* **buckets**: every batch is padded up to the smallest of a few fixed
  sizes (default 8/32/128), so a stream runs at most ``len(buckets)``
  shapes per (op, ladder level). Padding queries are the neutral
  ``lo == hi == 0`` empty range, which every op answers harmlessly (count
  0, quantile −1, empty top-k) and which costs one lane of a launch.
* **staging**: each batch is packed into a fresh host block and copied to
  the engine's device. ``run`` ends in the copy of the answers back to the
  host, which waits for the card, so no copy of a block is in flight when
  the next batch is packed and a second, pinned block would overlap
  nothing.
* **variants**: there is no compile step, so the reference's jit cache
  becomes the set of (op-key, bucket) variants run; ``compiled`` counts
  them, so ``QueryFrontend.stats()`` keeps its fields, and the
  reference's ``serve.frontend.compile`` counter counts each new one.

The engine rides along as an argument, so a generation hot swap needs
nothing from the runner.
"""
from __future__ import annotations

from typing import Any, Callable, Set, Tuple

import numpy as np
import torch

from repro_torch import obs

_Key = Tuple[Any, int]


class BatchRunner:
    """Bucket-padded executor for (4, B) int32 query blocks."""

    def __init__(self, buckets: Tuple[int, ...] = (8, 32, 128)):
        if not buckets or any(b <= 0 for b in buckets):
            raise ValueError(f"invalid buckets {buckets!r}")
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self._variants: Set[_Key] = set()

    def bucket_for(self, n: int) -> int:
        """Smallest bucket ≥ n (the largest bucket caps batch size;
        callers split bigger batches)."""
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    @property
    def max_batch(self) -> int:
        return self.buckets[-1]

    def run(self, key: Any, fn: Callable, engine: Any,
            qargs: np.ndarray, n: int):
        """Execute ``fn(engine, q)`` on the bucket-padded block on the
        engine's device.

        ``qargs`` is (4, n) int32 (op-specific lanes); returns ``fn``'s
        outputs as host numpy arrays with leading batch dim = bucket
        (callers slice ``[:n]``).
        """
        if n <= 0:
            raise ValueError("empty batch")
        if n > self.max_batch:
            raise ValueError(f"batch {n} exceeds max bucket "
                             f"{self.max_batch}")
        bucket = self.bucket_for(n)
        padded = np.zeros((4, bucket), np.int32)   # neutral lo == hi == 0
        padded[:, :n] = np.asarray(qargs, np.int32)[:, :n]
        q = torch.from_numpy(padded).to(engine.device)
        if (key, bucket) not in self._variants:
            obs.counter("serve.frontend.compile").inc()
        self._variants.add((key, bucket))
        out = fn(engine, q)
        return tuple(x.cpu().numpy() for x in out)

    @property
    def compiled(self) -> int:
        """(op-key, bucket) variants run so far (the reference's jit cache
        entries)."""
        return len(self._variants)
