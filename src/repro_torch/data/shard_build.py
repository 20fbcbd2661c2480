"""Per-shard structure builds stacked leaf-wise (port of
``repro.data.shard_build``).

Shard builds are embarrassingly parallel: every shard runs the same
construction on its own slice. The reference fans the shards out with
``pmap`` over devices and ``vmap`` within one. The port has no traced
fan-out of a Python builder; its parallel route is the leading shard axis
its builders take themselves (``build_wavelet_matrix`` and the other
constructions accept (S, n) rows and build every row at once, which is
what the port's store and index call). This helper keeps the reference's
signature for callers that hold a one-shard builder: every ``parallel``
mode runs the per-shard loop, each row of ``shards`` on the device it lies
on, and stacks the results leaf-wise.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.tree import tree_map


def build_shards_stacked(build_one: Callable, shards, *,
                         parallel: str | bool = "auto",
                         jit_loop: bool = False,
                         retries: int = 0, backoff_s: float = 0.05):
    """Build one structure per shard row and stack them leaf-wise.

    ``shards``: (num_shards, shard_size) tensor or array (any integer
    dtype). ``parallel``: "auto" | True | False, checked as the reference
    checks it; every mode takes the loop (see the module doc).
    ``jit_loop`` is accepted for the reference's callers and has no effect:
    the port compiles nothing ahead of a call.

    ``retries > 0`` wraps the whole build in bounded retry with
    exponential backoff (``robust.faults.with_retry``), as the reference
    does. A device failure (``kernels.build.DEVICE_ERRORS``) is retried
    like any other error and re-raised once the budget is spent.
    """
    if retries > 0:
        from repro_torch.robust.faults import with_retry
        return with_retry(
            lambda: build_shards_stacked(build_one, shards,
                                         parallel=parallel,
                                         jit_loop=jit_loop, retries=0),
            retries=retries, backoff_s=backoff_s)
    if not (parallel == "auto" or parallel is True or parallel is False):
        raise ValueError(f"parallel must be 'auto'/True/False, "
                         f"got {parallel!r}")
    shards = torch.as_tensor(shards)
    built = [build_one(shards[s]) for s in range(shards.shape[0])]
    return tree_map(lambda *xs: torch.stack(xs), *built)
