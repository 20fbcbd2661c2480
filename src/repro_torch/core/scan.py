"""Prefix sums, stable 0/1 partitions and batched gathers (port of
``repro.core.scan``). Everything runs along the last axis; leading axes
are batch axes (the reference's ``vmap`` written out)."""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def exclusive_sum(x: torch.Tensor, dtype=None) -> torch.Tensor:
    """out[..., i] = sum(x[..., :i]) along the last axis."""
    incl = torch.cumsum(x, -1, dtype=dtype or x.dtype)
    return incl - x.to(incl.dtype)


def inclusive_sum(x: torch.Tensor, dtype=None) -> torch.Tensor:
    """out[..., i] = sum(x[..., :i+1]) along the last axis."""
    return torch.cumsum(x, -1, dtype=dtype or x.dtype)


def flat_inclusive_sum(x: torch.Tensor) -> torch.Tensor:
    """:func:`inclusive_sum` of each row of 0/1 flags ``x`` (*B, n),
    ``int32``, computed as one 1-D scan of the rows laid end to end less
    each row's carry-in: torch runs a device-wide scan only for a 1-D
    tensor, and walks an axis of a 2-D one row by row."""
    if x.numel() == 0:
        return torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    x = x.to(torch.int32)
    dt = torch.int32 if x.numel() < 2**31 else torch.int64
    c = torch.cumsum(x.reshape(-1), 0, dtype=dt).reshape(x.shape)
    return (c - (c[..., :1] - x[..., :1])).to(torch.int32)


def prefix_scan(op: Callable, x, reverse: bool = False, axis: int = 0):
    """Inclusive scan of ``x`` along ``axis`` with an associative ``op``.

    ``x`` is a tensor or a tuple of tensors of one length along ``axis``
    (``op`` then takes and returns tuples), as the reference's
    ``jax.lax.associative_scan``; ``op(a, b)`` combines an earlier ``a``
    with a later ``b``. torch has no public associative scan, so this is
    Hillis–Steele doubling: ceil(log2 n) rounds, round d combining every
    element with the one 2^d before it through shifted views. ``reverse``
    scans from the end, as the reference does (flip, scan, flip).
    """
    single = isinstance(x, torch.Tensor)
    xs = (x,) if single else tuple(x)
    n = xs[0].shape[axis]
    if reverse:
        xs = tuple(t.flip(axis) for t in xs)
    d = 1
    while d < n:
        a = tuple(t.narrow(axis, 0, n - d) for t in xs)
        b = tuple(t.narrow(axis, d, n - d) for t in xs)
        c = (op(a[0], b[0]),) if single else tuple(op(a, b))
        xs = tuple(torch.cat([t.narrow(axis, 0, d), ct], axis)
                   for t, ct in zip(xs, c))
        d *= 2
    if reverse:
        xs = tuple(t.flip(axis) for t in xs)
    return xs[0] if single else xs


def segment_offsets(segment_sizes: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Exclusive offsets of variable-length segments, ``int32``.
    ``num_segments`` is kept for the reference's signature."""
    del num_segments
    return exclusive_sum(segment_sizes.to(torch.int32))


def running_max(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running max along the last axis (``torch.cummax``).

    torch's CUDA cummax walks each row in sequence, so one long row is cut
    into about sqrt(n) rows of C: a cummax within the rows (run in
    parallel over rows), a cummax over the rows' last values (one row of
    n / C), and each row raised to the running max of the rows before it.
    """
    n = x.shape[-1]
    cols = 1 << max(5, (n.bit_length() + 1) // 2)
    if n <= cols:
        return torch.cummax(x, -1).values
    lead = x.shape[:-1]
    rows = -(-n // cols)
    local = torch.cummax(F.pad(x, (0, rows * cols - n)).reshape(
        lead + (rows, cols)), -1).values
    carry = torch.cummax(local[..., -1], -1).values
    # row 0 has no carry: its own first value leaves it as it is
    before = torch.cat([local[..., :1, 0], carry[..., :-1]], -1)
    out = torch.maximum(local, before[..., None])
    return out.reshape(lead + (rows * cols,))[..., :n]


def segmented_exclusive_sum(x: torch.Tensor,
                            segment_starts: torch.Tensor) -> torch.Tensor:
    """Segmented exclusive prefix sum along the last axis, ``int32``.

    ``segment_starts`` marks (nonzero) the first element of each segment.
    The reference scans (value, flag) pairs with a custom associative
    operator; here it is one cumsum less the cumsum at each element's
    segment start, the start being the running max of the marked positions
    (a position before the first mark counts from 0, as the reference's
    scan does). Both are int32 arithmetic modulo 2^32: the sums run in
    int64 and wrap to int32 once, which gives the reference's values even
    where its int32 running total overflows.
    """
    xi = x.to(torch.int32).long()
    excl = torch.cumsum(xi, -1) - xi
    pos = torch.arange(x.shape[-1], device=x.device)
    start = running_max(torch.where(segment_starts != 0, pos, 0))
    return (excl - torch.gather(excl, -1, start.expand_as(excl))).to(
        torch.int32)


def segment_ids_from_starts(starts: torch.Tensor, n: int) -> torch.Tensor:
    """Segment id of every position given sorted segment start offsets.

    ``starts`` (S,), non-decreasing, ``starts[0] == 0``; position p belongs
    to the largest segment s with ``starts[s] <= p``, so empty segments
    (which share a start with the next) own no positions, and starts equal
    to n (trailing empty segments) own none either. The reference marks run
    starts and takes a running max; the largest such s is the number of
    starts at or below p, less one, which ``searchsorted`` gives in parallel
    (torch's running max walks one long row in sequence on the card).
    ``int32``.
    """
    p = torch.arange(n, device=starts.device)
    return (torch.searchsorted(starts.long().contiguous(), p, right=True)
            - 1).to(torch.int32)


def stable_partition_indices(flags: torch.Tensor) -> torch.Tensor:
    """Destination of each element under a stable 0/1 partition along the
    last axis: zeros keep order and go first, ones follow. ``int64``."""
    flags = flags.long()
    ones_before = exclusive_sum(flags)
    idx = torch.arange(flags.shape[-1], device=flags.device)
    zeros_before = idx - ones_before
    total_zeros = flags.shape[-1] - flags.sum(-1, keepdim=True)
    return torch.where(flags == 0, zeros_before, total_zeros + ones_before)


def apply_permutation_dest(values: torch.Tensor,
                           dest: torch.Tensor) -> torch.Tensor:
    """Scatter ``values[..., i]`` to position ``dest[..., i]`` (each row of
    ``dest`` is a permutation)."""
    return torch.empty_like(values).scatter_(-1, dest.long(), values)


def lift(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Append unit axes to a per-row value ``x`` (*B,) so it broadcasts
    against per-query values ``like`` (*B, *Q)."""
    return x.reshape(x.shape + (1,) * (like.dim() - x.dim()))


def take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[..., idx]`` per batch row.

    ``table``: (*B, T); ``idx``: (*B, *Q) with the same leading batch axes
    (for a 1-D table, any shape). The batched form of the reference's
    ``table[idx]`` under ``vmap``.
    """
    if table.dim() == 1:
        return table[idx.long()]
    lead = table.shape[:-1]
    if idx.shape[:len(lead)] != lead:
        raise ValueError(f"index shape {tuple(idx.shape)} does not start "
                         f"with the table's batch shape {tuple(lead)}")
    rows = table.reshape(-1, table.shape[-1])
    flat = idx.long().reshape(rows.shape[0], -1)
    return torch.gather(rows, 1, flat).reshape(idx.shape)
