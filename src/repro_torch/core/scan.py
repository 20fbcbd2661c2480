"""Prefix sums, stable 0/1 partitions and batched gathers (port of
``repro.core.scan``). Everything runs along the last axis; leading axes
are batch axes (the reference's ``vmap`` written out)."""
from __future__ import annotations

import torch


def exclusive_sum(x: torch.Tensor, dtype=None) -> torch.Tensor:
    """out[..., i] = sum(x[..., :i]) along the last axis."""
    incl = torch.cumsum(x, -1, dtype=dtype or x.dtype)
    return incl - x.to(incl.dtype)


def inclusive_sum(x: torch.Tensor, dtype=None) -> torch.Tensor:
    """out[..., i] = sum(x[..., :i+1]) along the last axis."""
    return torch.cumsum(x, -1, dtype=dtype or x.dtype)


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
