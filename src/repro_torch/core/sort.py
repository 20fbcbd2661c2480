"""Stable parallel integer sorting, the paper's big-node primitive (port of
``repro.core.sort``).

``backend="counting"`` is the stable integer sort via prefix sums: every
element's destination is ``(# smaller digits) + (# earlier equal digits)``.
The kernel routing is the reference's: up to 32 buckets, or n ≤ 4·512, stay
off the kernels; above that the ``radix_rank`` kernels rank CUDA tensors
when the bucket count fits them (≤ 512). Every other case takes one plain
route, the inverse of a stable ``torch.argsort``, which gives the
destinations of each of the reference's plain routes (the vectorized
one-hot and ``_blocked_rank_parts``). The latter, at 65,536 buckets, would
be some 262,144 block groups in sequence on the card.
``backend="xla"`` is ``torch.sort(..., stable=True)``, the vendor sort.

Digits may carry leading batch axes (*B, n): every row is ranked on its
own, as the reference does under ``vmap``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import bitops
from .scan import apply_permutation_dest, exclusive_sum, take

# the reference's vectorized route: these stay off the kernels
_VECTORIZED_BUCKET_LIMIT = 32
_BLOCK = 512


def _bucket_base(d: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """(*B, num_buckets) exclusive sums of the per-row histograms."""
    hist = torch.zeros(d.shape[:-1] + (num_buckets,), dtype=torch.long,
                       device=d.device)
    hist.scatter_add_(-1, d, torch.ones_like(d))
    return exclusive_sum(hist)


def _sorted_rank(digits: torch.Tensor) -> torch.Tensor:
    """Stable destinations as the inverse of a stable argsort per row."""
    order = torch.argsort(digits.long(), dim=-1, stable=True)
    return _invert_permutation(order)


def counting_rank(digits: torch.Tensor, num_buckets: int,
                  use_kernel: bool | None = None,
                  bucket_starts: torch.Tensor | None = None) -> torch.Tensor:
    """Stable sort destinations (a permutation of each row), ``int32``.

    ``use_kernel`` (default: the digits lie on a CUDA device) routes bucket
    counts up to ``radix_rank.MAX_BUCKETS`` through ``ops.radix_rank``,
    for rows shorter than ``radix_rank.MAX_ROW`` digits (the one-sweep
    scan's status words count in 30 bits). Longer rows take the argsort
    route, as the reference's bucket counts past its kernel's bound take
    its XLA route.
    ``bucket_starts`` (*B, num_buckets) int32, the exclusive scan of each
    row's digit histogram when the caller knows it, spares the kernel its
    count; the result is the same with or without it.
    """
    n = digits.shape[-1]
    if use_kernel is None:
        use_kernel = digits.device.type == "cuda"
    if (use_kernel and num_buckets > _VECTORIZED_BUCKET_LIMIT
            and n > 4 * _BLOCK):
        from repro_torch.kernels import ops
        from repro_torch.kernels import radix_rank
        if num_buckets <= radix_rank.MAX_BUCKETS and n < radix_rank.MAX_ROW:
            return ops.radix_rank(digits, num_buckets, bucket_starts)
    return _sorted_rank(digits)


def bucket_ranks(digits: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """rank_within[..., i] = # of j < i with digits[..., j] ==
    digits[..., i] (the arrival-order rank inside each bucket)."""
    d = digits.long()
    return (_sorted_rank(d).long() - take(_bucket_base(d, num_buckets),
                                          d)).to(torch.int32)


def _invert_permutation(dest: torch.Tensor) -> torch.Tensor:
    """perm[..., k] = i such that dest[..., i] == k (each row of ``dest``
    a permutation), ``int32``."""
    n = dest.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=dest.device)
    return apply_permutation_dest(idx.expand(dest.shape).contiguous(), dest)


def sort_pass(keys: torch.Tensor, digits: torch.Tensor, num_buckets: int,
              values: Optional[Tuple[torch.Tensor, ...]] = None,
              backend: str = "counting", use_kernel: bool | None = None,
              bucket_starts: torch.Tensor | None = None):
    """One stable sort pass of ``keys`` (and optional ``values``) by
    ``digits`` (each in [0, num_buckets)) along the last axis. Returns
    (keys, values). ``bucket_starts``: as in :func:`counting_rank`."""
    if backend == "xla":
        _, perm = torch.sort(digits.to(torch.int32), dim=-1, stable=True)
        new_keys = take(keys, perm)
        new_values = (tuple(take(v, perm) for v in values)
                      if values is not None else None)
        return new_keys, new_values
    if backend == "counting":
        dest = counting_rank(digits, num_buckets, use_kernel=use_kernel,
                             bucket_starts=bucket_starts)
        new_keys = apply_permutation_dest(keys, dest)
        new_values = (tuple(apply_permutation_dest(v, dest) for v in values)
                      if values is not None else None)
        return new_keys, new_values
    raise ValueError(f"unknown sort backend {backend!r}")


def sort_permutation(digits: torch.Tensor, num_buckets: int,
                     backend: str = "counting") -> torch.Tensor:
    """Gather permutation realizing the stable sort by ``digits``."""
    if backend == "xla":
        return torch.sort(digits.to(torch.int32), dim=-1,
                          stable=True)[1].to(torch.int32)
    return _invert_permutation(counting_rank(digits, num_buckets))


def radix_sort_stable(keys: torch.Tensor, key_bits: int,
                      values: Optional[Tuple[torch.Tensor, ...]] = None,
                      bits_per_pass: int = 8, backend: str = "counting",
                      use_kernel: bool | None = None):
    """LSD stable radix sort of integer ``keys`` with ``key_bits`` bits;
    ``bits_per_pass`` plays the paper's τ. Returns (keys, values).
    ``use_kernel``: as in :func:`counting_rank`, for every pass."""
    shift = 0
    while shift < key_bits:
        width = min(bits_per_pass, key_bits - shift)
        digits = bitops.extract_field(keys, shift, width)
        keys, values = sort_pass(keys, digits, 1 << width, values,
                                 backend=backend, use_kernel=use_kernel)
        shift += width
    return keys, values
