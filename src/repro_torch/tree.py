"""Leaf-wise maps over the port's frozen dataclasses of tensors.

The JAX package registers its structures as pytrees; here a structure is a
frozen dataclass whose fields are tensors, nested dataclasses, ``None`` or
static metadata (ints, bools). These helpers visit the tensor leaves in
field order.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


def _is_node(x) -> bool:
    return isinstance(x, torch.Tensor) or (dataclasses.is_dataclass(x)
                                           and not isinstance(x, type))


def tree_map(fn: Callable, *trees):
    """Apply ``fn`` to corresponding tensor leaves of ``trees`` (same
    structure); static fields are taken from the first tree."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    changes = {}
    for f in dataclasses.fields(first):
        vals = [getattr(t, f.name) for t in trees]
        if _is_node(vals[0]):
            changes[f.name] = tree_map(fn, *vals)
    return dataclasses.replace(first, **changes)


def tree_named_leaves(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """Tensor leaves keyed by their dotted field path
    (``"bitvectors.rank.words"``)."""
    out: dict[str, torch.Tensor] = {}
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        if isinstance(v, torch.Tensor):
            out[prefix + f.name] = v
        elif _is_node(v):
            out.update(tree_named_leaves(v, f"{prefix}{f.name}."))
    return out


def tree_leaves(tree) -> list[torch.Tensor]:
    return list(tree_named_leaves(tree).values())
