"""Ambient activation-sharding context (port of ``repro.models.shard_ctx``).

The launcher declares the mesh's data-parallel axes and axis sizes before
the step runs (``set_mesh_context``, or ``launch.mesh.set_mesh``), and model
code marks activation layouts with ``constrain(x, "dp", None, "model")``
hints. A hint redistributes a DTensor to the placements of its fitted spec,
where the reference pins a GSPMD sharding constraint. Hints are the
identity for a plain tensor (the unsharded serving and training paths)
and when no context is set, and drop a mesh axis that does not divide its
dimension evenly (shape-aware, like the params' ``fit_spec``). They keep
activations sharded over the batch under FSDP-sharded weights.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

_DP_AXES: Optional[Tuple[str, ...]] = None
_AXIS_SIZES: Optional[dict] = None


def set_mesh_context(dp_axes, axis_sizes) -> None:
    global _DP_AXES, _AXIS_SIZES
    _DP_AXES = tuple(dp_axes) if dp_axes else None
    _AXIS_SIZES = dict(axis_sizes) if axis_sizes else None


def clear_mesh_context() -> None:
    set_mesh_context(None, None)


def placements(spec, mesh) -> list:
    """DTensor placements, one per mesh dim, of a spec tuple (one entry per
    tensor dim: ``None``, an axis name, or a tuple of names sharding that
    dim over several mesh axes, major first). Mesh axes the spec does not
    name replicate, and so do axes of size 1: a shard over one device is
    the whole dim, and DTensor's view rules would refuse to merge or
    squeeze a dim so marked (the 1×1 host mesh)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"axis order {names}")
        for i in idx:
            if mesh.size(i) > 1:
                out[i] = Shard(dim)
    return out


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a device mesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def distribute(x: torch.Tensor, mesh, placements):
    """A tensor every rank holds whole, as a DTensor of ``placements`` on
    ``mesh``: each rank keeps its own shard of its copy (no collective)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, mesh, placements, src_data_rank=None)


def constrain(x: torch.Tensor, *dims):
    """dims: one entry per axis of x — "dp", a mesh axis name, or None.
    "dp" shards over every data-parallel axis, or over the minor ones
    whose product divides the dim (:func:`_dp_fit`)."""
    if _DP_AXES is None or _AXIS_SIZES is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = []
    for size, d in zip(x.shape, dims):
        if d is None:
            spec.append(None)
            continue
        axes = _dp_fit(size) if d == "dp" else (d,)
        total = math.prod(_AXIS_SIZES.get(a, 1) for a in axes)
        spec.append((axes if d == "dp" else d)
                    if (axes and total and size % total == 0) else None)
    mesh = x.device_mesh
    want = placements(spec, mesh)
    if list(x.placements) == want:
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return _dense(_Constrain.apply(x, want))
    return _dense(x.redistribute(mesh, want))


def minor_fit(axes: tuple, size_of, size: int) -> tuple:
    """The minor ones of ``axes`` (major first) whose product divides
    ``size``: a batch of ``size`` shards over them and is replicated over
    the major ones dropped (a 16-example microbatch on the 2×16×16 mesh:
    ``data``, replicated over ``pod``). ``size_of(axis)``: its size."""
    while axes and size % math.prod(size_of(a) for a in axes):
        axes = axes[1:]
    return axes


def _dp_fit(size: int) -> tuple:
    """The data-parallel axes a batch of ``size`` shards over
    (:func:`minor_fit`)."""
    return minor_fit(tuple(_DP_AXES), lambda a: _AXIS_SIZES.get(a, 1), size)


def _dense(x):
    """``x`` with a contiguous shard: a redistribution onto an inner dim
    leaves each shard a strided view, and DTensor's later views of the
    shard (a product folding its batch dims) then fail."""
    local = x.to_local()
    if local.is_contiguous():
        return x
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local.contiguous(), x.device_mesh,
                              x.placements, run_check=False, shape=x.shape,
                              stride=x.stride())


class _Constrain(torch.autograd.Function):
    """A redistribution whose gradient is redistributed to the same
    placements, as a sharding constraint's transpose constrains the
    cotangent: a plain ``redistribute`` would hand its gradient back in the
    input's placements (a ``Partial`` product's gradient then goes out
    replicated: a gather of the whole cotangent on every device)."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        return x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(grad.device_mesh, ctx.want), None


def grad_as_forward(x: torch.Tensor):
    """``x``, its gradient redistributed to ``x``'s own placements (the
    identity for a plain tensor or without grad): a view's backward must
    get a gradient laid out as the view's output was, which DTensor's plan
    of the next op's backward need not give."""
    if (not hasattr(x, "device_mesh") or not x.requires_grad
            or not torch.is_grad_enabled()):
        return x
    return _Constrain.apply(x, list(x.placements))


def gather_dp(x: torch.Tensor):
    """A weight with its data-parallel shards gathered (FSDP's unshard
    before use), its other shards kept; the gradient goes back through a
    reduce-scatter. The identity for a plain tensor or without a context.
    Left to choose, DTensor multiplies a batch-sharded activation by a
    weight sharded on the contraction dim over the same axis by gathering
    the batch and all-reducing the product, a full activation a layer."""
    if _DP_AXES is None or not hasattr(x, "device_mesh"):
        return x
    from torch.distributed.tensor import Replicate
    names = x.device_mesh.mesh_dim_names
    want = [Replicate() if names[i] in _DP_AXES else p
            for i, p in enumerate(x.placements)]
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def reduce_partial(x: torch.Tensor):
    """A DTensor's pending sums reduced (``Partial`` to ``Replicate``: an
    all-reduce), as a row-parallel product's output is. Left pending into
    the next block's products, DTensor (2.11 and 2.13 alike) can plan a
    product on a 3-D mesh whose shards do not match its local operands.
    The identity for a plain tensor."""
    from torch.distributed.tensor import Partial, Replicate
    if not hasattr(x, "device_mesh") or not any(
            isinstance(p, Partial) for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if isinstance(p, Partial) else p for p in x.placements])


def _fit(x, dim: int, parts: int):
    """``x`` with its dim ``dim`` replicated unless its shard count divides
    ``parts`` (all or nothing, as ``fit_spec`` fits a spec entry)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    shards = [i for i, p in enumerate(x.placements)
              if isinstance(p, Shard) and p.dim == dim % x.dim()]
    if parts % math.prod(mesh.size(i) for i in shards) == 0:
        return x
    return x.redistribute(mesh, [Replicate() if i in shards else p
                                 for i, p in enumerate(x.placements)])


def fit_batch(x, parts: int):
    """``x`` with its dim 0 sharded over the minor mesh axes already
    sharding it whose sizes divide ``parts`` (:func:`minor_fit`), the major
    ones replicated (a batch sharded over ``pod`` × ``data`` cut into
    microbatches of 16: sharded over ``data``). The identity for a plain
    tensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    shards = minor_fit(tuple(i for i, p in enumerate(x.placements)
                             if isinstance(p, Shard) and p.dim == 0),
                       mesh.size, parts)
    want = [Replicate() if isinstance(p, Shard) and p.dim == 0
            and i not in shards else p for i, p in enumerate(x.placements)]
    return x if want == list(x.placements) else x.redistribute(mesh, want)


class _FitGrad(torch.autograd.Function):
    """The identity, whose gradient goes through :func:`_fit`."""

    @staticmethod
    def forward(ctx, x, dim, parts):
        ctx.dim, ctx.parts = dim, parts
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _fit(grad, ctx.dim, ctx.parts), None, None


def fit_dim(x: torch.Tensor, dim: int, parts: int):
    """``x``, and its gradient, with tensor dim ``dim`` replicated where its
    shards would not split evenly into ``parts``: for a DTensor dim about
    to be unflattened into ``parts`` × rest (or just flattened from it,
    whose gradient is unflattened). DTensor has no strategy for an uneven
    unflatten; GSPMD pads there. Attention, where the heads are such a dim,
    takes a head-parallel route of its own in training and prefill
    (``layers._head_parallel``); the decode step's heads and the
    projections' other uses gather here. The identity for a plain
    tensor."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    x = _fit(x, dim, parts)
    if x.requires_grad and torch.is_grad_enabled():
        x = _FitGrad.apply(x, dim, parts)
    return x


# Explicit collectives on a mesh dim's process group, for the placements
# DTensor cannot plan (the MoE's expert-parallel route, the vocabulary-
# parallel loss): called on local tensors inside a ``local_map``.

def _collective(name: str, t: torch.Tensor, *args) -> torch.Tensor:
    ops = torch.ops._c10d_functional
    return ops.wait_tensor(getattr(ops, name)(t.contiguous(), *args))


def all_reduce(t, mesh, dim: int, op: str = "sum"):
    """``t`` reduced by ``op`` ("sum" or "max") over mesh dim ``dim``."""
    return _collective("all_reduce", t, op, mesh.get_group(dim).group_name)


def all_gather(t, mesh, dim: int, tdim: int):
    """``t`` gathered over mesh dim ``dim`` along tensor dim ``tdim``."""
    n = mesh.size(dim)
    g = _collective("all_gather_into_tensor", t, n,
                    mesh.get_group(dim).group_name)
    return g if tdim == 0 else torch.cat(torch.chunk(g, n, 0), tdim)


def reduce_scatter(t, mesh, dim: int, tdim: int):
    """The sum of ``t`` over mesh dim ``dim``, scattered along ``tdim``."""
    n = mesh.size(dim)
    if tdim:
        t = torch.cat(torch.chunk(t, n, tdim), 0)
    return _collective("reduce_scatter_tensor", t, "sum", n,
                       mesh.get_group(dim).group_name)


def replicated(fn, *args):
    """``fn(*args)`` on whole values, for an op DTensor has no sharded
    strategy for: DTensor arguments are gathered to ``Replicate`` first and
    ``fn`` runs on their local tensors (``local_map``); its tensor result
    comes back as a replicated DTensor. Every device then holds the whole
    of each argument: the MoE takes this route only where its experts do
    not divide the model axis (``models.moe``; where they do, its dispatch
    and combine are expert-parallel, as the reference's plan places
    them). Without a DTensor argument it is ``fn(*args)``."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = next((a.device_mesh for a in args if isinstance(a, DTensor)),
                None)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map
    rep = [Replicate()] * mesh.ndim
    args = [a.redistribute(mesh, rep) if isinstance(a, DTensor) else a
            for a in args]
    return local_map(fn, out_placements=rep,
                     in_placements=tuple(rep if isinstance(a, DTensor)
                                         else None for a in args),
                     device_mesh=mesh)(*args)
