"""Mixture-of-Experts layer on torch tensors (port of ``repro.models.moe``).

Routing-to-slots is the paper's stable-counting machinery: each routing's
rank among same-expert routings (``core.sort.bucket_ranks``) is its
capacity slot; overflowing routings are dropped (capacity-factor
semantics). All B·S·k routings share one (E, cap, D) buffer (global
dispatch); dispatch and combine are scatter-adds and a gather, the experts
one grouped product each.

On DTensors over a mesh whose ``model`` axis divides E the dispatch and
combine are expert-parallel (:class:`_ExpertParallel`): each device handles
its own data shard's routings to its own experts, and the buffer is sharded
on E over ``model``, as the reference constrains it. Elsewhere (plain
tensors, the 1×1 host mesh, an expert count the model axis does not divide)
they run on whole values.

Supports top-k routing, an optional dense residual branch (arctic) and
fine-grained expert counts (dbrx, arctic, jamba).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.sort import bucket_ranks

from .layers import silu, swiglu_mlp
from .shard_ctx import constrain, fit_dim, placements, replicated


def top_k(logits: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index first, as ``jax.lax.top_k`` breaks them (``torch.topk``
    promises no order for ties; bf16 router logits tie often)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_layer(x: torch.Tensor, p: dict, cfg,
              capacity_factor: float = 1.25) -> torch.Tensor:
    """x: (B, S, D) → (B, S, D).

    Params: router (D, E); w1, w3 (E, D, F); w2 (E, F, D);
    optional dense residual branch under p["dense"].
    """
    b, s, d = x.shape
    e = cfg.num_experts
    k = cfg.experts_per_token
    logits = (x @ p["router"]).float()                        # bf16 product
    gate_vals, gate_idx = top_k(logits, k)                    # (B, S, k)
    gate = torch.softmax(gate_vals, dim=-1).to(x.dtype)
    ep = _ExpertParallel.of(x, e)
    if ep is not None:
        xt, gate_idx, gate = (ep.tokens(t) for t in (x, gate_idx, gate))
    else:
        # the routings fold (b, s) into one token dim: a DTensor's s is
        # gathered first where it is sharded (DTensor folds dims only when
        # the first of them carries every shard)
        xt, gate_idx, gate = (fit_dim(t, 1, 1) for t in (x, gate_idx, gate))
    out = _moe_apply_global(xt.reshape(b * s, d), gate_idx.reshape(b * s * k),
                            gate.reshape(b * s, k), p, e, k,
                            capacity_factor, ep).reshape(b, s, d)
    if cfg.moe_dense_residual:
        out = out + swiglu_mlp(x, p["dense"])
    return out


def _moe_apply_global(xt: torch.Tensor, flat_e: torch.Tensor,
                      gate: torch.Tensor, p: dict, e: int, k: int,
                      capacity_factor: float,
                      ep: "_ExpertParallel | None" = None) -> torch.Tensor:
    """Global-batch MoE. xt: (T, D) tokens; flat_e: (T*k,) experts.

    ``ep``: the expert-parallel route of DTensor operands; without it the
    routing ranks, the dispatch scatter and the combine run on whole values
    (``shard_ctx.replicated``, the identity route on plain tensors). The
    expert products run on the buffer sharded on E either way."""
    t, d = xt.shape
    cap = max(8, int(t * k * capacity_factor / e))
    if ep is not None:
        slot, keep = ep.slots(flat_e, e, cap)
        buf = ep.dispatch(xt, flat_e, slot, keep, cap)
    else:
        slot = replicated(lambda fe: bucket_ranks(fe, e).long(), flat_e)
        keep = slot < cap
        slot = slot.clamp(max=cap - 1)
        src = torch.arange(t, device=xt.device).repeat_interleave(k)

        def scatter(xt, flat_e, slot, keep):
            buf = torch.zeros((e, cap, d), dtype=xt.dtype, device=xt.device)
            return buf.index_put_((flat_e, slot),
                                  torch.where(keep[:, None], xt[src], 0),
                                  accumulate=True)
        buf = replicated(scatter, xt, flat_e, slot, keep)
    buf = constrain(buf, "model", None, None)
    h = silu(torch.bmm(buf, p["w1"]))
    h = h * torch.bmm(buf, p["w3"])
    # pin h to the f-sharding w1 gives it (f over data): the w2 product then
    # slices w2's unsharded f locally and reduce-scatters its d output,
    # where unpinned h would be gathered over data a layer a microbatch
    h = constrain(h, "model", None, "data")
    eout = torch.bmm(h, p["w2"])                              # (E, cap, D)
    # keep eout's d sharded like w2's output dim: an unsharded d here
    # would gather the whole w2 instead of resharding the expert outputs
    eout = constrain(eout, "model", None, "data")
    if ep is not None:
        return ep.combine(eout, flat_e, slot, keep, gate, cap)

    def combine(eout, flat_e, slot, keep, gate):
        tok_out = torch.where(keep[:, None], eout[flat_e, slot], 0)
        w = gate.reshape(t * k)[:, None].to(tok_out.dtype)
        return torch.zeros((t, d), dtype=tok_out.dtype,
                           device=eout.device).index_add_(0, src,
                                                          tok_out * w)

    return replicated(combine, eout, flat_e, slot, keep, gate)


# --------------------------------------------------------------------------
# Expert-parallel dispatch and combine
# --------------------------------------------------------------------------
#
# Device (i, j) holds token shard i (the tokens are sharded over the data
# axes, contiguous in (b, s) order, and replicated over ``model``) and
# experts j·E/m … (j+1)·E/m − 1 (model shard j of m). Each step is a
# ``local_map`` over the devices' own tensors with explicit collectives on
# the mesh's process groups, so DTensor plans none of it:
#
# * slots: the stable rank of each local routing among its expert's, plus
#   the routings of that expert in the token shards before this one (an
#   all-gather of the (shards, E) int32 count table): the global
#   ``bucket_ranks`` exactly;
# * dispatch: the routings of shard i to experts of shard j scattered into
#   a zeroed (E/m, cap, D) buffer, summed over the token axes: the buffer
#   sharded on E over ``model`` and replicated over data, as the
#   reference's constraint asks. Every slot holds at most one routing, so
#   each element is one value plus zeros and the sum is exact;
# * combine: the expert outputs gathered over the axes sharding their d;
#   each device reads the rows of its routings to its experts into a
#   (T_i·k, D) block, zeros elsewhere; an exact sum over ``model``; then
#   the plain route's gate-weighted ``index_add_`` over the local tokens.


def _collective(name: str, t: torch.Tensor, *args) -> torch.Tensor:
    ops = torch.ops._c10d_functional
    return ops.wait_tensor(getattr(ops, name)(t.contiguous(), *args))


def _all_reduce(t, mesh, dim: int):
    """The sum of ``t`` over mesh dim ``dim``."""
    return _collective("all_reduce", t, "sum", mesh.get_group(dim).group_name)


def _all_gather(t, mesh, dim: int, tdim: int):
    """``t`` gathered over mesh dim ``dim`` along tensor dim ``tdim``."""
    n = mesh.size(dim)
    g = _collective("all_gather_into_tensor", t, n,
                    mesh.get_group(dim).group_name)
    return g if tdim == 0 else torch.cat(torch.chunk(g, n, 0), tdim)


def _reduce_scatter(t, mesh, dim: int, tdim: int):
    """The sum of ``t`` over mesh dim ``dim``, scattered along ``tdim``."""
    n = mesh.size(dim)
    if tdim:
        t = torch.cat(torch.chunk(t, n, tdim), 0)
    return _collective("reduce_scatter_tensor", t, "sum", n,
                       mesh.get_group(dim).group_name)


class _Dispatch(torch.autograd.Function):
    """(T_i, D) local tokens → the (E/m, cap, D) buffer of this device's
    experts, summed over the token axes. ``idx``: (T_i, k) flat slot of
    each routing in the buffer, the scratch row E/m·cap where ``mine`` is
    false. The gradient reads each routing's row back and sums over
    ``model`` (the token's experts lie on several model shards)."""

    @staticmethod
    def forward(ctx, x, idx, mine, ep, cap):
        d = x.shape[1]
        buf = x.new_zeros(ep.epl * cap + 1, d)
        for c in range(idx.shape[1]):
            buf.index_add_(0, idx[:, c], x)
        buf = buf[:-1].view(ep.epl, cap, d)
        for i in ep.tok_dims:
            buf = _all_reduce(buf, ep.mesh, i)
        ctx.save_for_backward(idx, mine)
        ctx.ep = ep
        return buf

    @staticmethod
    def backward(ctx, g):
        idx, mine = ctx.saved_tensors
        ep = ctx.ep
        flat = g.reshape(-1, g.shape[-1])
        at = torch.where(mine, idx, 0)
        gx = None
        for c in range(idx.shape[1]):
            rows = torch.where(mine[:, c, None], flat[at[:, c]], 0)
            gx = rows if gx is None else gx + rows
        return _all_reduce(gx, ep.mesh, ep.m), None, None, None, None


class _Combine(torch.autograd.Function):
    """(E/m, cap, D/s) local expert outputs → the (T_i·k, D) rows of this
    token shard's routings, each from the model shard holding its expert
    (zeros for dropped routings). ``dshard``: the mesh dims sharding the
    outputs' d, major first. The gradient scatters the rows back into the
    buffer, reduced over the token axes and scattered over ``dshard``."""

    @staticmethod
    def forward(ctx, eo, idx, mine, ep, dshard):
        full = eo
        for i in reversed(dshard):
            full = _all_gather(full, ep.mesh, i, 2)
        rows = full.reshape(-1, full.shape[-1])[torch.where(mine, idx, 0)]
        rows.masked_fill_(~mine[:, None], 0)
        ctx.save_for_backward(idx)
        ctx.ep, ctx.dshard, ctx.shape = ep, dshard, full.shape
        return _all_reduce(rows, ep.mesh, ep.m)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        ep, dshard = ctx.ep, ctx.dshard
        epl, cap, d = ctx.shape
        gb = g.new_zeros(epl * cap + 1, d).index_add_(0, idx, g)
        gb = gb[:-1].view(epl, cap, d)
        for i in ep.tok_dims:
            if i not in dshard:
                gb = _all_reduce(gb, ep.mesh, i)
        coord = ep.mesh.get_coordinate()
        for i in dshard:
            if i in ep.tok_dims:
                gb = _reduce_scatter(gb, ep.mesh, i, 2)
            else:
                gb = torch.chunk(gb, ep.mesh.size(i), 2)[coord[i]]
        return gb.contiguous(), None, None, None, None


class _ExpertParallel:
    """The expert-parallel route of a DTensor MoE (see the section comment).
    ``m``: the ``model`` mesh dim; ``tok_dims``: the mesh dims sharding the
    tokens, major first (none where the batch is replicated)."""

    def __init__(self, mesh, m: int, tok_dims: list, e: int):
        from torch.distributed.tensor import Replicate, Shard
        self.mesh, self.m, self.tok_dims = mesh, m, tok_dims
        coord = mesh.get_coordinate()
        self.j = coord[m]
        self.epl = e // mesh.size(m)
        self.shard = 0                 # this device's token shard
        for i in tok_dims:
            self.shard = self.shard * mesh.size(i) + coord[i]
        self.tok_pl = [Shard(0) if i in tok_dims else Replicate()
                       for i in range(mesh.ndim)]

    @classmethod
    def of(cls, x, e: int):
        """The route for activations ``x`` (B, S, D), or None: a plain
        tensor, a one-device mesh, a mesh without a ``model`` axis, or
        an E the model axis does not divide (the reference's buffer then
        replicates, as ``fit_spec`` drops the axis)."""
        from torch.distributed.tensor import DTensor, Shard
        if not isinstance(x, DTensor):
            return None
        mesh = x.device_mesh
        names = list(mesh.mesh_dim_names or ())
        if mesh.size() == 1 or "model" not in names:
            return None
        m = names.index("model")
        if e % mesh.size(m):
            return None
        tok = [i for i, pl in enumerate(x.placements)
               if i != m and isinstance(pl, Shard) and pl.dim == 0]
        if x.shape[0] % math.prod(mesh.size(i) for i in tok):
            tok = []
        return cls(mesh, m, tok, e)

    def tokens(self, t):
        """``t`` (B, S, ...) in the route's token placements: its batch
        sharded over ``tok_dims``, replicated elsewhere."""
        if list(t.placements) == self.tok_pl:
            return t
        return t.redistribute(self.mesh, self.tok_pl)

    def _local_map(self, fn, out_pl, in_pl):
        from torch.distributed.tensor.experimental import local_map
        return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                         device_mesh=self.mesh)

    def _route(self, fe, slot, keep, cap):
        """(T_i, k) flat buffer index of each local routing and whether it
        goes to this device's experts (kept ones only); the others point at
        the scratch row."""
        lo = self.j * self.epl
        mine = keep & (fe >= lo) & (fe < lo + self.epl)
        idx = torch.where(mine, (fe - lo) * cap + slot, self.epl * cap)
        return idx, mine

    def slots(self, flat_e, e: int, cap: int):
        """(slot clamped to cap − 1, keep) of every routing: the plain
        route's global ``bucket_ranks`` exactly."""
        def local(fe):
            fe = fe.long()
            rank = bucket_ranks(fe, e).long()
            table = torch.zeros(e, dtype=torch.int32, device=fe.device)
            table = table.scatter_add_(
                0, fe, torch.ones_like(fe, dtype=torch.int32))[None]
            for i in reversed(self.tok_dims):
                table = _all_gather(table, self.mesh, i, 0)
            slot = rank + table[:self.shard].sum(0)[fe]
            keep = slot < cap
            return slot.clamp(max=cap - 1), keep
        pl = self.tok_pl
        return self._local_map(local, (pl, pl), (pl,))(flat_e)

    def dispatch(self, xt, flat_e, slot, keep, cap: int):
        """The (E, cap, D) buffer, sharded on E over ``model``."""
        def local(x, fe, sl, kp):
            shape = (x.shape[0], fe.shape[0] // x.shape[0])
            idx, mine = self._route(fe.view(shape), sl.view(shape),
                                    kp.view(shape), cap)
            return _Dispatch.apply(x, idx, mine, self, cap)
        out_pl = placements(("model", None, None), self.mesh)
        pl = self.tok_pl
        return self._local_map(local, out_pl, (pl, pl, pl, pl))(
            xt, flat_e, slot, keep)

    def combine(self, eout, flat_e, slot, keep, gate, cap: int):
        """(T, D) gate-weighted sum of each token's expert outputs."""
        from torch.distributed.tensor import Replicate, Shard
        eo_pl = [(Shard(0) if self.mesh.size(i) > 1 else Replicate())
                 if i == self.m else
                 (p if isinstance(p, Shard) and p.dim == 2 else Replicate())
                 for i, p in enumerate(eout.placements)]
        if list(eout.placements) != eo_pl:
            eout = eout.redistribute(self.mesh, eo_pl)
        dshard = [i for i, p in enumerate(eo_pl)
                  if i != self.m and isinstance(p, Shard)]

        def local(eo, fe, sl, kp, g):
            t, k = g.shape
            idx, mine = self._route(fe.view(t, k), sl.view(t, k),
                                    kp.view(t, k), cap)
            rows = _Combine.apply(eo, idx.view(-1), mine.view(-1), self,
                                  dshard)
            w = g.reshape(t * k)[:, None].to(rows.dtype)
            src = torch.arange(t, device=rows.device).repeat_interleave(k)
            return torch.zeros((t, rows.shape[-1]), dtype=rows.dtype,
                               device=rows.device).index_add_(0, src,
                                                              rows * w)
        pl = self.tok_pl
        return self._local_map(local, pl, (eo_pl, pl, pl, pl, pl))(
            eout, flat_e, slot, keep, gate)


def moe_param_shapes(cfg, d_ff_moe: int | None = None) -> dict:
    d = cfg.d_model
    e = cfg.num_experts
    f = d_ff_moe if d_ff_moe is not None else cfg.d_ff
    shapes = {
        "router": (d, e),
        "w1": (e, d, f),
        "w3": (e, d, f),
        "w2": (e, f, d),
    }
    if cfg.moe_dense_residual:
        shapes["dense"] = {"w1": (d, cfg.d_ff), "w3": (d, cfg.d_ff),
                           "w2": (cfg.d_ff, d)}
    return shapes
