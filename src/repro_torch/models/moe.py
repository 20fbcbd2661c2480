"""Mixture-of-Experts layer on torch tensors (port of ``repro.models.moe``).

Routing-to-slots is the paper's stable-counting machinery: each routing's
rank among same-expert routings (``core.sort.bucket_ranks``) is its
capacity slot; overflowing routings are dropped (capacity-factor
semantics). All B·S·k routings share one (E, cap, D) buffer (global
dispatch); dispatch and combine are scatter-adds and a gather, the experts
one grouped product each.

Supports top-k routing, an optional dense residual branch (arctic) and
fine-grained expert counts (dbrx, arctic, jamba).
"""
from __future__ import annotations

import torch

from repro_torch.core.sort import bucket_ranks

from .layers import silu, swiglu_mlp
from .shard_ctx import constrain, fit_dim, replicated


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
    # the routings fold (b, s) into one token dim: a DTensor's s is
    # gathered first where it is sharded (DTensor folds dims only when the
    # first of them carries every shard)
    xt, gate_idx, gate = (fit_dim(t, 1, 1) for t in (x, gate_idx, gate))
    out = _moe_apply_global(xt.reshape(b * s, d), gate_idx.reshape(b * s * k),
                            gate.reshape(b * s, k), p, e, k,
                            capacity_factor).reshape(b, s, d)
    if cfg.moe_dense_residual:
        out = out + swiglu_mlp(x, p["dense"])
    return out


def _moe_apply_global(xt: torch.Tensor, flat_e: torch.Tensor,
                      gate: torch.Tensor, p: dict, e: int, k: int,
                      capacity_factor: float) -> torch.Tensor:
    """Global-batch MoE. xt: (T, D) tokens; flat_e: (T*k,) experts.

    On DTensors the routing ranks, the dispatch scatter and the combine
    run on gathered whole values (``shard_ctx.replicated``: DTensor has no
    sharded strategy for them) and the expert products on the sharded
    buffer."""
    t, d = xt.shape
    cap = max(8, int(t * k * capacity_factor / e))
    slot = replicated(lambda fe: bucket_ranks(fe, e).long(), flat_e)
    keep = slot < cap
    slot = slot.clamp(max=cap - 1)
    src = torch.arange(t, device=xt.device).repeat_interleave(k)

    def scatter(xt, flat_e, slot, keep):
        buf = torch.zeros((e, cap, d), dtype=xt.dtype, device=xt.device)
        return buf.index_put_((flat_e, slot),
                              torch.where(keep[:, None], xt[src], 0),
                              accumulate=True)

    buf = constrain(replicated(scatter, xt, flat_e, slot, keep),
                    "model", None, None)
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

    def combine(eout, flat_e, slot, keep, gate):
        tok_out = torch.where(keep[:, None], eout[flat_e, slot], 0)
        w = gate.reshape(t * k)[:, None].to(tok_out.dtype)
        return torch.zeros((t, d), dtype=tok_out.dtype,
                           device=eout.device).index_add_(0, src,
                                                          tok_out * w)

    return replicated(combine, eout, flat_e, slot, keep, gate)


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
