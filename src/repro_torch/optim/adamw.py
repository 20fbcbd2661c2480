"""AdamW with global-norm clipping (port of ``repro.optim.adamw``).

The reference's formula as it stands, not ``torch.optim.AdamW`` (whose
decoupled decay and ``√v/√c2 + eps`` denominator round differently): clip
scale ``min(1, clip/(‖g‖ + 1e-12))``, f32 bias corrections ``1 − bᵗ``,
``delta = m̂/(√v̂ + eps) + wd·p``, the update in f32 cast back to the param
dtype. Leaves are visited in the reference's order (dict keys sorted, as
``jax.tree.leaves`` orders them), so the f32 sum of squared norms rounds
the same way.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.models.model import map_tree, tree_paths


@dataclass(frozen=True)
class AdamWState:
    m: Any                 # f32 first moments, the params' tree
    v: Any                 # f32 second moments
    step: torch.Tensor     # () int32


def adamw_init(params) -> AdamWState:
    def zeros(_, p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    step_dev = next(tree_paths(params))[1].device
    return AdamWState(m=map_tree(zeros, params), v=map_tree(zeros, params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=step_dev))


def leaves(tree) -> list[torch.Tensor]:
    """The tensor leaves of a nested dict, keys sorted."""
    return [leaf for _, leaf in tree_paths(tree)]


def global_norm(tree) -> torch.Tensor:
    """√(Σ over leaves of Σ x²), in f32, leaves in the reference's order."""
    total = 0
    for x in leaves(tree):
        total = total + x.float().square().sum()
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def _unflatten(like, flat: list):
    """``like``'s nested dict with its leaves (sorted order) from ``flat``."""
    it = iter(flat)
    order = {path: next(it) for path, _ in tree_paths(like)}
    return map_tree(lambda path, _: order[path], like)


def adamw_update(params, grads, state: AdamWState, lr: torch.Tensor,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0):
    """One AdamW step; returns (new_params, new_state, metrics)."""
    gnorm = global_norm(grads)
    # true divisions, as the reference's: ``float / tensor`` is a
    # reciprocal and a product in torch, and CUDA multiplies by the
    # reciprocal of a host scalar divisor
    scale = torch.clamp(torch.full_like(gnorm, clip_norm) / (gnorm + 1e-12),
                        max=1.0)
    step = state.step + 1
    t = step.to(torch.float32)
    c1 = 1.0 - torch.pow(b1, t)
    c2 = 1.0 - torch.pow(b2, t)

    def upd(p, g, m, v):
        g = g.float() * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g.square()
        mhat = m / c1
        vhat = v / c2
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
        new_p = (p.float() - lr * delta).to(p.dtype)
        return new_p, m, v

    out = [upd(p, g, m, v) for p, g, m, v in
           zip(leaves(params), leaves(grads), leaves(state.m),
               leaves(state.v))]
    new_params = _unflatten(params, [o[0] for o in out])
    new_m = _unflatten(params, [o[1] for o in out])
    new_v = _unflatten(params, [o[2] for o in out])
    return (new_params, AdamWState(m=new_m, v=new_v, step=step),
            {"grad_norm": gnorm})
