"""LR schedules (port of ``repro.optim.schedule``)."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``base_lr``, then a cosine decay to
    ``min_ratio · base_lr`` at ``total``; a 0-d f32 tensor on ``step``'s
    device, every op in f32 as the reference computes it (its divisions
    by tensors on that device: CUDA multiplies by the reciprocal of a host
    scalar, which rounds differently)."""
    step = torch.as_tensor(step).to(torch.float32)

    def const(v):
        return torch.full_like(step, v)
    warm = base_lr * torch.clamp(step / const(max(1, warmup)), max=1.0)
    frac = torch.clamp((step - warmup) / const(max(1, total - warmup)),
                       0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(step < warmup, warm, base_lr * cos)
