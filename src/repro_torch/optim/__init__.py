"""Optimizer substrate (port of ``repro.optim``): AdamW with global-norm
clipping, the cosine LR schedule, and error-feedback bitplane gradient
compression."""
from .adamw import AdamWState, adamw_init, adamw_update, global_norm
from .schedule import cosine_schedule

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm"]
