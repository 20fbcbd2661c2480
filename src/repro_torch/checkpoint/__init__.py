"""Atomic step checkpoints (port of ``repro.checkpoint``): the reference's
``step_<N>/arrays.npz`` + ``meta.json`` layout, keys, dtypes and
checksums, so a snapshot written by either package loads in the other."""
from .checkpoint import (checkpoint_steps, flatten, latest_step,
                         prune_checkpoints, restore_checkpoint,
                         save_checkpoint, step_dir_valid)

__all__ = ["checkpoint_steps", "flatten", "latest_step", "prune_checkpoints",
           "restore_checkpoint", "save_checkpoint", "step_dir_valid"]
