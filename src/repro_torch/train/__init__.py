"""Training runtime (port of ``repro.train``)."""
from .trainer import (TrainState, Trainer, init_train_state, make_train_step,
                      value_and_grad)

__all__ = ["TrainState", "Trainer", "init_train_state", "make_train_step",
           "value_and_grad"]
