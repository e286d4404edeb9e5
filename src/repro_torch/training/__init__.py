"""Training substrate: Adam/AdamW (from scratch), microbatch gradient
accumulation, mixed precision, and the train_step builder."""

from .adam import AdamConfig, abstract_opt_state, adam_init, adam_update
from .train_step import TrainStepConfig, make_train_step

__all__ = ["AdamConfig", "TrainStepConfig", "abstract_opt_state",
           "adam_init", "adam_update", "make_train_step"]
