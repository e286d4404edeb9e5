"""Training substrate: Adam/AdamW (from scratch), microbatch gradient
accumulation, mixed precision, the train_step builder, and the train step
as a CUDA graph over the state it owns (``GraphTrainStep``)."""

from .adam import AdamConfig, abstract_opt_state, adam_init, adam_update
from .graph_step import GraphTrainStep
from .train_step import TrainStepConfig, make_train_step

__all__ = ["AdamConfig", "GraphTrainStep", "TrainStepConfig",
           "abstract_opt_state", "adam_init", "adam_update",
           "make_train_step"]
