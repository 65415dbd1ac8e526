"""Train and eval steps, the train state and the Worker."""

from .state import (TrainState, cosine_epoch_schedule, create_train_state,
                    make_optimizer)
from .steps import (compute_losses, make_fused_eval_step,
                    make_fused_train_step, make_train_step)
from .trainer import Worker

__all__ = ["TrainState", "cosine_epoch_schedule", "create_train_state",
           "make_optimizer", "compute_losses", "make_fused_eval_step",
           "make_fused_train_step", "make_train_step", "Worker"]
