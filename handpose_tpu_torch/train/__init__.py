"""Train and eval steps, the train state, checkpoints, preemption and the
Worker."""

from .checkpoints import (filtered_resume, load_variables,
                          reconcile_schedule_count, save_checkpoint)
from .preemption import PreemptionGuard
from .state import (TrainState, cosine_epoch_schedule, create_train_state,
                    make_optimizer)
from .steps import (compute_losses, make_eval_step, make_fused_eval_step,
                    make_fused_train_step, make_train_step)
from .trainer import Worker

__all__ = ["TrainState", "cosine_epoch_schedule", "create_train_state",
           "make_optimizer", "compute_losses", "make_eval_step",
           "make_fused_eval_step", "make_fused_train_step",
           "make_train_step", "Worker", "PreemptionGuard", "save_checkpoint",
           "filtered_resume", "load_variables", "reconcile_schedule_count"]
