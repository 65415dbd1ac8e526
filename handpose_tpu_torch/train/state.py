"""Train state, optimizer and learning-rate schedule.

Port of ``handpose_tpu/train/state.py:24-60``: Adam (betas 0.9/0.999,
eps 1e-8) with the reference's cosine schedule quantised to epochs
(``CosineAnnealingLR(T_max=max_epoch, eta_min)`` stepped once per
epoch).  As in optax, the update with step count ``c`` (updates taken
before it) uses the schedule's value at ``c``: step 0 uses epoch 0's
rate.  torch's Adam applies the same bias-corrected update as
``optax.adam`` (``eps_root=0``); the two round differently in float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch import nn


def cosine_epoch_schedule(base_lr: float, eta_min: float, max_epoch: int,
                          steps_per_epoch: int) -> Callable[[int], float]:
    """``schedule(step) -> lr``, computed in float32 as the JAX schedule
    is."""
    f32 = np.float32

    def schedule(step: int) -> float:
        epoch = min(step // max(steps_per_epoch, 1), max_epoch)
        cos = np.cos(f32(math.pi) * f32(epoch) / f32(max_epoch), dtype=f32)
        return float(f32(eta_min) + f32(base_lr - eta_min) * (f32(1) + cos)
                     / f32(2))

    return schedule


def make_optimizer(params, base_lr: float, eta_min: float, max_epoch: int,
                   steps_per_epoch: int):
    """(Adam over ``params``, its schedule); set each group's ``lr`` from
    the schedule before each update (:meth:`TrainState.apply_gradients`
    does)."""
    schedule = cosine_epoch_schedule(base_lr, eta_min, max_epoch,
                                     steps_per_epoch)
    opt = torch.optim.Adam(params, lr=schedule(0), betas=(0.9, 0.999),
                           eps=1e-8)
    return opt, schedule


@dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics), the optimizer,
    its schedule, and the number of updates taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0

    def apply_gradients(self) -> "TrainState":
        """One Adam update from the parameters' ``.grad`` at the rate of
        the current step; returns the state."""
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1
        return self


def create_train_state(model: nn.Module, cfg,
                       steps_per_epoch: int = 1) -> TrainState:
    """Adam over ``model``'s parameters with ``cfg.lr``, ``cfg.lr_min``
    and ``cfg.max_epoch`` (``handpose_tpu/train/state.py:43-60``); the
    model keeps its weights."""
    opt, schedule = make_optimizer(model.parameters(), cfg.lr, cfg.lr_min,
                                   cfg.max_epoch, steps_per_epoch)
    return TrainState(model, opt, schedule)
