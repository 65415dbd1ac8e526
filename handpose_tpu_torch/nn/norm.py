"""BatchNorm with flax's names and eval-mode semantics.

Port of the eval path of ``handpose_tpu/nn/norm.py`` (flax
``nn.BatchNorm(use_running_average=True)``, ``norm.py:90-91,128-147``):

    y = (x - mean) * (rsqrt(var + eps) * scale) + bias

computed in float32 from the running statistics and cast to the compute
dtype.  Parameters are ``weight``/``bias`` (flax ``scale``/``bias``), the
buffers ``running_mean``/``running_var`` (flax ``mean``/``var``).  The
variance is the biased one flax keeps, not torch BatchNorm's unbiased
running variance.  Train mode (the 'fast', 'stable' and 'shifted' batch
variance modes) waits for the training slice.
"""

from __future__ import annotations

import torch
from torch import nn


class BatchNorm(nn.Module):
    def __init__(self, num_features: int, dtype: torch.dtype = torch.float32,
                 epsilon: float = 1e-5):
        super().__init__()
        self.dtype = dtype
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def reset_parameters(self, generator: torch.Generator | None = None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W) or (B, C) -> the same shape in ``dtype``."""
        if self.training:
            raise NotImplementedError(
                "train-mode BatchNorm waits for the training slice "
                "(ROADMAP.md, queue 1); call .eval()")
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mul = torch.rsqrt(self.running_var + self.epsilon) * self.weight
        y = (x.to(torch.float32) - self.running_mean.reshape(shape)) \
            * mul.reshape(shape) + self.bias.reshape(shape)
        return y.to(self.dtype)
