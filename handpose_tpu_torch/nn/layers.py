"""Convolution and dense layers with flax's dtype placement and init.

flax's ``nn.Conv(dtype=d)`` and ``nn.Dense(dtype=d)`` keep float32
parameters and cast both the input and the kernel to the compute dtype
``d``; ``nn.Dense`` adds the bias after the product, in ``d``.  These
layers do the same, so a bfloat16 forward rounds where the JAX package
rounds.  Parameters use torch layouts: conv kernels OIHW, dense kernels
(out, in).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _variance_scaling_(w: torch.Tensor, scale: float, fan_in: int,
                       generator: torch.Generator | None) -> None:
    """Normal with variance ``scale / fan_in``: flax's
    ``variance_scaling(scale, 'fan_in', ...)`` without its truncation at
    two standard deviations (the same variance; untruncated sampling is
    ten times faster on the host)."""
    nn.init.normal_(w, 0.0, math.sqrt(scale / fan_in), generator=generator)


class Conv(nn.Module):
    """Bias-free 2-D convolution on NCHW tensors, computed in ``dtype``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        """He-normal, the variance of flax ``he_normal``."""
        fan_in = self.weight[0].numel()
        with torch.no_grad():
            _variance_scaling_(self.weight, 2.0, fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                        stride=self.stride, padding=self.padding)


class Dense(nn.Module):
    """Linear layer computed in ``dtype``; the bias is added after the
    product, in ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        """LeCun-normal kernel (the variance of flax's default) and zero
        bias."""
        with torch.no_grad():
            _variance_scaling_(self.weight, 1.0, self.weight.shape[1],
                               generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        return y + self.bias.to(self.dtype)
