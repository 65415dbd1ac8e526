"""PosePrior and ViewPoint CNN heads.

Port of ``handpose_tpu/nn/heads.py:85-125`` (reference
PoseViewPointNetwork.py:35-93): a ResNet-18 trunk on the scoremap stack,
then a float32 decay MLP.
"""

from __future__ import annotations

import torch
from torch import nn

from .mlp import DecayMLP
from .resnet import ExtendedResNet18


class PosePrior(nn.Module):
    """Scoremap stack (B, C, H, W) -> (B, 63) canonical pose."""

    def __init__(self, in_channels: int, dtype: torch.dtype = torch.float32,
                 bn_variance: str = "fast"):
        super().__init__()
        self.backbone = ExtendedResNet18(in_channels, dtype=dtype,
                                         bn_variance=bn_variance)
        self.mlp = DecayMLP(1000, 63, divide=2, activation="LeakyReLU",
                            use_sigmoid=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(self.backbone(x))


class ViewPoint(nn.Module):
    """Scoremap stack (B, C, H, W) -> (ux, uy, uz), each (B, 1)."""

    def __init__(self, in_channels: int, dtype: torch.dtype = torch.float32,
                 bn_variance: str = "fast"):
        super().__init__()
        self.backbone = ExtendedResNet18(in_channels, dtype=dtype,
                                         bn_variance=bn_variance)
        self.mlp = DecayMLP(1000, 3, divide=4, activation="LeakyReLU",
                            use_sigmoid=False)

    def forward(self, x: torch.Tensor):
        out = self.mlp(self.backbone(x))
        return out[:, 0:1], out[:, 1:2], out[:, 2:3]
