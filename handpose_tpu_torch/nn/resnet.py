"""ResNet-18 trunk with the reference's k3s2 stem, eval mode.

Port of ``handpose_tpu/nn/resnet.py:44-63,143-204,230-246``.  Submodules
carry flax's names (``conv_init``, ``bn_init``, ``BasicBlock_i``,
``Conv_i``, ``BatchNorm_i``, ``conv_proj``, ``norm_proj``, ``fc``) so that
``convert.load_flax_variables`` maps a flax path to a module path
one-to-one.

Layout: NCHW tensors, in ``channels_last`` memory where the caller
provides it (the Hopper-friendly layout for cuDNN convolutions).  The
``k3s2_s2d`` and ``k7s2`` stems, ``BottleneckBlock`` and ResNet-50 wait
for later slices; so do the train-mode BatchNorm variance modes and the
max pool's gradient routes, which eval does not depend on.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.pooling import stem_max_pool
from .layers import Conv, Dense
from .norm import BatchNorm


class BasicBlock(nn.Module):
    def __init__(self, in_channels: int, filters: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(in_channels, filters, 3, stride, 1, dtype)
        self.BatchNorm_0 = BatchNorm(filters, dtype)
        self.Conv_1 = Conv(filters, filters, 3, 1, 1, dtype)
        self.BatchNorm_1 = BatchNorm(filters, dtype)
        # flax adds the projection when the residual's shape differs
        self.project = stride != 1 or in_channels != filters
        if self.project:
            self.conv_proj = Conv(in_channels, filters, 1, stride, 0, dtype)
            self.norm_proj = BatchNorm(filters, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        residual = self.norm_proj(self.conv_proj(x)) if self.project else x
        return F.relu(residual + y)


class ResNet(nn.Module):
    """ResNet trunk + ``num_classes`` fc (torchvision shape contract).

    The fc runs in the compute dtype on the float32 spatial mean, and its
    output is cast back to float32, as in the JAX package.
    """

    def __init__(self, in_channels: int, stage_sizes: Sequence[int],
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_init = Conv(in_channels, num_filters, 3, 2, 1, dtype)
        self.bn_init = BatchNorm(num_filters, dtype)
        self.blocks = []
        cin = num_filters
        for i, block_count in enumerate(stage_sizes):
            for j in range(block_count):
                stride = 2 if i > 0 and j == 0 else 1
                filters = num_filters * 2 ** i
                block = BasicBlock(cin, filters, stride, dtype)
                self.add_module(f"BasicBlock_{len(self.blocks)}", block)
                self.blocks.append(block)
                cin = filters
        self.fc = Dense(cin, num_classes, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W) -> (B, num_classes) float32."""
        x = F.relu(self.bn_init(self.conv_init(x)))
        x = stem_max_pool(x)
        for block in self.blocks:
            x = block(x)
        x = x.mean(dim=(2, 3)).to(torch.float32)
        return self.fc(x).to(torch.float32)


def ResNet18(in_channels: int, **kw) -> ResNet:
    return ResNet(in_channels, stage_sizes=[2, 2, 2, 2], **kw)


class ExtendedResNet18(nn.Module):
    """ResNet-18 trunk with modified conv1, 1000-d output (reference
    PoseViewPointNetwork.py:18-33)."""

    def __init__(self, in_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.trunk = ResNet18(in_channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.trunk(x)
