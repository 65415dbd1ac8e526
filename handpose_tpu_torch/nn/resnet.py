"""ResNet trunks with the reference's three stems.

Port of ``handpose_tpu/nn/resnet.py:44-309``: ``BasicBlock`` and
``BottleneckBlock``, the generic ``ResNet`` (ResNet-18/34/50), the stems
``k3s2``, ``k3s2_s2d`` and ``k7s2``, ``ResNetFeatureExtractor``,
``ExtendedResNet18``, ``ExtendedResNet50`` and ``ResNetMano``.
Submodules carry flax's names (``conv_init``, ``bn_init``,
``BasicBlock_i``/``BottleneckBlock_i``, ``Conv_i``, ``BatchNorm_i``,
``conv_proj``, ``norm_proj``, ``fc``, ``fc_proj``; ``conv1``/``conv11``
and ``bn1`` in ``ResNetMano``) so that ``convert.load_flax_variables`` maps a flax path to
a module path one-to-one.

Layout: NCHW tensors, in ``channels_last`` memory where the caller
provides it (the Hopper-friendly layout for cuDNN convolutions).
``bn_variance`` picks the train-mode BatchNorm variance
(``nn/norm.py``); ``.train()``/``.eval()`` picks the batch or the running
statistics, as the JAX trunks' ``train`` argument does.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.pooling import stem_max_pool
from .layers import Conv, Dense
from .norm import make_norm

STEMS = ("k3s2", "k3s2_s2d", "k7s2")


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels: int, filters: int, stride: int,
                 dtype: torch.dtype, norm):
        """``norm(num_features)`` builds each BatchNorm
        (:func:`handpose_tpu_torch.nn.norm.make_norm`)."""
        super().__init__()
        self.Conv_0 = Conv(in_channels, filters, 3, stride, 1, dtype)
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = Conv(filters, filters, 3, 1, 1, dtype)
        self.BatchNorm_1 = norm(filters)
        # flax adds the projection when the residual's shape differs
        self.project = stride != 1 or in_channels != filters
        if self.project:
            self.conv_proj = Conv(in_channels, filters, 1, stride, 0, dtype)
            self.norm_proj = norm(filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        residual = self.norm_proj(self.conv_proj(x)) if self.project else x
        return F.relu(residual + y)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 with the stride -> 1x1 to ``4 * filters``, each with a
    BatchNorm (``handpose_tpu/nn/resnet.py:66-88``)."""

    expansion = 4

    def __init__(self, in_channels: int, filters: int, stride: int,
                 dtype: torch.dtype, norm):
        super().__init__()
        out = filters * self.expansion
        self.Conv_0 = Conv(in_channels, filters, 1, 1, 0, dtype)
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = Conv(filters, filters, 3, stride, 1, dtype)
        self.BatchNorm_1 = norm(filters)
        self.Conv_2 = Conv(filters, out, 1, 1, 0, dtype)
        self.BatchNorm_2 = norm(out)
        # flax adds the projection when the residual's shape differs: the
        # first block of stage 1 too (64 -> 256 channels at stride 1)
        self.project = stride != 1 or in_channels != out
        if self.project:
            self.conv_proj = Conv(in_channels, out, 1, stride, 0, dtype)
            self.norm_proj = norm(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = self.norm_proj(self.conv_proj(x)) if self.project else x
        return F.relu(residual + y)


def make_stem(stem: str, in_channels: int, filters: int,
              dtype: torch.dtype) -> nn.Module:
    """The ``conv_init`` of ``stem`` (``handpose_tpu/nn/resnet.py:
    177-187``)."""
    if stem in ("k3s2", "k3s2_s2d"):
        # One function and one (F, C, 3, 3) parameter: the JAX package's
        # s2d stem re-lays the same k3 s2 p1 conv out for the TPU's
        # matrix unit, which cuDNN's strided conv does not need.
        return Conv(in_channels, filters, 3, 2, 1, dtype)
    if stem == "k7s2":
        return Conv(in_channels, filters, 7, 2, 3, dtype)
    raise ValueError(f"resnet_stem {stem!r} not in {STEMS}")


class ResNet(nn.Module):
    """ResNet trunk + ``num_classes`` fc (torchvision shape contract).

    The fc runs in the compute dtype on the float32 spatial mean, and its
    output is cast back to float32, as in the JAX package.
    """

    def __init__(self, in_channels: int, stage_sizes: Sequence[int],
                 block_cls=BasicBlock, num_classes: int = 1000,
                 num_filters: int = 64, stem: str = "k3s2",
                 dtype: torch.dtype = torch.float32,
                 bn_variance: str = "fast"):
        super().__init__()
        norm = make_norm(bn_variance, dtype)
        self.conv_init = make_stem(stem, in_channels, num_filters, dtype)
        self.bn_init = norm(num_filters)
        self.blocks = []
        cin = num_filters
        for i, block_count in enumerate(stage_sizes):
            for j in range(block_count):
                stride = 2 if i > 0 and j == 0 else 1
                block = block_cls(cin, num_filters * 2 ** i, stride, dtype,
                                  norm)
                self.add_module(f"{block_cls.__name__}_{len(self.blocks)}",
                                block)
                self.blocks.append(block)
                cin = num_filters * 2 ** i * block_cls.expansion
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
    return ResNet(in_channels, stage_sizes=[2, 2, 2, 2],
                  block_cls=BasicBlock, **kw)


def ResNet34(in_channels: int, **kw) -> ResNet:
    return ResNet(in_channels, stage_sizes=[3, 4, 6, 3],
                  block_cls=BasicBlock, **kw)


def ResNet50(in_channels: int, **kw) -> ResNet:
    return ResNet(in_channels, stage_sizes=[3, 4, 6, 3],
                  block_cls=BottleneckBlock, **kw)


class ResNetFeatureExtractor(nn.Module):
    """ResNet-50 trunk (modified conv1) + fc projection to ``feat_dim``
    (reference resNetFeatureExtractor.py:10-26).  The trunk's fc runs in
    the compute dtype; ``fc_proj`` is a flax ``nn.Dense`` without a
    ``dtype``, so it runs in float32 on the trunk's float32 output."""

    def __init__(self, in_channels: int, feat_dim: int,
                 dtype: torch.dtype = torch.float32, stem: str = "k3s2",
                 bn_variance: str = "fast"):
        super().__init__()
        self.trunk = ResNet50(in_channels, dtype=dtype, stem=stem,
                              bn_variance=bn_variance)
        self.fc_proj = Dense(1000, feat_dim, torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc_proj(self.trunk(x))


class ExtendedResNet18(nn.Module):
    """ResNet-18 trunk with modified conv1, 1000-d output (reference
    PoseViewPointNetwork.py:18-33)."""

    def __init__(self, in_channels: int, dtype: torch.dtype = torch.float32,
                 stem: str = "k3s2", bn_variance: str = "fast"):
        super().__init__()
        self.trunk = ResNet18(in_channels, dtype=dtype, stem=stem,
                              bn_variance=bn_variance)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.trunk(x)


class ExtendedResNet50(nn.Module):
    """ResNet-50 trunk with modified conv1, 1000-d output (reference
    resnet50MANO.py:15-24)."""

    def __init__(self, in_channels: int, dtype: torch.dtype = torch.float32,
                 stem: str = "k3s2", bn_variance: str = "fast"):
        super().__init__()
        self.trunk = ResNet50(in_channels, dtype=dtype, stem=stem,
                              bn_variance=bn_variance)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.trunk(x)


class ResNetMano(nn.Module):
    """The boukhayma-style trunk of ``ThreeHandShapeAndPoseMANO``
    (``handpose_tpu/nn/resnet.py:268-309``, reference
    resnetMANO.py:138-235): a 7x7/s2/p3 stem, ``BasicBlock`` x [3, 4, 6,
    3] and an fc to the MANO parameter vector.

    ``in_channels`` picks the stem: ``conv1`` on the first three channels
    for 3, ``conv11`` for 24.  Only that one exists, as in the flax
    module, which creates only the branch it takes.  The pool is the
    reference's ``AvgPool2d(7)``: one output, the mean of the top-left
    ``min(7, H, W)`` square of the final map (8x8 at crop 256, so its
    last row and column are dropped).  The fc runs in float32.
    """

    def __init__(self, fc_dim: int, in_channels: int = 3,
                 dtype: torch.dtype = torch.float32,
                 bn_variance: str = "fast"):
        super().__init__()
        if in_channels not in (3, 24):
            raise ValueError("input_channel should be 3 or 24")
        norm = make_norm(bn_variance, dtype)
        self.in_channels = in_channels
        self.stem_name = "conv11" if in_channels == 24 else "conv1"
        self.add_module(self.stem_name, Conv(in_channels, 64, 7, 2, 3, dtype))
        self.bn1 = norm(64)
        self.blocks = []
        cin = 64
        for i, block_count in enumerate([3, 4, 6, 3]):
            for j in range(block_count):
                stride = 2 if i > 0 and j == 0 else 1
                block = BasicBlock(cin, 64 * 2 ** i, stride, dtype, norm)
                self.add_module(f"BasicBlock_{len(self.blocks)}", block)
                self.blocks.append(block)
                cin = 64 * 2 ** i
        self.fc = Dense(cin, fc_dim, torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W) -> (B, fc_dim) float32."""
        if self.in_channels == 3:
            x = x[:, 0:3]
        x = F.relu(self.bn1(getattr(self, self.stem_name)(x)))
        x = stem_max_pool(x)
        for block in self.blocks:
            x = block(x)
        win = min(7, x.shape[2], x.shape[3])
        x = x[:, :, :win, :win].mean(dim=(2, 3)).to(torch.float32)
        return self.fc(x)
