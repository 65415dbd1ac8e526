"""Prediction heads.

Port of ``handpose_tpu/nn/heads.py``:

* ``BoneAnglePrediction`` / ``BoneLengthPrediction``: float32 decay
  MLPs to the FK layer's angles and bone lengths (reference
  bonePrediction.py:49-108);
* ``MANOBetasPrediction`` / ``MANOThetaPrediction``: sigmoid decay MLPs
  to MANO's shape and pose parameters (reference MANOLayer.py:246-281);
* ``Pose3dPrediction`` / ``ViewPointPrediction``: float32 decay MLPs on
  ResNet-50 features (reference PoseViewPointMLP.py:15-56);
* ``PosePrior`` / ``ViewPoint``: a ResNet-18 trunk on the scoremap
  stack, then a float32 decay MLP (reference
  PoseViewPointNetwork.py:35-93).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .layers import Dense
from .mlp import DecayMLP
from .resnet import ExtendedResNet18


class BoneAnglePrediction(nn.Module):
    """(B, D) -> (root_angles (B, 3), other_angles (B, 23))."""

    def __init__(self, input_dim: int = 63, other_angles_num: int = 23):
        super().__init__()
        self.mlp1 = DecayMLP(input_dim, 3, divide=2, activation="LeakyReLU",
                             use_sigmoid=False)
        self.mlp2 = DecayMLP(input_dim, other_angles_num, divide=2,
                             activation="LeakyReLU", use_sigmoid=False)

    def forward(self, x: torch.Tensor):
        return self.mlp1(x), self.mlp2(x)


class BoneLengthPrediction(nn.Module):
    """(B, D) -> (B, 20) bone lengths."""

    def __init__(self, input_dim: int = 63, bone_length_num: int = 20):
        super().__init__()
        self.mlp1 = DecayMLP(input_dim, bone_length_num, divide=2,
                             activation="LeakyReLU", use_sigmoid=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp1(x)


class MANOBetasPrediction(nn.Module):
    """(B, D) -> (B, beta_num) shape coefficients centred at 0."""

    def __init__(self, input_dim: int, beta_num: int = 10):
        super().__init__()
        self.mlp = DecayMLP(input_dim, beta_num, divide=4, use_sigmoid=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(x) - 0.5


class MANOThetaPrediction(nn.Module):
    """(B, D) -> (root_angles (B, 3) in +-pi, other (B, pose_num) in
    +-pi/2)."""

    def __init__(self, input_dim: int, pose_num: int = 10):
        super().__init__()
        self.mlp1 = DecayMLP(input_dim, 3, divide=4, use_sigmoid=True)
        self.mlp2 = DecayMLP(input_dim, pose_num, divide=2, use_sigmoid=True)

    def forward(self, x: torch.Tensor):
        root = (self.mlp1(x) - 0.5) * 2.0 * math.pi
        return root, (self.mlp2(x) - 0.5) * math.pi


class Pose3dPrediction(nn.Module):
    """(B, D) -> (B, 3 * keypoint_num) canonical pose scaled to (-2, 2)."""

    def __init__(self, input_dim: int, keypoint_num: int = 21):
        super().__init__()
        self.mlp = DecayMLP(input_dim, keypoint_num * 3, divide=4,
                            use_sigmoid=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (self.mlp(x) - 0.5) * 4.0


class ViewPointPrediction(nn.Module):
    """(B, D) -> (ux, uy, uz), each (B, 1), via a 64-d angle bottleneck."""

    def __init__(self, input_dim: int):
        super().__init__()
        self.mlp = DecayMLP(input_dim, 64, divide=4, use_sigmoid=True)
        self.fc_vp_ux = Dense(64, 1)
        self.fc_vp_uy = Dense(64, 1)
        self.fc_vp_uz = Dense(64, 1)

    def forward(self, x: torch.Tensor):
        angles = (self.mlp(x) - 0.5) * 2.0 * math.pi
        return self.fc_vp_ux(angles), self.fc_vp_uy(angles), \
            self.fc_vp_uz(angles)


class PosePrior(nn.Module):
    """Scoremap stack (B, C, H, W) -> (B, 63) canonical pose."""

    def __init__(self, in_channels: int, dtype: torch.dtype = torch.float32,
                 bn_variance: str = "fast", stem: str = "k3s2"):
        super().__init__()
        self.backbone = ExtendedResNet18(in_channels, dtype=dtype, stem=stem,
                                         bn_variance=bn_variance)
        self.mlp = DecayMLP(1000, 63, divide=2, activation="LeakyReLU",
                            use_sigmoid=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(self.backbone(x))


class ViewPoint(nn.Module):
    """Scoremap stack (B, C, H, W) -> (ux, uy, uz), each (B, 1)."""

    def __init__(self, in_channels: int, dtype: torch.dtype = torch.float32,
                 bn_variance: str = "fast", stem: str = "k3s2"):
        super().__init__()
        self.backbone = ExtendedResNet18(in_channels, dtype=dtype, stem=stem,
                                         bn_variance=bn_variance)
        self.mlp = DecayMLP(1000, 3, divide=4, activation="LeakyReLU",
                            use_sigmoid=False)

    def forward(self, x: torch.Tensor):
        out = self.mlp(self.backbone(x))
        return out[:, 0:1], out[:, 1:2], out[:, 2:3]
