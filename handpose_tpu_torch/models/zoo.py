"""The model zoo on the JAX package's forward contract.

Port of ``handpose_tpu/models/zoo.py``; this slice carries
``Hand3DPosePriorNetwork`` (M10, the reference's default model) and the
ResNet-50 family: ``TwoDimHandPose`` (M1), ``OnlyThreeDimHandPose`` (M4)
and ``Hand3DPoseNet`` (M9).  Every model is called as

    model(img (B, H, W, C) NHWC, camera_intrinsic_matrix,
          index_root_bone_length, keypoint_xyz_root, pose_x0=None)
      -> ModelOutput

``model.train()`` selects train-mode BatchNorm (batch statistics,
running statistics updated), ``model.eval()`` the running statistics:
the JAX models' ``train`` argument.  The stem pool's gradient is one
function whatever ``cfg.pool_grad`` names (``ops/pooling.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..config import MODEL_NAMES, Config
from ..nn.heads import (PosePrior, Pose3dPrediction, ViewPoint,
                        ViewPointPrediction)
from ..nn.layers import Dense
from ..nn.mlp import DecayMLP
from ..nn.resnet import ResNetFeatureExtractor
from ..ops.pooling import POOL_GRADS
from ..ops.projection import batch_project_xyz_to_uv, rel_normed_to_absolute
from ..ops.rotations import axis_angle_rot_mat


def compute_dtype(cfg: Config) -> torch.dtype:
    """Backbone compute dtype; geometry and heads stay float32."""
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


@dataclass
class ModelOutput:
    xyz: Optional[torch.Tensor] = None         # (B, 21, 3) absolute coords
    uv: Optional[torch.Tensor] = None          # (B, 21, 2) pixel coords
    diffusion_loss: Optional[torch.Tensor] = None
    theta: Optional[torch.Tensor] = None       # MANO pose params
    beta: Optional[torch.Tensor] = None        # MANO shape params
    # trainer-B training outputs (reference Hand3DPoseNet.py:49-52)
    coord_xyz_rel_normed: Optional[torch.Tensor] = None
    can_xyz: Optional[torch.Tensor] = None     # canonical coords (B, 21, 3)
    rot_mat: Optional[torch.Tensor] = None     # viewpoint rotation (B, 3, 3)


def _check_pool_grad(cfg: Config):
    if cfg.pool_grad not in POOL_GRADS:
        raise ValueError(f"pool_grad {cfg.pool_grad!r} not in {POOL_GRADS}")


def _trunk_input(img: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """NHWC -> an NCHW view cast once to the compute dtype in
    channels_last memory (flax casts in the first conv)."""
    return img.permute(0, 3, 1, 2).to(dtype=dtype,
                                      memory_format=torch.channels_last)


class _ResNet50Model(nn.Module):
    """The ``resnet_extractor`` every ResNet-50 model of this slice opens
    with: ``ResNetFeatureExtractor(cfg.resnet_out_feature_dim)``."""

    def __init__(self, cfg: Config):
        super().__init__()
        _check_pool_grad(cfg)
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        self.resnet_extractor = ResNetFeatureExtractor(
            cfg.input_channels, cfg.resnet_out_feature_dim, self.dtype,
            cfg.resnet_stem, cfg.bn_mode)

    def features(self, img: torch.Tensor) -> torch.Tensor:
        return self.resnet_extractor(_trunk_input(img, self.dtype))


class _TwoDimMLP(nn.Module):
    """The explicit 5-layer sigmoid uv head of M1/M2
    (``handpose_tpu/models/zoo.py:67-81``, reference
    TwoDimHandPose.py:21-34)."""

    def __init__(self, feat_dim: int, keypoint_num: int):
        super().__init__()
        dims = ([feat_dim] + [feat_dim // 2 ** i for i in range(1, 5)]
                + [keypoint_num * 2])
        self.layers = []
        for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
            layer = Dense(din, dout)
            self.add_module(f"Dense_{i}", layer)
            self.layers.append(layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return torch.sigmoid(self.layers[-1](x))


class TwoDimHandPose(_ResNet50Model):
    """M1: ResNet-50 -> MLP -> 21 x (u, v) (reference TwoDimHandPose.py)."""

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self.twoDimPoseEstimate = _TwoDimMLP(cfg.resnet_out_feature_dim,
                                             cfg.keypoint_num)

    def forward(self, img: torch.Tensor, camera_intrinsic_matrix=None,
                index_root_bone_length=None, keypoint_xyz_root=None,
                pose_x0=None) -> ModelOutput:
        # the NHWC input's width and height scale the sigmoid outputs
        B, h, w = img.shape[0], img.shape[1], img.shape[2]
        pose = self.twoDimPoseEstimate(self.features(img)).reshape(B, -1, 2)
        uv = torch.stack([pose[..., 0] * w, pose[..., 1] * h], dim=-1)
        return ModelOutput(uv=uv, diffusion_loss=torch.zeros(
            (), device=img.device))


class OnlyThreeDimHandPose(_ResNet50Model):
    """M4: direct 63-d xyz and its projection, no FK
    (reference OnlyThreeDimHandPose.py)."""

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self.threeDimPoseEstimate = DecayMLP(
            cfg.resnet_out_feature_dim, cfg.keypoint_num * 3, divide=2,
            activation="LeakyReLU", use_sigmoid=False)

    def forward(self, img: torch.Tensor, camera_intrinsic_matrix=None,
                index_root_bone_length=None, keypoint_xyz_root=None,
                pose_x0=None) -> ModelOutput:
        B = img.shape[0]
        xyz = self.threeDimPoseEstimate(self.features(img)).reshape(B, -1, 3)
        uv = batch_project_xyz_to_uv(xyz, camera_intrinsic_matrix)
        return ModelOutput(xyz=xyz, uv=uv)


class Hand3DPoseNet(_ResNet50Model):
    """M9: canonical pose and viewpoint MLP heads on ResNet-50 features
    (reference Hand3DPoseNet.py); trainer-B, both ``is_inference``
    branches."""

    def __init__(self, cfg: Config, is_inference: bool = False):
        super().__init__(cfg)
        self.is_inference = is_inference
        d = cfg.resnet_out_feature_dim
        self.pose_predictor = Pose3dPrediction(d, cfg.keypoint_num)
        self.view_point_predictor = ViewPointPrediction(d)

    def forward(self, img: torch.Tensor, camera_intrinsic_matrix=None,
                index_root_bone_length=None, keypoint_xyz_root=None,
                pose_x0=None) -> ModelOutput:
        B = img.shape[0]
        feat = self.features(img)
        can = self.pose_predictor(feat).reshape(B, -1, 3)
        ux, uy, uz = self.view_point_predictor(feat)
        rot_mat = axis_angle_rot_mat(torch.cat([ux, uy, uz], dim=-1))
        rel_normed = can @ rot_mat
        if self.is_inference:
            xyz = rel_normed_to_absolute(rel_normed, index_root_bone_length,
                                         keypoint_xyz_root)
            uv = batch_project_xyz_to_uv(xyz, camera_intrinsic_matrix)
            return ModelOutput(xyz=xyz, uv=uv, diffusion_loss=torch.zeros(
                (), device=img.device))
        return ModelOutput(coord_xyz_rel_normed=rel_normed, can_xyz=can,
                           rot_mat=rot_mat)


class Hand3DPosePriorNetwork(nn.Module):
    """M10: PosePrior + ViewPoint ResNet-18 CNNs on the scoremap input
    (reference Hand3DPosePriorNetwork.py, config.py:42)."""

    def __init__(self, cfg: Config, is_inference: bool = False):
        super().__init__()
        self.cfg = cfg
        self.is_inference = is_inference
        _check_pool_grad(cfg)
        self.dtype = compute_dtype(cfg)
        self.PosePrior_net = PosePrior(cfg.input_channels, self.dtype,
                                       cfg.bn_mode, cfg.resnet_stem)
        self.ViewPoint_net = ViewPoint(cfg.input_channels, self.dtype,
                                       cfg.bn_mode, cfg.resnet_stem)

    def forward(self, img: torch.Tensor, camera_intrinsic_matrix=None,
                index_root_bone_length=None, keypoint_xyz_root=None,
                pose_x0=None) -> ModelOutput:
        B = img.shape[0]
        # both trunks read the same input, cast once
        x = _trunk_input(img, self.dtype)
        can = self.PosePrior_net(x).reshape(B, -1, 3)
        ux, uy, uz = self.ViewPoint_net(x)
        rot_mat = axis_angle_rot_mat(torch.cat([ux, uy, uz], dim=-1))
        rel_normed = can @ rot_mat
        if self.is_inference:
            xyz = rel_normed_to_absolute(rel_normed, index_root_bone_length,
                                         keypoint_xyz_root)
            uv = batch_project_xyz_to_uv(xyz, camera_intrinsic_matrix)
            return ModelOutput(xyz=xyz, uv=uv)
        return ModelOutput(coord_xyz_rel_normed=rel_normed, can_xyz=can,
                           rot_mat=rot_mat)


_ZOO = {
    "TwoDimHandPose": TwoDimHandPose,
    "OnlyThreeDimHandPose": OnlyThreeDimHandPose,
    "Hand3DPoseNet": Hand3DPoseNet,
    "Hand3DPosePriorNetwork": Hand3DPosePriorNetwork,
}
# the models whose constructor takes ``is_inference``
_HAS_INFER_FLAG = {"TwoDimHandPoseWithFK", "Hand3DPoseNet",
                   "Hand3DPosePriorNetwork"}

# where each model not yet ported stands in ROADMAP.md's queue 1
_WAITING = {
    "TwoDimHandPoseWithFK": "FK family",
    "ThreeDimHandPose": "FK family",
    "MANO3DHandPose": "MANO family",
    "ThreeHandShapeAndPoseMANO": "MANO family",
    "Resnet50MANO3DHandPose": "MANO family",
    "DiffusionHandPose": "diffusion",
}


def init_parameters(model: nn.Module, seed: int) -> nn.Module:
    """Seeded init of every layer, in registration order, from one CPU
    generator (the same weights on every device)."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if m is not model and hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    return model


def build_model(cfg: Config, is_inference: bool = False) -> nn.Module:
    """Model registry keyed by ``cfg.model_name``; returns the model in
    eval mode in host memory, initialised from ``cfg.seed``.  Callers
    move it with ``.to(resolve_device(device))``."""
    if cfg.model_name not in MODEL_NAMES:
        raise ValueError(f"model_name {cfg.model_name!r} is not supported")
    if cfg.model_name not in _ZOO:
        raise NotImplementedError(
            f"{cfg.model_name} is not ported yet; it waits in ROADMAP.md "
            f"queue 1 ({_WAITING[cfg.model_name]})")
    kw = ({"is_inference": is_inference}
          if cfg.model_name in _HAS_INFER_FLAG else {})
    model = _ZOO[cfg.model_name](cfg, **kw)
    init_parameters(model, cfg.seed)
    return model.eval()
