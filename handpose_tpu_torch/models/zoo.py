"""The model zoo on the JAX package's forward contract.

Port of ``handpose_tpu/models/zoo.py``; this slice carries
``Hand3DPosePriorNetwork`` (M10, the reference's default model).  Every
model is called as

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
from ..nn.heads import PosePrior, ViewPoint
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
    # trainer-B training outputs (reference Hand3DPoseNet.py:49-52)
    coord_xyz_rel_normed: Optional[torch.Tensor] = None
    can_xyz: Optional[torch.Tensor] = None     # canonical coords (B, 21, 3)
    rot_mat: Optional[torch.Tensor] = None     # viewpoint rotation (B, 3, 3)


class Hand3DPosePriorNetwork(nn.Module):
    """M10: PosePrior + ViewPoint ResNet-18 CNNs on the scoremap input
    (reference Hand3DPosePriorNetwork.py, config.py:42)."""

    def __init__(self, cfg: Config, is_inference: bool = False):
        super().__init__()
        self.cfg = cfg
        self.is_inference = is_inference
        if cfg.resnet_stem != "k3s2":
            raise NotImplementedError(
                f"resnet_stem {cfg.resnet_stem!r} waits for a later slice "
                "(ROADMAP.md, queue 1); this slice ports 'k3s2'")
        if cfg.pool_grad not in POOL_GRADS:
            raise ValueError(f"pool_grad {cfg.pool_grad!r} not in "
                             f"{POOL_GRADS}")
        self.dtype = compute_dtype(cfg)
        self.PosePrior_net = PosePrior(cfg.input_channels, self.dtype,
                                       cfg.bn_mode)
        self.ViewPoint_net = ViewPoint(cfg.input_channels, self.dtype,
                                       cfg.bn_mode)

    def forward(self, img: torch.Tensor, camera_intrinsic_matrix=None,
                index_root_bone_length=None, keypoint_xyz_root=None,
                pose_x0=None) -> ModelOutput:
        B = img.shape[0]
        # NHWC -> NCHW view, cast once to the compute dtype in
        # channels_last memory (both trunks read the same input; flax casts
        # it in each first conv)
        x = img.permute(0, 3, 1, 2).to(dtype=self.dtype,
                                       memory_format=torch.channels_last)
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


_ZOO = {"Hand3DPosePriorNetwork": Hand3DPosePriorNetwork}

# where each model not yet ported stands in ROADMAP.md's queue 1
_WAITING = {
    "TwoDimHandPose": "ResNet-50 families",
    "OnlyThreeDimHandPose": "ResNet-50 families",
    "Hand3DPoseNet": "ResNet-50 families",
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
    model = _ZOO[cfg.model_name](cfg, is_inference=is_inference)
    init_parameters(model, cfg.seed)
    return model.eval()
