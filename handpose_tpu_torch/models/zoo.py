"""The model zoo on the JAX package's forward contract.

Port of ``handpose_tpu/models/zoo.py``, all ten models:
``Hand3DPosePriorNetwork`` (M10, the reference's default model), the
ResNet-50 family ``TwoDimHandPose`` (M1), ``OnlyThreeDimHandPose`` (M4)
and ``Hand3DPoseNet`` (M9), the FK family ``TwoDimHandPoseWithFK`` (M2)
and ``ThreeDimHandPose`` (M3), the diffusion model ``DiffusionHandPose``
(M5), and the MANO family ``MANO3DHandPose`` (M6),
``ThreeHandShapeAndPoseMANO`` (M7) and ``Resnet50MANO3DHandPose`` (M8)
on the MANO layer :func:`build_model` loads.  Every model is called as

    model(img (B, H, W, C) NHWC, camera_intrinsic_matrix,
          index_root_bone_length, keypoint_xyz_root, pose_x0=None)
      -> ModelOutput

A model whose forward draws random numbers (``stochastic = True``:
``DiffusionHandPose``) also takes ``generator=`` and the draws the JAX
package injects (``init_noise``, ``diff_t``, ``diff_noise``).

``model.train()`` selects train-mode BatchNorm (batch statistics,
running statistics updated), ``model.eval()`` the running statistics:
the JAX models' ``train`` argument.  The stem pool's gradient is one
function whatever ``cfg.pool_grad`` names (``ops/pooling.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..config import Config
from ..nn.fk import forward_kinematics
from ..nn.heads import (BoneAnglePrediction, BoneLengthPrediction,
                        MANOBetasPrediction, MANOThetaPrediction, PosePrior,
                        Pose3dPrediction, ViewPoint, ViewPointPrediction)
from ..nn.diffusion import DiffusionJointEstimation
from ..nn.layers import Dense
from ..nn.mano import ManoLayer, ManoModel, load_mano, mano_source
from ..nn.mlp import DecayMLP
from ..nn.resnet import ExtendedResNet50, ResNetFeatureExtractor, ResNetMano
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
    uv_aux: Optional[torch.Tensor] = None      # direct-2D branch (M2 infer)
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
    """The ``resnet_extractor`` the ResNet-50 models open with:
    ``ResNetFeatureExtractor(feat_dim)``, ``cfg.resnet_out_feature_dim``
    unless given."""

    def __init__(self, cfg: Config, feat_dim: Optional[int] = None):
        super().__init__()
        _check_pool_grad(cfg)
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        self.resnet_extractor = ResNetFeatureExtractor(
            cfg.input_channels, feat_dim or cfg.resnet_out_feature_dim,
            self.dtype, cfg.resnet_stem, cfg.bn_mode)

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


class TwoDimHandPoseWithFK(_ResNet50Model):
    """M2: the M1 uv head -> bone angle and length heads on the flattened
    pixel uv -> FK -> xyz and projected uv (reference
    TwoDimHandPoseWithFK.py).  The inference branch returns the projected
    uv as ``uv`` and the direct one as ``uv_aux``; training picks ``uv``
    by ``cfg.uv_from_xd``: 2 direct, 2.5 the mean, 3 projected."""

    geometry_inputs = ("boneAngle", "bonelength")

    def __init__(self, cfg: Config, is_inference: bool = False):
        super().__init__(cfg)
        self.is_inference = is_inference
        kp = cfg.keypoint_num
        self.twoDimPoseEstimate = _TwoDimMLP(cfg.resnet_out_feature_dim, kp)
        self.boneAngle = BoneAnglePrediction(input_dim=kp * 2)
        self.bonelength = BoneLengthPrediction(input_dim=kp * 2)

    def forward(self, img: torch.Tensor, camera_intrinsic_matrix=None,
                index_root_bone_length=None, keypoint_xyz_root=None,
                pose_x0=None) -> ModelOutput:
        B, h, w = img.shape[0], img.shape[1], img.shape[2]
        pose = self.twoDimPoseEstimate(self.features(img)).reshape(B, -1, 2)
        uv_direct = torch.stack([pose[..., 0] * w, pose[..., 1] * h], dim=-1)
        flat = uv_direct.reshape(B, -1)
        root_angles, other_angles = self.boneAngle(flat)
        xyz, uv_proj = forward_kinematics(
            root_angles, other_angles, self.bonelength(flat),
            camera_intrinsic_matrix, index_root_bone_length,
            keypoint_xyz_root, self.cfg.joint_order_switched)
        zero = torch.zeros((), device=img.device)
        if self.is_inference:
            return ModelOutput(xyz=xyz, uv=uv_proj, uv_aux=uv_direct,
                               diffusion_loss=zero)
        if self.cfg.uv_from_xd == 2.5:
            uv = (uv_direct + uv_proj) / 2
        elif self.cfg.uv_from_xd == 3:
            uv = uv_proj
        else:
            uv = uv_direct
        return ModelOutput(xyz=xyz, uv=uv, diffusion_loss=zero)


class ThreeDimHandPose(_ResNet50Model):
    """M3: direct 63-d pose -> bone angle and length heads -> FK
    (reference ThreeDimHandPose.py)."""

    geometry_inputs = ("bone_angle_pred_model", "bone_length_pred_model")

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self.threeDimPoseEstimate = DecayMLP(
            cfg.resnet_out_feature_dim, cfg.keypoint_num * 3, divide=2,
            activation="LeakyReLU", use_sigmoid=False)
        self.bone_angle_pred_model = BoneAnglePrediction()
        self.bone_length_pred_model = BoneLengthPrediction()

    def forward(self, img: torch.Tensor, camera_intrinsic_matrix=None,
                index_root_bone_length=None, keypoint_xyz_root=None,
                pose_x0=None) -> ModelOutput:
        pose63 = self.threeDimPoseEstimate(self.features(img))
        root_angles, other_angles = self.bone_angle_pred_model(pose63)
        xyz, uv = forward_kinematics(
            root_angles, other_angles, self.bone_length_pred_model(pose63),
            camera_intrinsic_matrix, index_root_bone_length,
            keypoint_xyz_root, self.cfg.joint_order_switched)
        return ModelOutput(xyz=xyz, uv=uv,
                           diffusion_loss=torch.zeros((), device=img.device))


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


class DiffusionHandPose(_ResNet50Model):
    """M5: ResNet-50 condition features (``condition_feat_dim``) -> a
    conditional DDIM sample of the 63-d pose -> bone angle and length
    heads -> FK (reference DiffusionHandPose.py,
    ``handpose_tpu/models/zoo.py:211-283``).

    With ``pose_x0`` the denoiser's training loss is ``diffusion_loss``.
    The sample runs on every forward, training included
    (``cfg.diffusion_sample_in_train``, the reference's default); with
    that off, training returns only ``diffusion_loss``.  The sample has no
    gradient (every reference sampler is ``@torch.no_grad``; JAX's
    ``stop_gradient``), so the UNet trains only through
    ``diffusion_loss``.  Draws come from ``generator`` (the loss's t, then
    its noise, then x_T, then the sampler's step noise when it draws any)
    unless ``diff_t``, ``diff_noise``, ``init_noise`` or ``step_noise``
    inject them."""

    geometry_inputs = ("bone_angle_pred_model", "bone_length_pred_model")
    stochastic = True

    def __init__(self, cfg: Config):
        super().__init__(cfg, cfg.condition_feat_dim)
        self.diff_model = DiffusionJointEstimation(
            keypoint_num=cfg.keypoint_num,
            condition_feat_dim=cfg.condition_feat_dim,
            num_timesteps=cfg.num_timesteps,
            num_sampling_timesteps=cfg.num_sampling_timesteps,
            sampler_hoist={"auto": "auto", "on": True,
                           "off": False}[cfg.sampler_hoist])
        self.bone_angle_pred_model = BoneAnglePrediction()
        self.bone_length_pred_model = BoneLengthPrediction()

    def forward(self, img: torch.Tensor, camera_intrinsic_matrix=None,
                index_root_bone_length=None, keypoint_xyz_root=None,
                pose_x0=None, generator: Optional[torch.Generator] = None,
                init_noise=None, diff_t=None, diff_noise=None,
                step_noise=None) -> ModelOutput:
        feat = self.features(img)
        diffusion_loss = None
        if pose_x0 is not None:
            diffusion_loss = self.diff_model(pose_x0, feat, generator,
                                             t=diff_t, noise=diff_noise)
        if self.training and not self.cfg.diffusion_sample_in_train:
            return ModelOutput(diffusion_loss=diffusion_loss)
        with torch.no_grad():
            coarse = self.diff_model.sample(feat, generator,
                                            init_noise=init_noise,
                                            step_noise=step_noise)
        coarse = coarse.reshape(coarse.shape[0], -1)           # (B, 63)
        root_angles, other_angles = self.bone_angle_pred_model(coarse)
        xyz, uv = forward_kinematics(
            root_angles, other_angles, self.bone_length_pred_model(coarse),
            camera_intrinsic_matrix, index_root_bone_length,
            keypoint_xyz_root, self.cfg.joint_order_switched)
        return ModelOutput(xyz=xyz, uv=uv, diffusion_loss=diffusion_loss)


def _mano_fc_dim(cfg: Config) -> int:
    """rot (3), theta (pose_num), beta (10) and, with
    ``network_regress_uv``, the uv scale and translation (3)."""
    return 10 + cfg.mano_pose_num + 3 + (3 if cfg.network_regress_uv else 0)


class MANO3DHandPose(_ResNet50Model):
    """M6: theta and beta heads on ResNet-50 features -> MANO -> projected
    uv (reference MANO3DHandPose.py)."""

    geometry_inputs = ("theta_predictor", "betas_predictor")

    def __init__(self, cfg: Config, mano: ManoModel):
        super().__init__(cfg)
        d = cfg.resnet_out_feature_dim
        self.theta_predictor = MANOThetaPrediction(d, cfg.mano_pose_num)
        self.betas_predictor = MANOBetasPrediction(d, cfg.mano_beta_num)
        self.mano_layer = ManoLayer(mano, pose_num=cfg.mano_pose_num)

    def forward(self, img: torch.Tensor, camera_intrinsic_matrix=None,
                index_root_bone_length=None, keypoint_xyz_root=None,
                pose_x0=None) -> ModelOutput:
        feat = self.features(img)
        root_angles, other_angles = self.theta_predictor(feat)
        _, joints = self.mano_layer(root_angles, other_angles,
                                    self.betas_predictor(feat))
        uv = batch_project_xyz_to_uv(joints, camera_intrinsic_matrix)
        return ModelOutput(xyz=joints, uv=uv,
                           diffusion_loss=torch.zeros((), device=img.device))


class ThreeHandShapeAndPoseMANO(nn.Module):
    """M7: the boukhayma-style ``ResNetMano`` trunk -> (rot, theta, beta)
    -> MANO (reference ThreeHandShapeAndPoseMANO.py, resnetMANO.py:
    138-235).  With ``network_regress_uv`` the trunk also regresses a uv
    scale and translation about the means [545, 128, 128]; without it
    the model has no uv."""

    geometry_inputs = ("resnet_Mano",)

    def __init__(self, cfg: Config, mano: ManoModel):
        super().__init__()
        _check_pool_grad(cfg)
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        self.resnet_Mano = ResNetMano(_mano_fc_dim(cfg), cfg.input_channels,
                                      self.dtype, cfg.bn_mode)
        self.mano_layer = ManoLayer(mano, pose_num=cfg.mano_pose_num)

    def forward(self, img: torch.Tensor, camera_intrinsic_matrix=None,
                index_root_bone_length=None, keypoint_xyz_root=None,
                pose_x0=None) -> ModelOutput:
        n = self.cfg.mano_pose_num
        xs = self.resnet_Mano(_trunk_input(img, self.dtype))
        _, joints = self.mano_layer(xs[:, 0:3], xs[:, 3:n + 3],
                                    xs[:, n + 3:n + 13])
        uv = None
        if self.cfg.network_regress_uv:
            scale = xs[:, -3] + 545.0
            trans = xs[:, -2:] + 128.0
            uv = trans[:, None, :] + scale[:, None, None] * joints[:, :, :2]
        return ModelOutput(xyz=joints, uv=uv,
                           diffusion_loss=torch.zeros((), device=img.device))


class Resnet50MANO3DHandPose(nn.Module):
    """M8: ResNet-50 -> sigmoid decay MLP -> scaled (rot, theta, beta) ->
    MANO (reference Resnet50MANO3DHandPose.py, resnet50MANO.py:26-63);
    theta and beta are returned for the regularisation term."""

    geometry_inputs = ("mlp",)

    def __init__(self, cfg: Config, mano: ManoModel):
        super().__init__()
        _check_pool_grad(cfg)
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        self.extended_resnet50_extractor = ExtendedResNet50(
            cfg.input_channels, self.dtype, cfg.resnet_stem, cfg.bn_mode)
        self.mlp = DecayMLP(1000, _mano_fc_dim(cfg), divide=2,
                            activation="ReLU", use_sigmoid=True)
        self.mano_layer = ManoLayer(mano, pose_num=cfg.mano_pose_num)

    def forward(self, img: torch.Tensor, camera_intrinsic_matrix=None,
                index_root_bone_length=None, keypoint_xyz_root=None,
                pose_x0=None) -> ModelOutput:
        n = self.cfg.mano_pose_num
        xs = self.mlp(self.extended_resnet50_extractor(
            _trunk_input(img, self.dtype)))
        rot = (xs[:, 0:3] - 0.5) * 2 * math.pi
        theta = (xs[:, 3:n + 3] - 0.5) * 4
        beta = (xs[:, n + 3:n + 13] - 0.5) * 0.1
        _, joints = self.mano_layer(rot, theta, beta)
        uv = batch_project_xyz_to_uv(joints, camera_intrinsic_matrix)
        return ModelOutput(xyz=joints, uv=uv, theta=theta, beta=beta,
                           diffusion_loss=torch.zeros((), device=img.device))


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
    "TwoDimHandPoseWithFK": TwoDimHandPoseWithFK,
    "ThreeDimHandPose": ThreeDimHandPose,
    "OnlyThreeDimHandPose": OnlyThreeDimHandPose,
    "DiffusionHandPose": DiffusionHandPose,
    "MANO3DHandPose": MANO3DHandPose,
    "ThreeHandShapeAndPoseMANO": ThreeHandShapeAndPoseMANO,
    "Resnet50MANO3DHandPose": Resnet50MANO3DHandPose,
    "Hand3DPoseNet": Hand3DPoseNet,
    "Hand3DPosePriorNetwork": Hand3DPosePriorNetwork,
}
# the models that take the MANO layer's constants
_NEEDS_MANO = {"MANO3DHandPose", "ThreeHandShapeAndPoseMANO",
               "Resnet50MANO3DHandPose"}
# the models whose constructor takes ``is_inference``
_HAS_INFER_FLAG = {"TwoDimHandPoseWithFK", "Hand3DPoseNet",
                   "Hand3DPosePriorNetwork"}


def hook_geometry_inputs(model: nn.Module, given=None) -> dict:
    """Forward hooks on the submodules an FK or MANO model's
    ``geometry_inputs`` names, whose outputs enter its geometry: returns
    {name: the module's own output}, filled on each call.  With ``given``
    (such a dict, of tensors or arrays, e.g. from another device or
    package) each module's output takes ``given``'s value exactly, with
    its own gradient: a check can hold the inputs of the geometry, where
    rounding is amplified, apart from the geometry itself."""
    seen = {}

    def substitute(out, value):
        value = torch.as_tensor(value, device=out.device, dtype=out.dtype)
        return value + (out - out.detach())

    def hook(name):
        def fn(module, args, out):
            seen[name] = out
            if given is None:
                return None
            if isinstance(out, tuple):
                return tuple(map(substitute, out, given[name]))
            return substitute(out, given[name])
        return fn

    for name in model.geometry_inputs:
        getattr(model, name).register_forward_hook(hook(name))
    return seen


def mano_source_of(cfg: Config) -> Optional[str]:
    """The MANO :func:`build_model` of ``cfg`` loads (a pickle's absolute
    path or the synthetic stand-in), or None for a model without one."""
    if cfg.model_name not in _NEEDS_MANO:
        return None
    return mano_source(cfg.mano_right_hand_path or None)


def init_parameters(model: nn.Module, seed: int) -> nn.Module:
    """Seeded init of every layer, in registration order, from one CPU
    generator (the same weights on every device)."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if m is not model and hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    return model


def build_model(cfg: Config, is_inference: bool = False,
                mano: Optional[ManoModel] = None) -> nn.Module:
    """Model registry keyed by ``cfg.model_name``; returns the model in
    eval mode in host memory, initialised from ``cfg.seed``.  Callers
    move it with ``.to(resolve_device(device))``.  A MANO model takes
    ``mano``, else :func:`load_mano` of ``cfg.mano_right_hand_path``
    (the synthetic stand-in when no asset is found)."""
    if cfg.model_name not in _ZOO:
        raise ValueError(f"model_name {cfg.model_name!r} is not supported")
    kw = {}
    if cfg.model_name in _NEEDS_MANO:
        kw["mano"] = mano if mano is not None else load_mano(
            cfg.mano_right_hand_path or None)
    if cfg.model_name in _HAS_INFER_FLAG:
        kw["is_inference"] = is_inference
    model = _ZOO[cfg.model_name](cfg, **kw)
    init_parameters(model, cfg.seed)
    return model.eval()
