"""Visibility-masked losses and the multi-term criterion.

Port of ``handpose_tpu/losses.py`` (reference criterions/loss.py): the
masked means are ``sum(d * vis) / sum(vis)`` with the reference's "0 if
nothing visible" guard; ``LossCalculation`` builds the terms its gates
ask for (trainer A), ``rot_mat_mse`` is the trainer-B rotation term.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


def _masked_mean(values: torch.Tensor, vis: torch.Tensor) -> torch.Tensor:
    """Mean of ``values`` over True entries of ``vis``; 0 when none."""
    v = vis.reshape(values.shape).to(values.dtype)
    n = v.sum()
    total = (values * v).sum()
    return torch.where(n > 0, total / n.clamp(min=1.0), torch.zeros_like(total))


def masked_l2_loss(pred: torch.Tensor, gt: torch.Tensor,
                   keypoint_vis: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the coord axis, masked mean over (B, 21)
    (reference loss.py:6-23)."""
    return _masked_mean(((pred - gt) ** 2).sum(dim=2), keypoint_vis)


def masked_l1_loss(pred: torch.Tensor, gt: torch.Tensor,
                   keypoint_vis: torch.Tensor) -> torch.Tensor:
    """Sum of absolute differences over the coord axis, masked mean
    (reference loss.py:26-46)."""
    return _masked_mean((pred - gt).abs().sum(dim=2), keypoint_vis)


def contrastive_loss(feat1: torch.Tensor, feat2: torch.Tensor,
                     label: torch.Tensor, margin: float = 1.0
                     ) -> torch.Tensor:
    """Reference loss.py:50-59, with ``pairwise_distance``'s eps."""
    d = ((feat1 - feat2 + 1e-6) ** 2).sum(dim=-1).sqrt()
    return ((1 - label) * d ** 2
            + label * torch.clamp(margin - d, min=0.0) ** 2).mean()


def hand_mask_loss(pred_uv: torch.Tensor, gt_uv: torch.Tensor,
                   hand_mask: torch.Tensor) -> torch.Tensor:
    """1 - sum(mask at pred uv) / sum(mask at gt uv), the uv truncated to
    integers and clamped to the mask (reference loss.py:92-111).  u is
    clamped by W and v by H, as the JAX package does (the reference
    clamps both by the last axis)."""
    H, W = hand_mask.shape[-2], hand_mask.shape[-1]
    lim = torch.tensor([W - 1, H - 1], dtype=torch.float32,
                       device=hand_mask.device)

    def pixel(uv):
        # JAX's saturating int32 cast (NaN -> 0), then the clamp: a
        # clamp in float32 before truncating gives that on every device,
        # where torch's own cast of NaN, inf or |uv| >= 2^31 is undefined
        # (INT_MIN on the host)
        uv = torch.nan_to_num(uv.to(torch.float32), nan=0.0)
        return torch.minimum(uv.clamp(min=0.0), lim).long()

    gt, pr = pixel(gt_uv), pixel(pred_uv)
    b = torch.arange(hand_mask.shape[0], device=hand_mask.device)[:, None]
    gt_samples = hand_mask[b, gt[..., 1], gt[..., 0]]
    pr_samples = hand_mask[b, pr[..., 1], pr[..., 0]]
    return 1.0 - pr_samples.sum() / (gt_samples.sum() + 1e-8)


def regularization_loss(theta: torch.Tensor, beta: torch.Tensor,
                        alpha_beta: float = 10.0) -> torch.Tensor:
    """(|theta|_F + 10 |beta|_F) / 100 (reference loss.py:113-117)."""
    return (torch.linalg.norm(theta)
            + alpha_beta * torch.linalg.norm(beta)) / 100.0


def rot_mat_mse(pred_rot: torch.Tensor, gt_rot: torch.Tensor) -> torch.Tensor:
    """Viewpoint rotation-matrix MSE (reference trainval_hand3DPose.py:
    284-288)."""
    return ((pred_rot - gt_rot) ** 2).mean()


class LossTerms(NamedTuple):
    xyz: Optional[torch.Tensor]
    uv: Optional[torch.Tensor]
    contrastive: Optional[torch.Tensor]
    hand_mask: Optional[torch.Tensor]
    regularization: Optional[torch.Tensor]


class LossCalculation:
    """Configurable multi-term criterion (reference loss.py:62-153): each
    term is computed when its gate is on, else None."""

    def __init__(self, loss_type: str = "L2", comp_xyz_loss=False,
                 comp_uv_loss=False, comp_contrastive_loss=False,
                 comp_hand_mask_loss=False, comp_regularization_loss=False):
        self.coord_loss = masked_l2_loss if loss_type == "L2" \
            else masked_l1_loss
        self.comp_xyz_loss = comp_xyz_loss
        self.comp_uv_loss = comp_uv_loss
        self.comp_contrastive_loss = comp_contrastive_loss
        self.comp_hand_mask_loss = comp_hand_mask_loss
        self.comp_regularization_loss = comp_regularization_loss

    def __call__(self, pre_xyz, gt_xyz, pre_uv, gt_uv, keypoint_vis,
                 hand_mask=None, theta=None, beta=None, feat1=None,
                 feat2=None, label=None) -> LossTerms:
        return LossTerms(
            self.coord_loss(pre_xyz, gt_xyz, keypoint_vis)
            if self.comp_xyz_loss else None,
            self.coord_loss(pre_uv, gt_uv, keypoint_vis)
            if self.comp_uv_loss else None,
            contrastive_loss(feat1, feat2, label)
            if self.comp_contrastive_loss else None,
            hand_mask_loss(pre_uv, gt_uv, hand_mask)
            if self.comp_hand_mask_loss else None,
            regularization_loss(theta, beta)
            if self.comp_regularization_loss else None)
