"""Visibility-masked losses (trainer-B terms).

Port of ``handpose_tpu/losses.py:17-32,75-78`` (reference
criterions/loss.py): ``sum(d * vis) / sum(vis)`` with the reference's
"0 if nothing visible" guard.
"""

from __future__ import annotations

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


def rot_mat_mse(pred_rot: torch.Tensor, gt_rot: torch.Tensor) -> torch.Tensor:
    """Viewpoint rotation-matrix MSE (reference trainval_hand3DPose.py:
    284-288)."""
    return ((pred_rot - gt_rot) ** 2).mean()
