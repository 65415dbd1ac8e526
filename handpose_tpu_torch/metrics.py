"""Evaluation metrics.

Port of ``handpose_tpu/metrics.py:12-33`` (reference
criterions/metrics.py): visibility-masked MPJPE in millimetres.
"""

from __future__ import annotations

import torch


def _joint_dist(pred_xyz, gt_xyz, keypoint_vis):
    dist = torch.sqrt(((pred_xyz - gt_xyz) ** 2).sum(dim=2))
    return dist, keypoint_vis.reshape(dist.shape).to(dist.dtype)


def mpjpe(pred_xyz: torch.Tensor, gt_xyz: torch.Tensor,
          keypoint_vis: torch.Tensor) -> torch.Tensor:
    """Visibility-masked mean per-joint position error x1000 (m -> mm),
    0 when nothing is visible."""
    dist, v = _joint_dist(pred_xyz, gt_xyz, keypoint_vis)
    n = v.sum()
    mean = torch.where(n > 0, (dist * v).sum() / n.clamp(min=1.0),
                       torch.zeros_like(n))
    return mean * 1000.0


def masked_sum_count(pred_xyz: torch.Tensor, gt_xyz: torch.Tensor,
                     keypoint_vis: torch.Tensor):
    """(sum of masked distances x1000, visible count), for exact
    whole-split aggregation across batches."""
    dist, v = _joint_dist(pred_xyz, gt_xyz, keypoint_vis)
    return (dist * v).sum() * 1000.0, v.sum()
