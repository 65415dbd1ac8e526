"""Evaluation metrics.

Port of ``handpose_tpu/metrics.py:12-74`` (reference
criterions/metrics.py): visibility-masked MPJPE in millimetres, and the
standard RHD protocol's PCK curve and its 20-50 mm AUC, which the
reference does not report.
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


def _correct(pred_xyz, gt_xyz, keypoint_vis, thresholds):
    dist, v = _joint_dist(pred_xyz, gt_xyz, keypoint_vis)
    ts = torch.as_tensor(thresholds, dtype=dist.dtype, device=dist.device)
    correct = (dist[None] < ts[:, None, None]).to(dist.dtype)
    return (correct * v[None]).sum(dim=(1, 2)), v.sum()


def pck(pred_xyz: torch.Tensor, gt_xyz: torch.Tensor,
        keypoint_vis: torch.Tensor, thresholds) -> torch.Tensor:
    """(T,) share of visible joints whose error is below each threshold
    (metres)."""
    correct, n = _correct(pred_xyz, gt_xyz, keypoint_vis, thresholds)
    return correct / n.clamp(min=1.0)


def pck_sum_count(pred_xyz: torch.Tensor, gt_xyz: torch.Tensor,
                  keypoint_vis: torch.Tensor, thresholds):
    """((T,) correct-joint counts, visible-joint count): :func:`pck` in
    the form that adds up exactly over batches."""
    return _correct(pred_xyz, gt_xyz, keypoint_vis, thresholds)


def auc_pck(pred_xyz: torch.Tensor, gt_xyz: torch.Tensor,
            keypoint_vis: torch.Tensor, lo: float = 0.02, hi: float = 0.05,
            steps: int = 31) -> torch.Tensor:
    """Area under the PCK curve between ``lo`` and ``hi`` metres (the
    20-50 mm RHD protocol), trapezoidal, over ``hi - lo``."""
    ts = torch.linspace(lo, hi, steps, dtype=pred_xyz.dtype,
                        device=pred_xyz.device)
    return torch.trapezoid(pck(pred_xyz, gt_xyz, keypoint_vis, ts),
                           ts) / (hi - lo)
