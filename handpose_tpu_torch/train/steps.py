"""Fused eval step: raw batch -> preprocessing -> forward -> metrics.

Port of the eval side of ``handpose_tpu/train/steps.py``:
``compute_losses`` for trainer-B models (:67-88), ``_eval_metrics``
(:202-223), ``_accum_eval`` with its gcd rule (:226-259) and
``make_fused_eval_step`` (:369-383).  PyTorch runs eagerly, so the "fused"
step is one Python function on device tensors rather than one compiled
program.  The train steps wait for the training slice.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch

from ..config import Config
from ..data.preprocess import RawBatch, model_input
from ..losses import masked_l2_loss, rot_mat_mse
from ..metrics import masked_sum_count, mpjpe

_TRAINER_B = ("Hand3DPoseNet", "Hand3DPosePriorNetwork")


def _check_trainer_b(cfg: Config):
    if cfg.model_name not in _TRAINER_B:
        raise NotImplementedError(
            f"losses and metrics of {cfg.model_name} wait for a later slice "
            "(ROADMAP.md, queue 1); this slice ports the trainer-B models")


def forward(model, batch: dict, cfg: Config):
    """The model on a preprocessed sample dict (eval mode)."""
    inp = model_input(batch, cfg.input_channels)
    pose_x0 = batch["keypoint_xyz21_rel_normed"].reshape(inp.shape[0], 1, -1)
    return model(inp, batch["camera_intrinsic_matrix"],
                 batch["keypoint_scale"], batch["keypoint_xyz_root"], pose_x0)


def compute_losses(out, batch: dict, cfg: Config) -> Dict[str, torch.Tensor]:
    """Trainer-B loss terms + total: canonical-coords L2 and rotation MSE
    (reference trainval_hand3DPose.py:284-288)."""
    _check_trainer_b(cfg)
    loss_xyz = masked_l2_loss(out.can_xyz, batch["kp_coord_xyz21_rel_can"],
                              batch["keypoint_vis21"])
    loss_rot = rot_mat_mse(out.rot_mat, batch["rot_mat"])
    return {"loss_xyz": loss_xyz, "loss_rot": loss_rot,
            "loss": loss_xyz + loss_rot}


def _eval_metrics(out, batch: dict, cfg: Config) -> Dict[str, torch.Tensor]:
    losses = compute_losses(out, batch, cfg)
    gt = batch["kp_coord_xyz21_rel_can"]
    vis = batch["keypoint_vis21"]
    s, n = masked_sum_count(out.can_xyz, gt, vis)
    return {**losses, "mpjpe": mpjpe(out.can_xyz, gt, vis),
            "mpjpe_sum": s, "mpjpe_count": n}


def _accum_eval(metrics_one: Callable[[RawBatch], dict], raw: RawBatch,
                k: int) -> Dict[str, torch.Tensor]:
    """Metrics over ``raw`` in gcd(k, B) equal microbatches (``k`` =
    ``cfg.grad_accum``): ``_sum``/``_count`` keys add, per-batch means
    average."""
    B = raw.image.shape[0]
    k = math.gcd(k, B)
    if k == 1:
        return metrics_one(raw)
    parts = [metrics_one(RawBatch(*(a[i * (B // k):(i + 1) * (B // k)]
                                    for a in raw)))
             for i in range(k)]
    return {key: (torch.stack([p[key] for p in parts]).sum(0)
                  if key.endswith(("_sum", "_count"))
                  else torch.stack([p[key] for p in parts]).mean(0))
            for key in parts[0]}


def make_fused_eval_step(model, cfg: Config, preprocess_fn,
                         pp_kwargs: dict) -> Callable[[RawBatch], dict]:
    """``eval_step(raw)`` -> metrics dict of 0-d tensors on the batch's
    device: loss_xyz, loss_rot, loss, mpjpe, mpjpe_sum, mpjpe_count."""
    _check_trainer_b(cfg)

    def metrics_one(raw_i: RawBatch) -> dict:
        batch = preprocess_fn(raw_i, **pp_kwargs)
        return _eval_metrics(forward(model, batch, cfg), batch, cfg)

    @torch.inference_mode()
    def eval_step(raw: RawBatch) -> dict:
        return _accum_eval(metrics_one, raw, cfg.grad_accum)

    return eval_step
