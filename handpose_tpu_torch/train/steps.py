"""Train and eval steps: raw batch -> preprocessing -> forward -> loss.

Port of ``handpose_tpu/train/steps.py``: ``_forward`` (:44-64),
``compute_losses`` for trainer-B models (:67-88), ``_accum_grads``
(:132-174), ``make_train_step`` (:177-199), ``_eval_metrics``
(:202-223), ``_accum_eval`` with its gcd rule (:226-259), and the fused
steps (:277-303, :345-383).  PyTorch runs eagerly, so a "fused" step is
one Python function on device tensors rather than one compiled program.
A train step returns ``(state, losses)`` like the JAX step; it updates
the model's parameters, Adam's moments and the BatchNorm statistics in
place, where JAX returns a new state.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch

from ..config import Config
from ..data.preprocess import RawBatch, model_input
from ..losses import masked_l2_loss, rot_mat_mse
from ..metrics import masked_sum_count, mpjpe
from .state import TrainState

_TRAINER_B = ("Hand3DPoseNet", "Hand3DPosePriorNetwork")


def _check_trainer_b(cfg: Config):
    if cfg.model_name not in _TRAINER_B:
        raise NotImplementedError(
            f"losses and metrics of {cfg.model_name} wait for a later slice "
            "(ROADMAP.md, queue 1); this slice ports the trainer-B models")


def _check_remat(cfg: Config):
    if cfg.remat:
        raise NotImplementedError(
            "remat (activation recomputation) waits for ROADMAP.md queue 9 "
            "(torch.utils.checkpoint)")


def _forward(model, batch: dict, cfg: Config, train: bool):
    """The model on a preprocessed sample dict, in train mode (batch
    statistics, running statistics updated) or eval mode."""
    model.train(train)
    inp = model_input(batch, cfg.input_channels)
    pose_x0 = batch["keypoint_xyz21_rel_normed"].reshape(inp.shape[0], 1, -1)
    return model(inp, batch["camera_intrinsic_matrix"],
                 batch["keypoint_scale"], batch["keypoint_xyz_root"], pose_x0)


def forward(model, batch: dict, cfg: Config):
    """The model on a preprocessed sample dict, eval mode."""
    return _forward(model, batch, cfg, train=False)


def compute_losses(out, batch: dict, cfg: Config) -> Dict[str, torch.Tensor]:
    """Trainer-B loss terms + total: canonical-coords L2 and rotation MSE
    (reference trainval_hand3DPose.py:284-288)."""
    _check_trainer_b(cfg)
    loss_xyz = masked_l2_loss(out.can_xyz, batch["kp_coord_xyz21_rel_can"],
                              batch["keypoint_vis21"])
    loss_rot = rot_mat_mse(out.rot_mat, batch["rot_mat"])
    return {"loss_xyz": loss_xyz, "loss_rot": loss_rot,
            "loss": loss_xyz + loss_rot}


def _split(data, k: int):
    """``data`` (a RawBatch or a sample dict) cut into ``k`` equal
    microbatches along the batch axis."""
    if isinstance(data, dict):
        B = next(iter(data.values())).shape[0]
    else:
        B = data[0].shape[0]
    if B % k:
        raise ValueError(f"grad_accum={k} does not divide batch dim {B}")
    m = B // k
    if isinstance(data, dict):
        return [{key: v[i * m:(i + 1) * m] for key, v in data.items()}
                for i in range(k)]
    return [type(data)(*(a[i * m:(i + 1) * m] for a in data))
            for i in range(k)]


def _accum_grads(grad_one: Callable, state: TrainState, data,
                 k: int) -> Dict[str, torch.Tensor]:
    """Gradients over ``data`` into the parameters' ``.grad``, optionally
    over ``k`` sequential microbatches (``cfg.grad_accum``); returns the
    loss dict.

    ``grad_one(data_i)`` runs one microbatch's forward and backward
    (adding its mean-loss gradient to ``.grad``) and returns its losses.
    For ``k > 1`` the summed gradient is divided by ``k`` (the mean over
    microbatches), BatchNorm normalises per microbatch and its running
    statistics take momentum once per microbatch, and the loss dicts are
    averaged: the JAX function's semantics."""
    state.optimizer.zero_grad(set_to_none=True)
    if k == 1:
        return grad_one(data)
    parts = [grad_one(d) for d in _split(data, k)]
    with torch.no_grad():
        for p in state.model.parameters():
            if p.grad is not None:
                p.grad.div_(k)
    return {key: torch.stack([p[key] for p in parts]).mean(0)
            for key in parts[0]}


def _grad_one_on(model, cfg: Config) -> Callable[[dict], dict]:
    """The gradient closure on a preprocessed sample dict."""
    def grad_one(batch: dict) -> dict:
        losses = compute_losses(_forward(model, batch, cfg, True), batch, cfg)
        losses["loss"].backward()
        return {k: v.detach() for k, v in losses.items()}

    return grad_one


def make_train_step(model, cfg: Config):
    """``train_step(state, batch)`` on a preprocessed sample dict ->
    ``(state, losses)``."""
    _check_trainer_b(cfg)
    _check_remat(cfg)
    grad_one = _grad_one_on(model, cfg)

    def train_step(state: TrainState, batch: dict):
        losses = _accum_grads(grad_one, state, batch, cfg.grad_accum)
        return state.apply_gradients(), losses

    return train_step


def _make_fused_grad_one(model, cfg: Config, preprocess_fn,
                         pp_kwargs: dict) -> Callable[[RawBatch], dict]:
    """The raw-batch gradient closure of the fused step: device
    preprocessing (no gradient: labels and network input, the JAX step's
    ``stop_gradient``), then forward and backward."""
    _check_trainer_b(cfg)
    _check_remat(cfg)
    grad_one = _grad_one_on(model, cfg)

    def fused_grad_one(raw: RawBatch) -> dict:
        with torch.no_grad():
            batch = preprocess_fn(raw, **pp_kwargs)
        return grad_one(batch)

    return fused_grad_one


def make_fused_train_step(model, cfg: Config, preprocess_fn,
                          pp_kwargs: dict):
    """``train_step(state, raw)`` on a raw batch -> ``(state, losses)``:
    preprocessing, forward, trainer-B loss, backward and the Adam update.
    The train-time augmentations wait for a later slice (ROADMAP.md,
    queue 1): ``preprocess_fn`` raises if asked for them."""
    grad_one = _make_fused_grad_one(model, cfg, preprocess_fn, pp_kwargs)

    def train_step(state: TrainState, raw: RawBatch):
        losses = _accum_grads(grad_one, state, raw, cfg.grad_accum)
        return state.apply_gradients(), losses

    return train_step


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
    parts = [metrics_one(r) for r in _split(raw, k)]
    return {key: (torch.stack([p[key] for p in parts]).sum(0)
                  if key.endswith(("_sum", "_count"))
                  else torch.stack([p[key] for p in parts]).mean(0))
            for key in parts[0]}


def make_fused_eval_step(model, cfg: Config, preprocess_fn,
                         pp_kwargs: dict) -> Callable[[RawBatch], dict]:
    """``eval_step(raw)`` -> metrics dict of 0-d tensors on the batch's
    device: loss_xyz, loss_rot, loss, mpjpe, mpjpe_sum, mpjpe_count.  The
    model runs in eval mode (running statistics)."""
    _check_trainer_b(cfg)

    def metrics_one(raw_i: RawBatch) -> dict:
        batch = preprocess_fn(raw_i, **pp_kwargs)
        return _eval_metrics(forward(model, batch, cfg), batch, cfg)

    @torch.inference_mode()
    def eval_step(raw: RawBatch) -> dict:
        return _accum_eval(metrics_one, raw, cfg.grad_accum)

    return eval_step
