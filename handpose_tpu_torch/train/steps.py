"""Train and eval steps: raw batch -> preprocessing -> forward -> loss.

Port of ``handpose_tpu/train/steps.py``: ``_forward`` (:44-64),
``compute_losses`` with the per-model loss gates (:67-115), ``_accum_grads``
(:132-174), ``make_train_step`` (:177-199), ``_eval_metrics``
(:202-223), ``_accum_eval`` with its gcd rule (:226-259),
``make_eval_step`` (:262-274), the fused steps with the train-time
augmentations (:277-303, :345-383), ``_maybe_remat`` (:118-129) and
``make_fused_multi_step`` (:305-342).  A fused step takes the
preprocessing it is given or, with None, the one of the raw batch's type
(RHD or InterHand2.6M); ``pck_thresholds`` adds the PCK sums to the eval
metrics.  PyTorch runs eagerly, so a "fused"
step is one Python function on device tensors rather than one compiled
program.
A train step returns ``(state, losses)`` like the JAX step; it updates
the model's parameters, Adam's moments and the BatchNorm statistics in
place, where JAX returns a new state.

Data parallel: a train step made on ``parallel.replicate(model)`` (DDP)
is one rank's part of JAX's global program.  It takes this rank's rows
of the global batch; BatchNorm's statistics are global
(``nn/norm.py``); each model output and each label the loss reads is
gathered over the ranks (``parallel.gather_rows``), so every rank
computes the loss of the global batch (JAX's masked means over it), logs
it and checks it; the gather's backward sums the ranks' identical
gradients and DDP's mean over the ranks divides that back out.  The
augmentations' and the model's draws are made for the global batch from
the generator (equal on every rank) and cut to the rank's rows, and
``draws``/``model_draws`` given to the step are the global batch's.
Under a dp x tp mesh the rows, the gathers and DDP's mean are the data
axis's (``parallel.distributed.data_rank``).  A step made on a
``parallel.sharding.TensorParallel`` model (the state of
``shard_train_state``) runs the same way with the model's selected
parameters gathered over the "model" axis for compute; its gradients are
averaged over the data axis in one flat all-reduce after the backward,
where DDP would reduce its buckets.

``cfg.remat`` runs the model's forward under ``torch.utils.checkpoint``
(:class:`Remat`); ``cfg.debug_nans`` raises ``FloatingPointError``
naming the first module that made a NaN (``train/nans.py``).
"""

from __future__ import annotations

import math
from contextlib import contextmanager, nullcontext
from dataclasses import fields, replace
from typing import Callable, Dict, Optional

import torch
from torch import nn
from torch.nn.parallel import DistributedDataParallel
from torch.utils.checkpoint import checkpoint

from ..config import Config
from ..data.preprocess import (AugmentDraws, RawBatch, draw_augmentations,
                               model_input, preprocess_fn_for)
from ..losses import LossCalculation, masked_l2_loss, rot_mat_mse
from ..metrics import masked_sum_count, mpjpe, pck_sum_count
from ..nn.norm import BatchNorm
from ..ops.projection import rel_normed_to_absolute
from ..parallel.distributed import data_world, gather_rows
from ..parallel.mesh import shard_batch
from ..parallel.sharding import TensorParallel
from ..utils.tracing import span
from .nans import nan_trap
from .state import TrainState

_TRAINER_B = ("Hand3DPoseNet", "Hand3DPosePriorNetwork")


# the labels compute_losses reads
_LOSS_LABELS = ("keypoint_vis21", "keypoint_xyz21", "keypoint_uv21",
                "right_hand_mask", "kp_coord_xyz21_rel_can", "rot_mat")


def _running_stats(bns) -> list:
    return [(b.running_mean.clone(), b.running_var.clone()) for b in bns]


def _load_running_stats(bns, stats) -> None:
    with torch.no_grad():
        for b, (mean, var) in zip(bns, stats):
            b.running_mean.copy_(mean)
            b.running_var.copy_(var)


class Remat(nn.Module):
    """``module``'s forward with activation recomputation (JAX's
    ``jax.checkpoint`` around the forward): ``torch.utils.checkpoint``,
    non-reentrant, keeps the inputs and recomputes the forward in the
    backward.  The recompute runs each train-mode BatchNorm again: it
    finds the running statistics the forward found (so 'shifted' takes
    the same shift), and leaves the forward's update of them in place,
    so they move once a step.  The draws of a stochastic model are made
    ahead, outside (:func:`_draw_kwargs`), so the recompute takes them as
    given."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module

    def forward(self, *args, **kwargs):
        bns = [m for m in self.module.modules() if isinstance(m, BatchNorm)]
        before = _running_stats(bns)

        @contextmanager
        def recompute():
            after = _running_stats(bns)
            _load_running_stats(bns, before)
            try:
                yield
            finally:
                _load_running_stats(bns, after)

        return checkpoint(lambda *a: self.module(*a, **kwargs), *args,
                          use_reentrant=False,
                          context_fn=lambda: (nullcontext(), recompute()))


def unwrap(net: nn.Module) -> nn.Module:
    """The model inside its DDP, ``TensorParallel`` and :class:`Remat`
    wrappers."""
    while isinstance(net, (DistributedDataParallel, TensorParallel, Remat)):
        net = net.module
    return net


def _sharded(net: nn.Module) -> bool:
    """Whether ``net`` holds one data rank's rows of a global batch."""
    return isinstance(net, (DistributedDataParallel, TensorParallel))


def train_module(model: nn.Module, cfg: Config) -> nn.Module:
    """``model`` as a train step runs it: under :class:`Remat` with
    ``cfg.remat``.  Replicate this (``parallel.replicate``), not the
    model, so that DDP's forward holds the checkpoint."""
    return Remat(model) if cfg.remat else model


def _train_net(model: nn.Module, cfg: Config) -> nn.Module:
    inner = model.module if _sharded(model) else model
    if not cfg.remat or isinstance(inner, Remat):
        return model
    if _sharded(model):
        raise ValueError("remat under DDP or TensorParallel: wrap "
                         "train_module(model, cfg), not the model")
    return Remat(model)


def _draw_kwargs(model, batch: dict, generator, model_draws, rows: int,
                 sharded: bool = False) -> dict:
    """What a model that draws random numbers (``model.stochastic``)
    takes besides its inputs: the draws injected by the batch's
    ``_inject_<name>`` entries (the JAX package's injection surface,
    ``handpose_tpu/train/steps.py:50-56``) or by ``model_draws`` ({name:
    whole-batch tensor}), and the rest drawn here from ``generator``, in
    the order the forward would draw them (``model.draws``).  Sharded,
    ``model_draws`` and the drawn ones are the global batch's (``rows``
    a rank), cut to this rank's rows.  Other models take nothing."""
    if not getattr(model, "stochastic", False):
        return {}
    kw = {k[len("_inject_"):]: v for k, v in batch.items()
          if k.startswith("_inject_")}
    given = dict(model_draws or {})
    w = data_world() if sharded else 1
    if generator is not None:
        given.update(model.draws(rows * w, generator,
                                 skip=set(kw) | set(given)))
    if sharded:
        given = {k: shard_batch(v, axis=1 if k == "step_noise" else 0)
                 for k, v in given.items()}
    return {**given, **kw}


def _forward(model, batch: dict, cfg: Config, train: bool, generator=None,
             model_draws: Optional[dict] = None):
    """The model on a preprocessed sample dict, in train mode (batch
    statistics, running statistics updated; ``model`` as the train step
    runs it, replicated or rematerialised) or eval mode (the plain
    module); a stochastic model draws from ``generator`` unless its draws
    are injected."""
    net = model if train else unwrap(model)
    net.train(train)
    inp = model_input(batch, cfg.input_channels)
    pose_x0 = batch["keypoint_xyz21_rel_normed"].reshape(inp.shape[0], 1, -1)
    # a replicated train step, or an eval step on a data axis of several
    # ranks (the Worker's padded validation), holds a rank's rows
    sharded = _sharded(model) if train else data_world() > 1
    return net(inp, batch["camera_intrinsic_matrix"],
               batch["keypoint_scale"], batch["keypoint_xyz_root"], pose_x0,
               **_draw_kwargs(unwrap(model), batch, generator, model_draws,
                              inp.shape[0], sharded))


def _gathered(out, batch: dict):
    """(out, batch) over the global batch: each output, and each label the
    loss reads, gathered over the ranks; a per-batch mean output
    (``diffusion_loss``) becomes the mean of the ranks' equal-sized
    batches."""
    def gather(v):
        if v is None:
            return None
        if v.ndim == 0:
            return gather_rows(v.reshape(1)).mean()
        return gather_rows(v)

    out = replace(out, **{f.name: gather(getattr(out, f.name))
                          for f in fields(out)})
    return out, {k: gather_rows(batch[k]) for k in _LOSS_LABELS
                 if k in batch}


@contextmanager
def _watch(model, cfg: Config):
    """``cfg.debug_nans``: the model's NaN trap watches the block."""
    if not cfg.debug_nans:
        yield
        return
    with nan_trap(model).watch():
        yield


def forward(model, batch: dict, cfg: Config, generator=None,
            model_draws: Optional[dict] = None):
    """The model on a preprocessed sample dict, eval mode."""
    return _forward(model, batch, cfg, False, generator, model_draws)


def pass_draws(model, cfg: Config, device) -> dict:
    """The eval step's keyword arguments for one pass over a split: for a
    stochastic model, a generator on ``device`` seeded ``cfg.seed`` at the
    pass's start.  The Worker's validation and the Evaluator both take
    it, so a checkpoint's Evaluator gives the run's validation MPJPE
    exactly (the JAX Worker draws validation from its running key, its
    Evaluator from ``PRNGKey(0)``)."""
    if not getattr(model, "stochastic", False):
        return {}
    return {"generator": torch.Generator(device=device).manual_seed(
        cfg.seed)}


def compute_losses(out, batch: dict, cfg: Config) -> Dict[str, torch.Tensor]:
    """Gated loss terms and their total (reference trainval.py:330-360).

    Trainer-B models: canonical-coords L2 and rotation MSE (reference
    trainval_hand3DPose.py:284-288).  The others: one
    :class:`LossCalculation` built per ``cfg.loss_gates``; the total adds
    ``loss_uv / 1e5`` (trainval.py:346) while ``loss_uv`` is reported
    unscaled, and the model's ``diffusion_loss`` only under its gate."""
    vis = batch["keypoint_vis21"]
    if cfg.model_name in _TRAINER_B:
        loss_xyz = masked_l2_loss(out.can_xyz,
                                  batch["kp_coord_xyz21_rel_can"], vis)
        loss_rot = rot_mat_mse(out.rot_mat, batch["rot_mat"])
        return {"loss_xyz": loss_xyz, "loss_rot": loss_rot,
                "loss": loss_xyz + loss_rot}
    gates = cfg.loss_gates
    criterion = LossCalculation(
        loss_type="L2",
        comp_xyz_loss=gates["xyz"] and out.xyz is not None,
        comp_uv_loss=gates["uv"] and out.uv is not None,
        comp_hand_mask_loss=gates["hand_mask"] and out.uv is not None,
        comp_regularization_loss=(gates["regularization"]
                                  and out.theta is not None))
    lt = criterion(out.xyz, batch["keypoint_xyz21"], out.uv,
                   batch["keypoint_uv21"], vis,
                   hand_mask=batch.get("right_hand_mask"),
                   theta=out.theta, beta=out.beta)
    terms = {}
    total = torch.zeros((), device=vis.device)
    if lt.xyz is not None:
        terms["loss_xyz"] = lt.xyz
        total = total + lt.xyz
    if lt.uv is not None:
        terms["loss_uv"] = lt.uv
        total = total + lt.uv / 1e5
    if gates["diffusion"] and out.diffusion_loss is not None:
        terms["loss_diffusion"] = out.diffusion_loss
        total = total + out.diffusion_loss
    if lt.hand_mask is not None:
        terms["loss_hand_mask"] = lt.hand_mask
        total = total + lt.hand_mask
    if lt.regularization is not None:
        terms["loss_regularization"] = lt.regularization
        total = total + lt.regularization
    return {**terms, "loss": total}


def _batch_size(data) -> int:
    """The batch axis of a RawBatch or a sample dict."""
    if isinstance(data, dict):
        return next(iter(data.values())).shape[0]
    return data[0].shape[0]


def _split(data, k: int):
    """``data`` (a RawBatch or a sample dict) cut into ``k`` equal
    microbatches along the batch axis."""
    B = _batch_size(data)
    if B % k:
        raise ValueError(f"grad_accum={k} does not divide batch dim {B}")
    m = B // k
    if isinstance(data, dict):
        return [{key: v[i * m:(i + 1) * m] for key, v in data.items()}
                for i in range(k)]
    return [type(data)(*(a[i * m:(i + 1) * m] for a in data))
            for i in range(k)]


def _global_aug_draws(raw: RawBatch, flags: dict, pp_kwargs: dict,
                      generator) -> AugmentDraws:
    """The augmentation draws of the global batch (every rank's rows) for
    the hand-cropped scoremaps of the Worker's preprocessing, made from
    ``generator`` as ``preprocess_batch`` makes them for one batch."""
    if generator is None:
        raise ValueError(f"augmentations {sorted(flags)} need draws or a "
                         "generator")
    crop = pp_kwargs.get("crop_size", 256)
    return draw_augmentations(list(flags), (
        raw.image.shape[0] * data_world(), tuple(raw.image.shape[1:3]),
        (crop, crop), 0), generator)


def _accum_grads(grad_one: Callable, state: TrainState, data,
                 k: int, draws: Optional[AugmentDraws] = None,
                 model_draws: Optional[dict] = None, net=None
                 ) -> Dict[str, torch.Tensor]:
    """Gradients over ``data`` into the parameters' ``.grad``, optionally
    over ``k`` sequential microbatches (``cfg.grad_accum``); returns the
    loss dict.

    ``grad_one(data_i, draws_i, model_draws_i)`` runs one microbatch's
    forward and backward (adding its mean-loss gradient to ``.grad``) and
    returns its losses.
    For ``k > 1`` the summed gradient is divided by ``k`` (the mean over
    microbatches), BatchNorm normalises per microbatch and its running
    statistics take momentum once per microbatch, and the loss dicts are
    averaged: the JAX function's semantics.  Injected augmentation
    ``draws`` and the model's injected ``model_draws`` for the whole
    batch are cut along the batch axis with it;
    without them each microbatch draws its own, as the JAX step splits its
    key per microbatch.  A replicated ``net`` (DDP) all-reduces the
    gradients once, in the last microbatch's backward; a
    ``TensorParallel`` one once, after it."""
    state.optimizer.zero_grad(set_to_none=True)
    if k == 1:
        losses = grad_one(data, draws, model_draws)
    else:
        no_sync = net.no_sync if isinstance(net, DistributedDataParallel) \
            else nullcontext
        parts = []
        for i, a in enumerate(zip(
                _split(data, k),
                [None] * k if draws is None else draws.split(k),
                [None] * k if model_draws is None else _split(model_draws,
                                                              k))):
            with no_sync() if i < k - 1 else nullcontext():
                parts.append(grad_one(*a))
        losses = {key: torch.stack([p[key] for p in parts]).mean(0)
                  for key in parts[0]}
    if isinstance(net, TensorParallel) or k > 1:
        with span("hp.train.backward"):
            if isinstance(net, TensorParallel):
                net.all_reduce_gradients()
            if k > 1:
                with torch.no_grad():
                    for p in state.model.parameters():
                        if p.grad is not None:
                            p.grad.div_(k)
    return losses


def _grad_one_on(net, cfg: Config) -> Callable:
    """The gradient closure on a preprocessed sample dict (augmented, if
    at all, when it was made), ``grad_one(batch, generator=None,
    model_draws=None)``; ``net`` as :func:`_train_net` gives it."""
    def grad_one(batch: dict, generator=None, model_draws=None) -> dict:
        with _watch(unwrap(net), cfg):
            with span("hp.train.forward"):
                out = _forward(net, batch, cfg, True, generator, model_draws)
                if _sharded(net):
                    out, batch = _gathered(out, batch)
                losses = compute_losses(out, batch, cfg)
            with span("hp.train.backward"):
                losses["loss"].backward()
        return {k: v.detach() for k, v in losses.items()}

    return grad_one


def make_train_step(model, cfg: Config):
    """``train_step(state, batch, generator=None, model_draws=None)`` on
    a preprocessed sample dict -> ``(state, losses)``; a stochastic
    model draws from ``generator`` unless ``model_draws`` (or the batch's
    ``_inject_*`` entries) give its draws.  ``model`` may be replicated
    (``parallel.replicate(train_module(model, cfg))``); the batch is
    then this rank's rows."""
    net = _train_net(model, cfg)
    grad_one = _grad_one_on(net, cfg)

    def train_step(state: TrainState, batch: dict, generator=None,
                   model_draws: Optional[dict] = None):
        with span("hp.train.step"):
            losses = _accum_grads(
                lambda b, _, md: grad_one(b, generator, md), state, batch,
                cfg.grad_accum, model_draws=model_draws, net=net)
            return state.apply_gradients(), losses

    return train_step


def _make_fused_grad_one(model, cfg: Config, preprocess_fn,
                         pp_kwargs: dict, aug_flags: Optional[dict] = None
                         ) -> Callable:
    """The raw-batch gradient closure of the fused step,
    ``grad_one(raw, draws=None, generator=None, model_draws=None)``:
    device preprocessing with the augmentations of ``aug_flags`` that are
    on (no gradient: labels and network input, the JAX step's
    ``stop_gradient``), then forward and backward; augmentations, then
    the model, draw from ``generator`` unless given their draws."""
    net = _train_net(model, cfg)
    grad_one = _grad_one_on(net, cfg)
    flags = {k: True for k, v in (aug_flags or {}).items() if v}
    sharded = _sharded(net)

    def fused_grad_one(raw: RawBatch, draws=None, generator=None,
                       model_draws=None) -> dict:
        fn = preprocess_fn or preprocess_fn_for(raw)
        with span("hp.train.preprocess"):
            if sharded and flags:
                if draws is None:
                    draws = _global_aug_draws(raw, flags, pp_kwargs,
                                              generator)
                draws = shard_batch(draws)
            with torch.no_grad():
                batch = fn(raw, **pp_kwargs, **flags, draws=draws,
                           generator=generator)
        return grad_one(batch, generator, model_draws)

    fused_grad_one.net = net
    return fused_grad_one


def make_fused_train_step(model, cfg: Config, preprocess_fn,
                          pp_kwargs: dict, aug_flags: Optional[dict] = None):
    """``train_step(state, raw, generator=None, draws=None,
    model_draws=None)`` on a raw batch -> ``(state, losses)``:
    preprocessing with the augmentations of ``aug_flags`` that are on,
    forward, loss, backward and the Adam update.  The augmentations and a
    stochastic model draw from ``generator`` (a ``torch.Generator`` on
    the batch's device), or take ``draws`` and ``model_draws``
    ({``init_noise``, ``diff_t``, ``diff_noise``: whole-batch tensors})
    for the whole batch (the tests inject the JAX step's).  ``model`` may
    be replicated (see :func:`make_train_step`): ``raw`` is then this
    rank's rows, ``draws`` and ``model_draws`` the global batch's."""
    grad_one = _make_fused_grad_one(model, cfg, preprocess_fn, pp_kwargs,
                                    aug_flags)

    def train_step(state: TrainState, raw: RawBatch, generator=None,
                   draws: Optional[AugmentDraws] = None,
                   model_draws: Optional[dict] = None):
        with span("hp.train.step"):
            losses = _accum_grads(
                lambda r, d, md: grad_one(r, d, generator, md), state, raw,
                cfg.grad_accum, draws, model_draws, net=grad_one.net)
            return state.apply_gradients(), losses

    return train_step


def make_fused_multi_step(model, cfg: Config, preprocess_fn,
                          pp_kwargs: dict, aug_flags: Optional[dict] = None,
                          k: Optional[int] = None):
    """``multi_step(state, raw_stack, generator=None)`` -> ``(state,
    losses)``: ``k`` (``cfg.steps_per_dispatch``) fused train steps of
    :func:`make_fused_train_step` over a raw batch stacked on a leading
    k axis, in order, each drawing its augmentations (and a stochastic
    model its draws) from ``generator`` after the step before; the loss
    dicts come stacked on a leading k axis.  The same arithmetic as k
    single steps (JAX's ``lax.scan`` of them in one program: the Worker
    dispatches a full group at once and checks preemption between
    groups)."""
    k = k or cfg.steps_per_dispatch
    step = make_fused_train_step(model, cfg, preprocess_fn, pp_kwargs,
                                 aug_flags)

    def multi_step(state: TrainState, raw_stack: RawBatch, generator=None):
        if raw_stack[0].shape[0] != k:
            raise ValueError(f"a group of {raw_stack[0].shape[0]} batches, "
                             f"not steps_per_dispatch={k}")
        per = []
        for i in range(k):
            state, losses = step(state, type(raw_stack)(
                *(a[i] for a in raw_stack)), generator=generator)
            per.append(losses)
        return state, {key: torch.stack([p[key] for p in per])
                       for key in per[0]}

    return multi_step


def _absolute_xyz(out, batch: dict):
    """(predicted, ground-truth) absolute 3-D keypoints in metres, the
    pair the PCK curve reads, or None for a model without 3-D output
    (``TwoDimHandPose``: no PCK, as in the JAX step).  A model with an
    ``xyz`` output is held to ``keypoint_xyz21``, as in the JAX step.
    The trainer-B models output root-relative normalised coordinates in
    training mode; they are made absolute as the serving branch makes
    them (``rel_normed_to_absolute`` with the sample's scale and root),
    against the ground truth's own normalised coordinates, which share
    the model's joint order."""
    if out.xyz is not None:
        return out.xyz, batch["keypoint_xyz21"]
    if out.coord_xyz_rel_normed is None:
        return None
    scale, root = batch["keypoint_scale"], batch["keypoint_xyz_root"]
    return (rel_normed_to_absolute(out.coord_xyz_rel_normed, scale, root),
            rel_normed_to_absolute(batch["keypoint_xyz21_rel_normed"],
                                   scale, root))


def _eval_metrics(out, batch: dict, cfg: Config,
                  pck_thresholds=None) -> Dict[str, torch.Tensor]:
    """Losses, MPJPE and its sums, and the PCK sums where there are
    absolute 3-D keypoints.  The MPJPE is taken on the canonical coords
    for trainer-B models, on ``uv`` for ``TwoDimHandPose`` and on ``xyz``
    for the other trainer-A models (``handpose_tpu/train/steps.py:
    202-223``)."""
    losses = compute_losses(out, batch, cfg)
    vis = batch["keypoint_vis21"]
    if cfg.model_name in _TRAINER_B:
        pred, gt = out.can_xyz, batch["kp_coord_xyz21_rel_can"]
    elif cfg.model_name == "TwoDimHandPose":
        pred, gt = out.uv, batch["keypoint_uv21"]
    else:
        pred, gt = out.xyz, batch["keypoint_xyz21"]
    s, n = masked_sum_count(pred, gt, vis)
    metrics = {**losses, "mpjpe": mpjpe(pred, gt, vis),
               "mpjpe_sum": s, "mpjpe_count": n}
    pair = _absolute_xyz(out, batch) if pck_thresholds is not None else None
    if pair is not None:
        # the same joints and visibility as the MPJPE, in metres
        cs, cn = pck_sum_count(*pair, vis, pck_thresholds)
        metrics["pck_correct_sum"] = cs
        metrics["pck_count"] = cn
    return metrics


def _accum_eval(metrics_one: Callable, data, k: int
                ) -> Dict[str, torch.Tensor]:
    """Metrics over ``data`` (a raw batch or a sample dict) in gcd(k, B)
    equal microbatches (``k`` = ``cfg.grad_accum``): ``_sum``/``_count``
    keys add, per-batch means average."""
    k = math.gcd(k, _batch_size(data))
    if k == 1:
        return metrics_one(data)
    parts = [metrics_one(r) for r in _split(data, k)]
    return {key: (torch.stack([p[key] for p in parts]).sum(0)
                  if key.endswith(("_sum", "_count"))
                  else torch.stack([p[key] for p in parts]).mean(0))
            for key in parts[0]}


def make_eval_step(model, cfg: Config,
                   pck_thresholds=None) -> Callable[[dict], dict]:
    """``eval_step(batch, generator=None)`` on a preprocessed sample dict
    -> the metrics of :func:`make_fused_eval_step` (the fake-data path's
    validation)."""

    @torch.inference_mode()
    def eval_step(batch: dict, generator=None) -> dict:
        def metrics_one(batch_i: dict) -> dict:
            with _watch(unwrap(model), cfg):
                return _eval_metrics(forward(model, batch_i, cfg, generator),
                                     batch_i, cfg, pck_thresholds)

        return _accum_eval(metrics_one, batch, cfg.grad_accum)

    return eval_step


def make_fused_eval_step(model, cfg: Config, preprocess_fn,
                         pp_kwargs: dict, pck_thresholds=None
                         ) -> Callable[[RawBatch], dict]:
    """``eval_step(raw, generator=None)`` -> metrics dict of tensors on
    the batch's device: the loss terms of :func:`compute_losses`, mpjpe,
    mpjpe_sum, mpjpe_count (0-d) and, with ``pck_thresholds`` (T,) in
    metres and a model with 3-D output, pck_correct_sum (T,) and
    pck_count, from the same forward.  The model runs in eval mode
    (running statistics); a stochastic model draws from ``generator``."""

    @torch.inference_mode()
    def eval_step(raw: RawBatch, generator=None) -> dict:
        def metrics_one(raw_i: RawBatch) -> dict:
            fn = preprocess_fn or preprocess_fn_for(raw_i)
            batch = fn(raw_i, **pp_kwargs)
            with _watch(unwrap(model), cfg):
                return _eval_metrics(forward(model, batch, cfg, generator),
                                     batch, cfg, pck_thresholds)

        return _accum_eval(metrics_one, raw, cfg.grad_accum)

    return eval_step
