"""The training harness: the JAX package's ``Worker``.

Port of ``handpose_tpu/train/trainer.py:44-549`` on one card: the RHD
and InterHand2.6M datasets (decoded per batch, or through their decoded
caches with ``cfg.cache_decoded``; InterHand's mixed capture sizes
zero-padded to one frame), ``steps_per_epoch = max(len(train) //
batch_size, 1)``, a shuffled epoch order with the remainder dropped for
training, pinned prefetch, the fused train step with the train-time
augmentations (drawn on the card from one ``torch.Generator`` seeded
``cfg.seed + 17``), then validation over the whole split (trailing
partial batch included) through the fused eval step (a model that draws
in its forward, DiffusionHandPose, trains on the Worker's generator and
validates on one seeded ``cfg.seed`` afresh each pass); fake and synthetic
data (10 steps an epoch of ``fake_sample_batch`` through the non-fused
steps); ``fast_debug`` (3 iterations per epoch); the NaN abort; the run
directory with its config and provenance, TensorBoard scalars,
``log.txt`` and the step against input-stall times; a checkpoint at
every epoch's end (``model_best`` on a new best), resume and finetune;
and preemption-safe training.

PyTorch runs eagerly, so ``steps_per_dispatch`` (k fused steps in one
XLA program in the JAX package, the same math as k single steps) runs
its steps one at a time.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np
import torch

from ..config import Config
from ..data.pipeline import open_dataset, raw_device_batches
from ..data.synthetic import fake_sample_batch
from ..device import resolve_device
from ..models import build_model, mano_source_of
from ..utils.logging import RunLogger, StepStats, make_run_dir
from .checkpoints import (filtered_resume, reconcile_schedule_count,
                          save_checkpoint)
from .preemption import PreemptionGuard
from .state import create_train_state
from .steps import (make_eval_step, make_fused_eval_step,
                    make_fused_train_step, make_train_step, pass_draws)

AUG_FLAGS = ("hue_aug", "coord_uv_noise", "crop_center_noise",
             "crop_scale_noise", "crop_offset_noise", "scoremap_dropout")
# the two augmentations the reference's InterHand loader applies
# (dataloaderInterHand2M6.py:317-318,549-552)
INTERHAND_AUG_FLAGS = ("coord_uv_noise", "scoremap_dropout")
DATASETS = ("RHD", "InterHand2.6M")
FAKE_STEPS_PER_EPOCH = 10


def _check_supported(cfg: Config):
    if cfg.scale_to_size or cfg.random_crop_to_size:
        # as the JAX Worker: both transforms replace the sample dict with
        # one no model can take
        raise ValueError(
            "scale_to_size / random_crop_to_size produce reduced dataset "
            "outputs incompatible with training; use the data pipeline "
            "directly")
    if not _is_fake(cfg) and cfg.dataset_name not in DATASETS:
        raise ValueError(f"dataset {cfg.dataset_name!r} not in {DATASETS} "
                         "or 'synthetic'")


def _is_fake(cfg: Config) -> bool:
    return cfg.use_fake_data or cfg.dataset_name == "synthetic"


class Worker:
    """Epoch-loop trainer on the card (``device=None``) or, when asked
    for, the host (``device="cpu"``).  ``weights`` is what the Evaluator
    takes: None (the seeded init), an ``.npz`` path, a checkpoint
    directory or a mapping of flattened flax variables;
    ``cfg.resume_weight_path`` (a checkpoint directory) then resumes or
    finetunes from it."""

    def __init__(self, cfg: Config, run_dir: Optional[str] = None,
                 weights=None, device=None):
        # the infer package imports the train steps; import it here
        from ..infer.evaluator import load_weights, serving_kwargs
        _check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = load_weights(build_model(cfg), weights).to(self.device)
        self.fused = not _is_fake(cfg)
        if self.fused:
            if cfg.dataset_name == "InterHand2.6M":
                train_split, val_split = "train", "val"
            else:
                train_split = ("evaluation" if cfg.use_val_dataset_to_debug
                               else "training")
                val_split = "evaluation"
            self.train_ds = open_dataset(cfg, train_split)
            self.val_ds = open_dataset(cfg, val_split)
            self.steps_per_epoch = max(len(self.train_ds) // cfg.batch_size,
                                       1)
            pp_kwargs = serving_kwargs(cfg)
            names = (INTERHAND_AUG_FLAGS
                     if cfg.dataset_name == "InterHand2.6M" else AUG_FLAGS)
            self.aug_flags = {f: getattr(cfg, f) for f in names}
            # preprocessing=None: the steps take the raw batch's own
            self.train_step = make_fused_train_step(
                self.model, cfg, None, pp_kwargs, self.aug_flags)
            self.eval_step = make_fused_eval_step(self.model, cfg, None,
                                                  pp_kwargs)
            what = (f"{len(self.train_ds)} {cfg.dataset_name} "
                    f"{train_split} samples")
        else:
            self.train_ds = self.val_ds = None
            self.steps_per_epoch = FAKE_STEPS_PER_EPOCH
            self.aug_flags = {}
            self.train_step = make_train_step(self.model, cfg)
            self.eval_step = make_eval_step(self.model, cfg)
            what = "fake batches"
        self.state = create_train_state(self.model, cfg, self.steps_per_epoch)
        mano = mano_source_of(cfg)
        self.run_dir = run_dir if run_dir is not None else make_run_dir(
            cfg.save_log_dir, cfg.model_name, cfg.dataset_name, cfg.to_json(),
            provenance=None if mano is None else {"mano": mano})
        os.makedirs(self.run_dir, exist_ok=True)
        self.logger = RunLogger(self.run_dir)
        self.log_path = self.logger.log_path
        self.stats = StepStats()
        self.step_seconds: list = []     # host time of each train step
        self.start_epoch = 0
        self.best_mpjpe = float(np.inf)
        # the augmentations' and the model's training draws, on the card
        # (JAX: PRNGKey(seed + 17))
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 17)
        # a model that draws in its forward (DiffusionHandPose) takes the
        # generator in training too
        self.stochastic = getattr(self.model, "stochastic", False)
        self.preempt: Optional[PreemptionGuard] = None
        aug = [f for f, on in self.aug_flags.items() if on]
        self.logger.text(
            f"training {cfg.model_name} on {self.device}: {what}, batch "
            f"{cfg.batch_size}, {self.steps_per_epoch} steps per epoch, "
            f"bn_variance {cfg.bn_mode}, compute {cfg.compute_dtype}, "
            f"augmentations {aug or 'off'}")
        if cfg.steps_per_dispatch > 1:
            self.logger.text(
                f"steps_per_dispatch={cfg.steps_per_dispatch}: the port "
                "runs the steps of a group one at a time (the same math)")
        if cfg.resume_weight_path:
            self.state, self.start_epoch, self.best_mpjpe, finetune = \
                filtered_resume(self.state, cfg.resume_weight_path)
            if not finetune:
                # the stored count is the writing run's; re-pin it so the
                # cosine LR resumes at epoch start_epoch
                self.state = reconcile_schedule_count(
                    self.state, self.start_epoch, self.steps_per_epoch)
            mode = "finetune" if finetune else "resume"
            self.logger.text(f"loaded {cfg.resume_weight_path} as {mode}; "
                             f"start_epoch={self.start_epoch}")

    def text(self, info: str):
        """Print a log line and append it to ``<run_dir>/log.txt``."""
        self.logger.text(info)

    def enable_preemption_save(self, guard: Optional[PreemptionGuard] = None
                               ) -> PreemptionGuard:
        """Arm preemption-safe training: on SIGTERM (or ``guard``'s
        signals) the epoch loop stops at the next step boundary,
        :meth:`run` writes a resumable ``checkpoint`` pinned to the
        interrupted epoch and returns; resuming restarts that epoch."""
        self.preempt = (guard or PreemptionGuard()).install()
        return self.preempt

    def _preempt_now(self) -> bool:
        return self.preempt is not None and self.preempt.requested

    def _epoch_batches(self, split: str, epoch: int) -> Iterator:
        cfg = self.cfg
        if not self.fused:
            for i in range(self.steps_per_epoch):
                batch = fake_sample_batch(min(cfg.batch_size, 8),
                                          cfg.crop_size, cfg.input_channels,
                                          epoch * 1000 + i)
                yield {k: v.to(self.device) for k, v in batch.items()}
            return
        is_train = split == "training"
        ds = self.train_ds if is_train else self.val_ds
        shuffle = is_train and cfg.shuffle \
            and not cfg.use_val_dataset_to_debug
        # validation sees the whole split, its trailing partial batch too
        yield from raw_device_batches(
            ds, cfg.batch_size, self.device, shuffle=shuffle,
            seed=cfg.seed * 100003 + epoch, drop_remainder=is_train,
            depth=max(cfg.prefetch_depth, 2))

    def _train_on(self, batch):
        if self.fused or self.stochastic:
            return self.train_step(self.state, batch,
                                   generator=self.generator)
        return self.train_step(self.state, batch)

    def _finish_train_metrics(self, metrics: dict, epoch: int, idx: int,
                              losses_acc: dict):
        """NaN abort, loss accumulation and periodic logging of a step."""
        if self.cfg.nan_check:
            loss_val = float(metrics["loss"])
            if not np.isfinite(loss_val):
                self.text(f"FATAL: non-finite loss {loss_val} at epoch "
                          f"{epoch} iter {idx}; aborting (resume from the "
                          f"last checkpoint in {self.run_dir})")
                raise FloatingPointError(
                    f"non-finite training loss at epoch {epoch} iter {idx}")
        for k, v in metrics.items():
            losses_acc[k] = losses_acc.get(k, 0.0) + float(v)
        every = self.cfg.log_every_steps
        if every and idx % every == 0:
            terms = ", ".join(f"{k}: {float(v):.5f}"
                              for k, v in metrics.items())
            self.text(f"  epoch {epoch:03d} iter {idx:05d}/"
                      f"{self.steps_per_epoch:05d} | {terms} | "
                      f"{self.stats.summary()}")

    def run_epoch(self, epoch: int, split: str,
                  fast_debug: bool = False) -> Optional[float]:
        """One pass over ``split`` ('training' or 'validation'); returns
        the validation MPJPE (None for training, or when no joint was
        visible)."""
        is_train = split == "training"
        losses_acc: dict = {}
        mpjpe_sum = mpjpe_count = 0.0
        n = 0
        draws = {} if is_train else pass_draws(self.model, self.cfg,
                                               self.device)
        self.stats.input.tic()
        for idx, batch in enumerate(self._epoch_batches(split, epoch)):
            self.stats.input.toc()
            if fast_debug and idx > 2:
                break
            if self._preempt_now():
                self.text(f"preemption requested: stopping {split} at "
                          f"epoch {epoch} iter {idx}")
                break
            self.stats.step.tic()
            if is_train:
                self.state, metrics = self._train_on(batch)
                self._finish_train_metrics(metrics, epoch, idx, losses_acc)
                self.step_seconds.append(self.stats.step.toc())
            else:
                metrics = self.eval_step(batch, **draws)
                mpjpe_sum += float(metrics["mpjpe_sum"])
                mpjpe_count += float(metrics["mpjpe_count"])
                self.stats.step.toc()
                for k, v in metrics.items():
                    if k not in ("mpjpe_sum", "mpjpe_count"):
                        losses_acc[k] = losses_acc.get(k, 0.0) + float(v)
            n += 1
            self.stats.input.tic()
        self.stats.input.toc()
        means = {k: v / max(n, 1) for k, v in losses_acc.items()}
        # a validation that saw no visible joint has no metric: 0.0 would
        # read as a perfect MPJPE and poison the best checkpoint
        epoch_mpjpe = None
        if not is_train and mpjpe_count:
            epoch_mpjpe = mpjpe_sum / mpjpe_count
        tag = "Training" if is_train else "Validation"
        info = f"{tag} Epoch: {epoch:03d} ({self.stats.summary()}), " + \
            ", ".join(f"{k}: {v:.5f}" for k, v in means.items())
        if epoch_mpjpe is not None:
            info += f", MPJPE: {epoch_mpjpe:.5f}"
            self.logger.scalar(f"{tag} epoch MPJPE", epoch_mpjpe, epoch)
        else:
            self.logger.scalar(f"{tag} epoch loss", means.get("loss", 0.0),
                               epoch)
        self.text(info)
        return epoch_mpjpe

    def run(self, fast_debug: bool = False,
            max_epoch: Optional[int] = None) -> float:
        """Train and validate each epoch from ``start_epoch``, writing a
        checkpoint at each epoch's end; returns the best validation
        MPJPE."""
        end = max_epoch if max_epoch is not None else self.cfg.max_epoch
        run_dir = os.path.abspath(self.run_dir)
        for epoch in range(self.start_epoch, end):
            self.run_epoch(epoch, "training", fast_debug)
            if self._preempt_now():
                # the epoch ran in part: resume restarts it
                self._save_preemption_checkpoint(epoch)
                return self.best_mpjpe
            val = self.run_epoch(epoch, "validation", fast_debug)
            if self._preempt_now():
                # training finished but validation was cut: the partial
                # MPJPE is biased, so best and model_best stay; resume
                # continues at the next epoch
                self._save_preemption_checkpoint(epoch + 1)
                return self.best_mpjpe
            is_best = val is not None and val < self.best_mpjpe
            if is_best:
                self.best_mpjpe = val
            save_checkpoint(run_dir, self.state, epoch + 1, self.best_mpjpe,
                            is_best)
        self.logger.close()
        return self.best_mpjpe

    def _save_preemption_checkpoint(self, start_epoch: int) -> None:
        save_checkpoint(os.path.abspath(self.run_dir), self.state,
                        start_epoch, self.best_mpjpe, is_best=False)
        self.text(f"preemption checkpoint written (resumes at epoch "
                  f"{start_epoch}); resume with --resume "
                  f"{self.run_dir}/checkpoint")
        self.logger.close()
