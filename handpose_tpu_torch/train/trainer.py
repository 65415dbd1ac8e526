"""The training harness: the core of the JAX package's ``Worker``.

Port of ``handpose_tpu/train/trainer.py:41-188,355-381,407-522`` on the
fused RHD path: RHD memmap-cache datasets, ``steps_per_epoch =
max(len(train) // batch_size, 1)``, a shuffled epoch order with the
remainder dropped for training, pinned prefetch, the fused train step,
then validation over the whole split (trailing partial batch included)
through the fused eval step, ``fast_debug`` (3 iterations per epoch),
the NaN abort, the epoch log lines in ``<run_dir>/log.txt`` and the best
validation MPJPE.

PyTorch runs eagerly, so ``steps_per_dispatch`` (k fused steps in one
XLA program in the JAX package, the same math as k single steps) runs
its steps one at a time.  Checkpoints, resume, preemption, fake and
synthetic data, and the train-time augmentations wait for ROADMAP.md
queues 1 and 3 and raise ``NotImplementedError`` when asked for.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from datetime import datetime
from typing import Optional

import numpy as np

from ..config import Config
from ..data.pipeline import raw_device_batches
from ..data.preprocess import preprocess_batch
from ..data.rhd import RHDDataset
from ..device import resolve_device
from ..models import build_model
from .state import create_train_state
from .steps import make_fused_eval_step, make_fused_train_step

AUG_FLAGS = ("hue_aug", "coord_uv_noise", "crop_center_noise",
             "crop_scale_noise", "crop_offset_noise", "scoremap_dropout")


def _check_supported(cfg: Config):
    if cfg.scale_to_size or cfg.random_crop_to_size:
        # as the JAX Worker: both transforms replace the sample dict with
        # one no model can take
        raise ValueError(
            "scale_to_size / random_crop_to_size produce reduced dataset "
            "outputs incompatible with training")
    aug = [f for f in AUG_FLAGS if getattr(cfg, f)]
    if aug:
        raise NotImplementedError(
            f"{aug}: the train-time augmentations wait for ROADMAP.md "
            "queue 1")
    if cfg.resume_weight_path or cfg.finetune:
        raise NotImplementedError(
            "resume and finetune need checkpoints, which wait for "
            "ROADMAP.md queue 3; start from --weights instead")
    if cfg.use_fake_data or cfg.dataset_name == "synthetic":
        raise NotImplementedError(
            "fake and synthetic data wait for ROADMAP.md queue 3; write an "
            "RHD tree with data.write_synthetic_rhd instead")
    if cfg.dataset_name != "RHD":
        raise NotImplementedError(
            f"dataset {cfg.dataset_name!r} waits for ROADMAP.md queue 1; "
            "this slice trains on RHD")


def make_run_dir(cfg: Config) -> str:
    """``<save_log_dir>/<model>/<dataset>/run_<timestamp>`` with the
    config as ``config.json``, as the JAX package lays it out."""
    ts = datetime.now().strftime("%Y-%m-%d-%H-%M-%S-%f")
    run_dir = os.path.join(cfg.save_log_dir, cfg.model_name,
                           cfg.dataset_name, f"run_{ts}")
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)
    return run_dir


class Worker:
    """Epoch-loop trainer on the card (``device=None``) or, when asked
    for, the host (``device="cpu"``).  ``weights`` is what the Evaluator
    takes: None (the seeded init), an ``.npz`` path or a mapping of
    flattened flax variables."""

    def __init__(self, cfg: Config, run_dir: Optional[str] = None,
                 weights=None, device=None):
        # the infer package imports the train steps; import it here
        from ..infer.evaluator import load_weights, serving_kwargs
        _check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = load_weights(build_model(cfg), weights).to(self.device)
        train_split = ("evaluation" if cfg.use_val_dataset_to_debug
                       else "training")
        size = cfg.image_size[0]
        self.train_ds = RHDDataset(cfg.dataset_root_dir, train_split,
                                   image_size=size)
        self.val_ds = RHDDataset(cfg.dataset_root_dir, "evaluation",
                                 image_size=size)
        self.steps_per_epoch = max(len(self.train_ds) // cfg.batch_size, 1)
        self.state = create_train_state(self.model, cfg, self.steps_per_epoch)
        pp_kwargs = serving_kwargs(cfg)
        self.train_step = make_fused_train_step(self.model, cfg,
                                                preprocess_batch, pp_kwargs)
        self.eval_step = make_fused_eval_step(self.model, cfg,
                                              preprocess_batch, pp_kwargs)
        self.run_dir = run_dir if run_dir is not None else make_run_dir(cfg)
        os.makedirs(self.run_dir, exist_ok=True)
        self.log_path = os.path.join(self.run_dir, "log.txt")
        self.best_mpjpe = float(np.inf)
        self.step_seconds: list = []     # host time of each train step
        self.text(f"training {cfg.model_name} on {self.device}: "
                  f"{len(self.train_ds)} {train_split} samples, batch "
                  f"{cfg.batch_size}, {self.steps_per_epoch} steps per "
                  f"epoch, bn_variance {cfg.bn_mode}, compute "
                  f"{cfg.compute_dtype}")
        if cfg.steps_per_dispatch > 1:
            self.text(f"steps_per_dispatch={cfg.steps_per_dispatch}: the "
                      "port runs the steps of a group one at a time (the "
                      "same math)")
        self.text("checkpoints are not written: they wait for ROADMAP.md "
                  "queue 3")

    def text(self, info: str):
        """Print a log line and append it to ``<run_dir>/log.txt``."""
        print(info, flush=True)
        with open(self.log_path, "a") as f:
            f.write(info + "\n")

    def enable_preemption_save(self, guard=None):
        raise NotImplementedError("preemption-safe training waits for "
                                  "ROADMAP.md queue 3")

    def _finish_train_metrics(self, metrics: dict, epoch: int, idx: int,
                              losses_acc: dict):
        """NaN abort, loss accumulation and periodic logging of a step."""
        if self.cfg.nan_check:
            loss_val = float(metrics["loss"])
            if not np.isfinite(loss_val):
                self.text(f"FATAL: non-finite loss {loss_val} at epoch "
                          f"{epoch} iter {idx}; aborting")
                raise FloatingPointError(
                    f"non-finite training loss at epoch {epoch} iter {idx}")
        for k, v in metrics.items():
            losses_acc[k] = losses_acc.get(k, 0.0) + float(v)
        every = self.cfg.log_every_steps
        if every and idx % every == 0:
            terms = ", ".join(f"{k}: {float(v):.5f}"
                              for k, v in metrics.items())
            self.text(f"  epoch {epoch:03d} iter {idx:05d}/"
                      f"{self.steps_per_epoch:05d} | {terms}")

    def run_epoch(self, epoch: int, split: str,
                  fast_debug: bool = False) -> Optional[float]:
        """One pass over ``split`` ('training' or 'validation'); returns
        the validation MPJPE (None for training, or when no joint was
        visible)."""
        cfg = self.cfg
        is_train = split == "training"
        ds = self.train_ds if is_train else self.val_ds
        shuffle = is_train and cfg.shuffle \
            and not cfg.use_val_dataset_to_debug
        batches = raw_device_batches(
            ds, cfg.batch_size, self.device, shuffle=shuffle,
            seed=cfg.seed * 100003 + epoch, drop_remainder=is_train,
            depth=max(cfg.prefetch_depth, 2))
        losses_acc: dict = {}
        mpjpe_sum = mpjpe_count = 0.0
        n = 0
        for idx, raw in enumerate(batches):
            if fast_debug and idx > 2:
                break
            if is_train:
                t0 = time.perf_counter()
                self.state, metrics = self.train_step(self.state, raw)
                self._finish_train_metrics(metrics, epoch, idx, losses_acc)
                self.step_seconds.append(time.perf_counter() - t0)
            else:
                metrics = self.eval_step(raw)
                mpjpe_sum += float(metrics["mpjpe_sum"])
                mpjpe_count += float(metrics["mpjpe_count"])
                for k, v in metrics.items():
                    if k not in ("mpjpe_sum", "mpjpe_count"):
                        losses_acc[k] = losses_acc.get(k, 0.0) + float(v)
            n += 1
        means = {k: v / max(n, 1) for k, v in losses_acc.items()}
        epoch_mpjpe = None
        if not is_train and mpjpe_count:
            epoch_mpjpe = mpjpe_sum / mpjpe_count
        tag = "Training" if is_train else "Validation"
        info = f"{tag} Epoch: {epoch:03d}, " + ", ".join(
            f"{k}: {v:.5f}" for k, v in means.items())
        if epoch_mpjpe is not None:
            info += f", MPJPE: {epoch_mpjpe:.5f}"
        self.text(info)
        return epoch_mpjpe

    def run(self, fast_debug: bool = False,
            max_epoch: Optional[int] = None) -> float:
        """Train/validate each epoch; returns the best validation MPJPE."""
        end = max_epoch if max_epoch is not None else self.cfg.max_epoch
        for epoch in range(end):
            self.run_epoch(epoch, "training", fast_debug)
            val = self.run_epoch(epoch, "validation", fast_debug)
            if val is not None and val < self.best_mpjpe:
                self.best_mpjpe = val
        return self.best_mpjpe
