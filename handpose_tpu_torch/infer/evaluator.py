"""Evaluation harness: whole-split MPJPE over the RHD evaluation split.

Port of ``handpose_tpu/infer/evaluator.py`` on its fused RHD path.  For
trainer-B models (this slice: ``Hand3DPosePriorNetwork``) the metric is
the fused eval step on the model built with ``is_inference=False``, which
is what the JAX Worker's validation runs (``train/trainer.py:66,129``).
The JAX ``Evaluator`` builds the ``is_inference=True`` model instead, and
its metrics then read the ``can_xyz`` that branch does not return; the
port does not copy that.
"""

from __future__ import annotations

import os
import warnings
from typing import Mapping, Optional, Union

import numpy as np
import torch

from ..config import Config
from ..convert import load_flax_variables
from ..data.pipeline import raw_device_batches
from ..data.preprocess import preprocess_batch
from ..data.rhd import RHDDataset
from ..device import resolve_device
from ..models import build_model
from ..train.checkpoints import load_variables
from ..train.steps import make_fused_eval_step

Weights = Union[str, Mapping[str, np.ndarray], None]


def load_weights(model, weights: Weights):
    """``weights``: None (keep the seeded init), a path to an ``.npz`` of
    flattened flax variables, a checkpoint directory the Worker wrote
    (its ``variables.npz``), or such a mapping."""
    if weights is None:
        return model
    if isinstance(weights, str) and os.path.isdir(weights):
        weights = load_variables(weights)
    elif isinstance(weights, str):
        with np.load(weights) as f:
            weights = {k: f[k] for k in f.files}
    return load_flax_variables(model, weights)


def serving_kwargs(cfg: Config) -> dict:
    """The preprocessing arguments of the JAX Evaluator's fused path."""
    return dict(crop_size=cfg.crop_size, sigma=cfg.sigma,
                switch_joint_order=cfg.joint_order_switched)


class Evaluator:
    """``Evaluator(cfg, weights, device).evaluate()`` -> visible-joint
    MPJPE (mm) aggregated exactly over every sample of the split, the
    trailing partial batch included."""

    def __init__(self, cfg: Config, weights: Weights = None, device=None):
        if cfg.dataset_name != "RHD":
            raise NotImplementedError(
                f"dataset {cfg.dataset_name!r} waits for a later slice "
                "(ROADMAP.md, queue 1); this slice reads RHD")
        self.cfg = cfg
        self.device = resolve_device(device)
        model = build_model(cfg, is_inference=False)
        self.model = load_weights(model, weights).to(self.device)
        self.eval_step = make_fused_eval_step(self.model, cfg,
                                              preprocess_batch,
                                              serving_kwargs(cfg))
        self._ds: Optional[RHDDataset] = None

    def dataset(self) -> RHDDataset:
        if self._ds is None:
            self._ds = RHDDataset(self.cfg.dataset_root_dir, "evaluation",
                                  image_size=self.cfg.image_size[0])
        return self._ds

    def batches(self):
        return raw_device_batches(self.dataset(), self.cfg.infer_batch_size,
                                  self.device,
                                  depth=max(self.cfg.prefetch_depth, 2))

    def evaluate(self, max_batches: Optional[int] = None) -> float:
        """Whole-split visible-joint MPJPE; NaN (with a warning) when no
        joint is visible."""
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        count = torch.zeros((), dtype=torch.float64, device=self.device)
        for bi, raw in enumerate(self.batches()):
            if max_batches is not None and bi >= max_batches:
                break
            metrics = self.eval_step(raw)
            total += metrics["mpjpe_sum"].to(torch.float64)
            count += metrics["mpjpe_count"].to(torch.float64)
        total, count = float(total), float(count)
        if count:
            return total / count
        warnings.warn("evaluation saw no visible keypoints; "
                      "MPJPE is undefined (NaN)")
        return float("nan")
