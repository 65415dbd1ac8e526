"""Evaluation harness: whole-split MPJPE, PCK curve and AUC.

Port of ``handpose_tpu/infer/evaluator.py`` on its fused path, over the
RHD evaluation split or InterHand2.6M's ``cfg.interhand_eval_split``
(JAX :97-118), and its ``evaluate_full`` (:193-239).  For
trainer-B models (``Hand3DPosePriorNetwork``, ``Hand3DPoseNet``) the
metric is the fused eval step on the model built with
``is_inference=False``, which is what the JAX Worker's validation runs
(``train/trainer.py:66,129``).  The JAX ``Evaluator`` builds the
``is_inference=True`` model instead, and its metrics then read the
``can_xyz`` that branch does not return; the port does not copy that.
The trainer-A models are evaluated as built (``TwoDimHandPoseWithFK``
with ``is_inference=False``, whose ``xyz`` is the inference branch's);
``TwoDimHandPose`` has no 3-D output, so its PCK curve is zero and its
AUC 0, as in the JAX ``evaluate_full``.

With ``visualize_dir``, ``evaluate(visualize_first_n=n)`` writes the
first batch's first n crops with the ground truth in green and the
prediction in red over them (JAX ``_visualize``, :241-261) to
``visualize_dir/img/000_{i:03d}_pre.jpg``.  The JAX Evaluator takes that
uv from the ``is_inference=True`` model; the port's model is the
``is_inference=False`` one, so :func:`inference_uv` computes the
inference branch's uv from its output, with the same operations.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Mapping, Optional, Union

import numpy as np
import torch

from ..config import Config
from ..convert import load_flax_variables
from ..data.pipeline import open_dataset, raw_device_batches
from ..data.preprocess import preprocess_fn_for
from ..data.synthetic import fake_sample_batch
from ..device import resolve_device
from ..models import build_model, mano_source_of
from ..ops.projection import batch_project_xyz_to_uv, rel_normed_to_absolute
from ..train.checkpoints import load_variables
from ..train.steps import (_TRAINER_B, forward, make_eval_step,
                           make_fused_eval_step, pass_draws)

Weights = Union[str, Mapping[str, np.ndarray], None]
DATASETS = ("RHD", "InterHand2.6M", "synthetic")
FAKE_BATCHES = 3
# the standard RHD protocol: PCK over 20-50 mm, 31 thresholds
PCK_THRESHOLDS = np.linspace(0.02, 0.05, 31)


def model_name_from_path(ckpt_path: str) -> str:
    """``logs/<model>/<dataset>/run_<ts>/<ckpt>`` -> ``<model>``
    (``handpose_tpu/infer/evaluator.py:35-39``, reference
    inference.py:38)."""
    parts = os.path.normpath(ckpt_path).split(os.sep)
    return parts[-4] if len(parts) >= 4 else parts[0]


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


def _check_mano(cfg: Config, weights: Weights) -> None:
    """Warn when a checkpoint's run trained on another MANO than the one
    ``cfg`` loads: the MANO constants are not in the checkpoint, and the
    metrics would silently change with them."""
    mano = mano_source_of(cfg)
    if mano is None or not isinstance(weights, str):
        return
    prov = os.path.join(os.path.dirname(os.path.abspath(weights)),
                        "provenance.json")
    if not os.path.exists(prov):
        return
    with open(prov) as f:
        trained = json.load(f).get("mano")
    if trained is not None and trained != mano:
        warnings.warn(f"{weights} was trained with MANO {trained}; this "
                      f"evaluation loads {mano}")


def inference_uv(cfg: Config, out, sample: dict):
    """The (B, 21, 2) uv that the ``is_inference=True`` model returns,
    from the output of the ``is_inference=False`` one on ``sample``: the
    trainer-B models project their absolute coords, built from the
    predicted root-relative ones; ``TwoDimHandPoseWithFK`` projects its
    FK xyz; the other models return one uv in both branches (None for
    ``ThreeHandShapeAndPoseMANO`` without ``network_regress_uv``)."""
    K = sample["camera_intrinsic_matrix"]
    if cfg.model_name in _TRAINER_B:
        xyz = rel_normed_to_absolute(out.coord_xyz_rel_normed,
                                     sample["keypoint_scale"],
                                     sample["keypoint_xyz_root"])
        return batch_project_xyz_to_uv(xyz, K)
    if cfg.model_name == "TwoDimHandPoseWithFK":
        return batch_project_xyz_to_uv(out.xyz, K)
    return out.uv


def serving_kwargs(cfg: Config) -> dict:
    """The preprocessing arguments of the JAX Evaluator's fused path."""
    return dict(crop_size=cfg.crop_size, sigma=cfg.sigma,
                switch_joint_order=cfg.joint_order_switched)


class Evaluator:
    """``Evaluator(cfg, weights, device).evaluate()`` -> visible-joint
    MPJPE (mm) aggregated exactly over every sample of the split, the
    trailing partial batch included; ``evaluate_full()`` adds the PCK
    curve and its 20-50 mm AUC.  ``cfg.compilation_cache_dir`` names
    where the native libraries are built and found
    (``utils.device_info.enable_compilation_cache``)."""

    def __init__(self, cfg: Config, weights: Weights = None, device=None,
                 visualize_dir: Optional[str] = None):
        if cfg.dataset_name not in DATASETS:
            raise ValueError(f"dataset {cfg.dataset_name!r} not in "
                             f"{DATASETS}")
        self.cfg = cfg
        self.device = resolve_device(device)
        if cfg.compilation_cache_dir:
            from ..utils.device_info import enable_compilation_cache
            enable_compilation_cache(cfg.compilation_cache_dir)
        self.visualize_dir = visualize_dir
        if visualize_dir:
            os.makedirs(os.path.join(visualize_dir, "img"), exist_ok=True)
        model = build_model(cfg, is_inference=False)
        self.model = load_weights(model, weights).to(self.device)
        _check_mano(cfg, weights)
        # synthetic data: fake sample dicts through the non-fused step
        self.fused = not (cfg.use_fake_data
                          or cfg.dataset_name == "synthetic")
        self.eval_step = self._make_step(None)
        # evaluate_full's steps, one per thresholds tuple
        self._pck_steps: dict = {}
        self._ds = None

    def dataset(self):
        """The evaluation split, opened once (an InterHand parse is
        minutes of json work on the full dataset)."""
        if self._ds is None:
            cfg = self.cfg
            self._ds = open_dataset(
                cfg, cfg.interhand_eval_split
                if cfg.dataset_name == "InterHand2.6M" else "evaluation")
        return self._ds

    def _make_step(self, pck_thresholds):
        if not self.fused:
            return make_eval_step(self.model, self.cfg, pck_thresholds)
        # preprocessing=None: the step takes the raw batch's own
        return make_fused_eval_step(self.model, self.cfg, None,
                                    serving_kwargs(self.cfg), pck_thresholds)

    def batches(self):
        """Raw batches on the device, or for synthetic data the JAX
        Evaluator's three fake sample dicts."""
        cfg = self.cfg
        if not self.fused:
            return ({k: v.to(self.device) for k, v in fake_sample_batch(
                min(cfg.infer_batch_size, 8), cfg.crop_size,
                cfg.input_channels, seed=i).items()}
                for i in range(FAKE_BATCHES))
        return raw_device_batches(self.dataset(), cfg.infer_batch_size,
                                  self.device,
                                  depth=max(cfg.prefetch_depth, 2))

    def evaluate(self, max_batches: Optional[int] = None,
                 visualize_first_n: int = 0) -> float:
        """Whole-split visible-joint MPJPE; NaN (with a warning) when no
        joint is visible.  With ``visualize_dir`` set, the first batch's
        first ``visualize_first_n`` overlays are written."""
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        count = torch.zeros((), dtype=torch.float64, device=self.device)
        draws = pass_draws(self.model, self.cfg, self.device)
        for bi, raw in enumerate(self.batches()):
            if max_batches is not None and bi >= max_batches:
                break
            metrics = self.eval_step(raw, **draws)
            total += metrics["mpjpe_sum"].to(torch.float64)
            count += metrics["mpjpe_count"].to(torch.float64)
            if self.visualize_dir and bi == 0 and visualize_first_n:
                self._visualize(raw, visualize_first_n, bi)
        return _mpjpe(float(total), float(count))

    @torch.inference_mode()
    def _visualize(self, batch, n: int, batch_idx: int) -> None:
        """Overlays of the first ``n`` samples of ``batch`` (a raw batch,
        or a sample dict for synthetic data): the crop, the ground-truth
        uv in green and the predicted uv in red, joints in MANO order,
        written to ``visualize_dir/img/{batch:03d}_{i:03d}_pre.jpg``; none
        for a model without uv.  A stochastic model draws as the pass's
        first batch did."""
        from ..utils.vis import plot_pred_vs_gt, save_image, to_uint8_image
        cfg = self.cfg
        sample = (preprocess_fn_for(batch)(batch, **serving_kwargs(cfg))
                  if self.fused else batch)
        out = forward(self.model, sample, cfg,
                      **pass_draws(self.model, cfg, self.device))
        uv = inference_uv(cfg, out, sample)
        if uv is None:
            return
        n = min(n, uv.shape[0])
        pred_uv = uv[:n].float().cpu().numpy()
        imgs = sample["image_crop"][:n].float().cpu().numpy()
        gt_uv = sample["keypoint_uv21"][:n].float().cpu().numpy()
        vis = sample["keypoint_vis21"][:n].cpu().numpy()
        for i in range(n):
            img = plot_pred_vs_gt(to_uint8_image(imgs[i]), pred_uv[i],
                                  gt_uv[i], vis[i])
            save_image(os.path.join(self.visualize_dir, "img",
                                    f"{batch_idx:03d}_{i:03d}_pre.jpg"), img)

    def _pck_step(self, ts: np.ndarray):
        key = tuple(ts.tolist())
        if key not in self._pck_steps:
            self._pck_steps[key] = self._make_step(torch.as_tensor(
                ts, dtype=torch.float32, device=self.device))
        return self._pck_steps[key]

    def evaluate_full(self, max_batches: Optional[int] = None,
                      thresholds=None) -> dict:
        """MPJPE plus the PCK curve over ``thresholds`` (metres; default
        ``linspace(0.02, 0.05, 31)``) and its trapezoid AUC over the
        thresholds' span, from one forward per batch; sums and counts
        aggregate exactly in float64 (JAX ``evaluator.py:208-239``).
        Returns ``{"mpjpe", "pck_thresholds", "pck", "auc_20_50mm"}``."""
        ts = np.asarray(PCK_THRESHOLDS if thresholds is None
                        else thresholds, np.float64)
        step = self._pck_step(ts)
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        count = torch.zeros((), dtype=torch.float64, device=self.device)
        correct = torch.zeros(ts.shape[0], dtype=torch.float64,
                              device=self.device)
        n = torch.zeros((), dtype=torch.float64, device=self.device)
        draws = pass_draws(self.model, self.cfg, self.device)
        for bi, raw in enumerate(self.batches()):
            if max_batches is not None and bi >= max_batches:
                break
            m = step(raw, **draws)
            total += m["mpjpe_sum"].to(torch.float64)
            count += m["mpjpe_count"].to(torch.float64)
            if "pck_correct_sum" in m:
                correct += m["pck_correct_sum"].to(torch.float64)
                n += m["pck_count"].to(torch.float64)
        n = float(n)
        curve = correct.cpu().numpy() / n if n else np.zeros(ts.shape[0])
        auc = (float(np.trapezoid(curve, ts) / (ts[-1] - ts[0]))
               if n else 0.0)
        return {"mpjpe": _mpjpe(float(total), float(count)),
                "pck_thresholds": ts, "pck": curve, "auc_20_50mm": auc}


def _mpjpe(total: float, count: float) -> float:
    """The split's MPJPE from its sums; NaN, with a warning, when no joint
    was visible (0.0 would read as a perfect score)."""
    if count:
        return total / count
    warnings.warn("evaluation saw no visible keypoints; "
                  "MPJPE is undefined (NaN)")
    return float("nan")
