"""Serving: raw batch -> preprocessing -> forward -> (xyz, uv).

Port of the body of ``handpose_tpu/infer/export.py:80-99``
(``export_fused_pipeline``), the program the JAX package serves: raw
samples in, absolute 3-D keypoints and their projections in crop pixels
out, on the ``is_inference=True`` model.  An RHD ``RawBatch`` or an
``InterHandRawBatch`` goes through its own preprocessing.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import Config
from ..data.preprocess import RawBatch, model_input, preprocess_fn_for
from ..device import resolve_device
from ..models import build_model
from ..utils.tracing import span
from .evaluator import Weights, load_weights, serving_kwargs


def load_serving_model(cfg: Config, weights: Weights = None, device=None):
    """The ``is_inference=True`` model with ``weights`` (or the seeded
    init) on ``device`` (default: the card)."""
    model = build_model(cfg, is_inference=True)
    return load_weights(model, weights).to(resolve_device(device))


@torch.inference_mode()
def serve(model, raw: RawBatch, cfg: Config,
          device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xyz (B, 21, 3), uv (B, 21, 2)) for a raw batch (``RawBatch`` or
    ``InterHandRawBatch``, of numpy arrays or
    tensors) on ``device`` (default: the card), where ``model`` lies.
    ``ThreeHandShapeAndPoseMANO`` has no uv (None) unless
    ``cfg.network_regress_uv``.  A stochastic model (DiffusionHandPose)
    draws from a generator seeded ``cfg.seed`` on every call, so serving
    is deterministic as the JAX export's fixed ``PRNGKey(cfg.seed)``
    makes it."""
    dev = resolve_device(device)
    with span("hp.serve.call"):
        with span("hp.serve.preprocess"):
            raw = raw.to(dev)
            sample = preprocess_fn_for(raw)(raw, **serving_kwargs(cfg))
            inp = model_input(sample, cfg.input_channels)
        with span("hp.serve.forward"):
            kw = {}
            if getattr(model, "stochastic", False):
                kw["generator"] = torch.Generator(device=dev).manual_seed(
                    cfg.seed)
            out = model(inp, sample["camera_intrinsic_matrix"],
                        sample["keypoint_scale"], sample["keypoint_xyz_root"],
                        **kw)
    return out.xyz, out.uv
