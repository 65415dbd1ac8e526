"""Serving artifacts: the inference forward and the fused serving
pipeline as ``torch.export`` programs, weights included.

Port of ``handpose_tpu/infer/export.py``, whose ``jax.export`` artifacts a
serving process runs without the model zoo, the config or the checkpoint
code.  Here an artifact is a ``torch.export`` program saved as ``.pt2``
bytes:

    blob = export_forward(cfg, weights, batch_size)      # bytes
    fn = load_exported(blob)                             # callable
    xyz, uv = fn(images, K, scale, root)

It is exported on the device it will run on (default: the card), and
runs there.  The scoremap kernel enters the fused pipeline as one call of
its registered operator ``torch.ops.handpose_tpu_torch.render_gaussian_maps``
(``ops/scoremap_cuda.py``), so a replay on the card launches the CUDA
kernel.  Loading needs that operator registered, and nothing else of the
package: the loaders import ``handpose_tpu_torch.ops`` (no model, config
or training module), which is the closest counterpart of the JAX
artifact's framework-free StableHLO load.  Export itself builds the model
and imports what that needs.

A model without xyz or uv returns zeros in its place, as in JAX.
``DiffusionHandPose`` draws x_T (and, for DDPM or DDIM with eta != 0, the
sampler's step noise) from a generator seeded ``cfg.seed``; a generator
cannot enter a program, so those draws are made at export time, at the
export's batch and on its device, as ``serve`` makes them, and enter the
program as constants: the artifact gives what ``serve`` gives on the same
inputs.  The sampler's loop is one ``scan`` in the program
(``nn/diffusion.py``).
"""

from __future__ import annotations

import io
from typing import Tuple

import torch
from torch import nn


def _xyz_uv(out, batch_size: int, keypoints: int, device):
    """The output's (xyz, uv), zeros where the model has none."""
    xyz = out.xyz if out.xyz is not None else torch.zeros(
        (batch_size, keypoints, 3), device=device)
    uv = out.uv if out.uv is not None else torch.zeros(
        (batch_size, keypoints, 2), device=device)
    return xyz, uv


def baked_draws(model, cfg, batch_size: int, device) -> dict:
    """The keyword draws that make a stochastic model's forward at
    ``batch_size`` give what it gives on a generator seeded ``cfg.seed``
    (``serve``'s): x_T as ``init_noise`` (B, 1, 63), then, where the
    sampler draws step noise, ``step_noise`` (S, B, 1, 63), drawn in the
    generator's order.  Empty for a deterministic model."""
    if not getattr(model, "stochastic", False):
        return {}
    diff = model.diff_model.diffusion
    g = torch.Generator(device=device).manual_seed(cfg.seed)
    shape = (batch_size, diff.seq_length, diff.channels)

    def draw():
        return torch.randn(shape, generator=g, device=device,
                           dtype=torch.float32)

    draws = {"init_noise": draw().transpose(1, 2)}
    if not diff.is_ddim_sampling:
        n_steps = diff.num_timesteps
    elif diff.eta != 0.0:
        n_steps = diff.sampling_timesteps
    else:
        return draws
    draws["step_noise"] = torch.stack([draw() for _ in range(n_steps)]
                                      ).transpose(2, 3)
    return draws


class _Baked(nn.Module):
    """The model with its draws as buffers, which export stores in the
    program."""

    def __init__(self, model, cfg, draws: dict):
        super().__init__()
        self.model = model
        self.keypoints = cfg.keypoint_num
        self.draw_names = tuple(draws)
        for k, v in draws.items():
            self.register_buffer(k, v.contiguous())

    def predict(self, img, K, scale, root):
        out = self.model(img, K, scale, root,
                         **{k: getattr(self, k) for k in self.draw_names})
        return _xyz_uv(out, img.shape[0], self.keypoints, img.device)


class _Forward(_Baked):
    def forward(self, img, K, scale, root):
        return self.predict(img, K, scale, root)


class _Pipeline(_Baked):
    def __init__(self, model, cfg, draws: dict):
        super().__init__(model, cfg, draws)
        from .evaluator import serving_kwargs
        self.pp_kwargs = serving_kwargs(cfg)
        self.input_channels = cfg.input_channels

    def forward(self, image, mask, keypoint_uv, keypoint_vis, keypoint_xyz,
                camera_K):
        from ..data.preprocess import RawBatch, model_input, preprocess_batch
        raw = RawBatch(image, mask, keypoint_uv, keypoint_vis, keypoint_xyz,
                       camera_K)
        sample = preprocess_batch(raw, **self.pp_kwargs)
        return self.predict(model_input(sample, self.input_channels),
                            sample["camera_intrinsic_matrix"],
                            sample["keypoint_scale"],
                            sample["keypoint_xyz_root"])


def _serving_model(cfg, weights, device, mano):
    from ..device import resolve_device
    from ..models import build_model
    from .evaluator import load_weights
    dev = resolve_device(device)
    model = load_weights(build_model(cfg, is_inference=True, mano=mano),
                         weights).to(dev)
    return model.eval(), dev


def _export(module: nn.Module, args) -> bytes:
    with torch.no_grad():
        program = torch.export.export(module, args)
    # the placeholder inputs would be saved with the program (at b256 the
    # raw images alone are ~100 MB); loading does not need them
    program.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_forward(cfg, weights=None, batch_size: int = 1, device=None,
                   mano=None) -> bytes:
    """The ``is_inference=True`` forward of ``cfg``'s model with
    ``weights`` (what the Evaluator takes: None for the seeded init, an
    ``.npz``, a checkpoint directory or a mapping) as ``.pt2`` bytes,
    exported on ``device`` (default: the card).  Inputs: images
    (B, H, W, C), K (B, 3, 3), scale (B, 1), root (B, 3), float32;
    outputs: (xyz (B, 21, 3), uv (B, 21, 2))."""
    model, dev = _serving_model(cfg, weights, device, mano)
    H, W = cfg.input_img_shape
    B = batch_size
    args = (torch.zeros((B, H, W, cfg.input_channels), device=dev),
            torch.eye(3, device=dev).expand(B, 3, 3).contiguous(),
            torch.ones((B, 1), device=dev), torch.zeros((B, 3), device=dev))
    return _export(_Forward(model, cfg, baked_draws(model, cfg, B, dev)),
                   args)


def export_fused_pipeline(cfg, weights=None, batch_size: int = 1,
                          image_size: Tuple[int, int] = (320, 320),
                          device=None, mano=None) -> bytes:
    """The fused serving program as ``.pt2`` bytes: an RHD raw batch ->
    the device preprocessing (dominant hand, crop, intrinsics, the
    scoremaps through the kernel's operator) -> the forward.  Inputs, as
    the JAX artifact's: image uint8 (B, H, W, 3), mask uint8 (B, H, W),
    keypoint_uv (B, 42, 2), keypoint_vis (B, 42), keypoint_xyz (B, 42, 3)
    and K (B, 3, 3), float32; outputs (xyz (B, 21, 3), uv (B, 21, 2))."""
    model, dev = _serving_model(cfg, weights, device, mano)
    H, W = image_size
    B = batch_size
    K = torch.tensor([[W, 0.0, W / 2], [0.0, H, H / 2], [0.0, 0.0, 1.0]],
                     device=dev).expand(B, 3, 3).contiguous()
    args = (torch.zeros((B, H, W, 3), dtype=torch.uint8, device=dev),
            torch.zeros((B, H, W), dtype=torch.uint8, device=dev),
            torch.zeros((B, 42, 2), device=dev),
            torch.ones((B, 42), device=dev),
            torch.ones((B, 42, 3), device=dev), K)
    return _export(_Pipeline(model, cfg, baked_draws(model, cfg, B, dev)),
                   args)


def _load(f):
    """An artifact's callable (:func:`_callable`); registers the scoremap
    operator first."""
    from .. import ops  # noqa: F401  (registers the operator)
    return _callable(torch.export.load(f))


def _callable(program):
    """A loaded program's callable, which casts each input to the dtype
    and device the program was exported with (as the JAX loaders
    cast)."""
    names = set(program.graph_signature.user_inputs)
    specs = [n.meta["val"] for n in program.graph.nodes
             if n.op == "placeholder" and n.name in names]
    module = program.module()

    def fn(*args):
        args = [torch.as_tensor(a).to(device=s.device, dtype=s.dtype)
                for a, s in zip(args, specs)]
        with torch.no_grad():
            return module(*args)

    return fn


def load_exported(blob: bytes):
    """An ``export_forward`` artifact as ``fn(img, K, scale, root) ->
    (xyz, uv)``."""
    return _load(io.BytesIO(blob))


def load_exported_pipeline(blob: bytes):
    """An ``export_fused_pipeline`` artifact as ``fn(image, mask,
    keypoint_uv, keypoint_vis, keypoint_xyz, K) -> (xyz, uv)``."""
    return _load(io.BytesIO(blob))


def save_exported(path: str, blob: bytes) -> None:
    with open(path, "wb") as f:
        f.write(blob)


def load_exported_file(path: str):
    """An artifact file (either kind) as its callable."""
    with open(path, "rb") as f:
        return _load(io.BytesIO(f.read()))
