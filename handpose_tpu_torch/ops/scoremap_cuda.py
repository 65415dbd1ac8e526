"""Wrapper of the CUDA scoremap kernel (``csrc/scoremap.cu``).

Replaces ``handpose_tpu/ops/pallas_kernels.py:render_gaussian_maps_pallas``.
The kernel is registered as the PyTorch operator
``torch.ops.handpose_tpu_torch.render_gaussian_maps`` (a
``torch.library.custom_op`` with a fake function that gives the output's
shape), so ``torch.export`` records one call of it in an exported program
instead of tracing into its body, and the program runs the kernel when it
is replayed on the card.  The operator dispatches on the coordinates'
device:

* host tensors go to the plain
  :func:`handpose_tpu_torch.ops.heatmap.render_gaussian_maps`;
* CUDA tensors launch the kernel, or raise: there is no fallback;
* any other device raises.

:func:`render_gaussian_maps_cuda` takes the plain version's arguments and
calls the operator.  Importing this module (``handpose_tpu_torch.ops``
does) registers the operator; a process that loads an exported program
must import it first.  ``KERNEL.launches`` counts the kernel's launches
and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .heatmap import inv_sigma_sq, render_gaussian_maps

SOURCE = "scoremap"


class ScoremapKernel:
    """The loaded library and the launch count."""

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _entry(self):
        if self._fn is None:
            fn = cuda_build.load(SOURCE).hpt_scoremap_f32
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, coords_hw: torch.Tensor, output_size, sigma: float,
                 valid: torch.Tensor) -> torch.Tensor:
        H, W = (int(s) for s in output_size)
        if coords_hw.ndim != 3 or coords_hw.shape[-1] != 2:
            raise ValueError(f"coords must be (B, K, 2), got {tuple(coords_hw.shape)}")
        B, K = coords_hw.shape[:2]
        if coords_hw.dtype != torch.float32 or not coords_hw.is_contiguous():
            raise ValueError("coords must be contiguous float32")
        if valid is None or valid.dtype != torch.bool or not valid.is_contiguous():
            raise ValueError("visibility must be a contiguous bool tensor")
        if valid.numel() != B * K:
            raise ValueError(f"visibility has {valid.numel()} entries, want {B * K}")
        if valid.device != coords_hw.device:
            raise ValueError("coords and visibility lie on different devices")
        if H <= 0 or W <= 0:
            raise ValueError(f"output size must be positive, got {(H, W)}")
        out = torch.empty((B, K, H, W), dtype=torch.float32,
                          device=coords_hw.device)
        if B * K == 0:
            return out
        with torch.cuda.device(coords_hw.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = self._entry()(coords_hw.data_ptr(), valid.data_ptr(),
                                out.data_ptr(), B * K, H, W,
                                inv_sigma_sq(sigma), stream)
        if err != 0:
            raise RuntimeError(f"scoremap kernel launch failed: CUDA error {err}")
        self.launches += 1
        return out


KERNEL = ScoremapKernel()

OP_NAME = "handpose_tpu_torch::render_gaussian_maps"


@torch.library.custom_op(OP_NAME, mutates_args=())
def render_gaussian_maps_op(coords_hw: torch.Tensor, valid: torch.Tensor,
                            height: int, width: int,
                            sigma: float) -> torch.Tensor:
    """The registered operator: (B, K, 2) (row, col) coords, (B, K[,1])
    visibility -> (B, K, height, width) float32 maps."""
    if coords_hw.device.type == "cpu":
        return render_gaussian_maps(coords_hw, (height, width), sigma, valid)
    if coords_hw.device.type != "cuda":
        raise ValueError(f"no scoremap kernel for device {coords_hw.device}")
    return KERNEL(coords_hw, (height, width), sigma, valid)


@render_gaussian_maps_op.register_fake
def _render_gaussian_maps_fake(coords_hw, valid, height, width, sigma):
    return coords_hw.new_empty((coords_hw.shape[0], coords_hw.shape[1],
                                height, width), dtype=torch.float32)


def render_gaussian_maps_cuda(coords_hw: torch.Tensor,
                              output_size: tuple[int, int],
                              sigma: float,
                              valid: torch.Tensor) -> torch.Tensor:
    """(B, K, 2) (row, col) coords + (B, K[,1]) bool visibility ->
    (B, K, H, W) float32 maps through the registered operator: the kernel
    on the card, the plain version for host tensors."""
    H, W = (int(s) for s in output_size)
    return render_gaussian_maps_op(coords_hw, valid, H, W, float(sigma))
