"""BatchNorm's normalisation with its residual add and ReLU: the plain
expression, the CUDA kernel of eval mode (``csrc/bn_apply.cu``) and its
registered operator.

:func:`bn_apply` is the plain PyTorch expression every BatchNorm of the
port applies (``handpose_tpu/nn/norm.py``, flax ``nn.BatchNorm`` and
``ShiftedBatchNorm``), in float32 and cast to the compute dtype, then the
block's ``residual + y`` and ``relu`` where asked:

    y = (x - mean) * (rsqrt(var + eps) * weight) + bias

with 'shifted' casting ``x - mean``, the multiplier and the bias to the
compute dtype before the affine step.  It is differentiable; train mode
runs it with the batch statistics.

Eval mode with the running statistics, under no gradient, on a
(B, C, H, W) input goes through the operator
``torch.ops.handpose_tpu_torch.bn_eval_apply`` (a
``torch.library.custom_op`` with a fake function that gives the output's
shape, dtype and layout, so ``torch.export`` records one call of it per
BatchNorm).  The operator dispatches on x's device:

* host tensors go to :func:`bn_apply`, whatever their layout;
* CUDA tensors launch the kernel, which repeats the expression's every
  rounding, or raise: a layout, dtype or width it cannot take is an
  error, not a fallback;
* any other device raises.

Importing this module (``handpose_tpu_torch.ops`` does) registers the
operator.  ``KERNEL.launches`` counts the kernel's launches and nothing
else.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import cuda_build

SOURCE = "bn_apply"
EPSILON = 1e-5
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def bn_apply(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
             weight: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype,
             shifted: bool = False, residual: Optional[torch.Tensor] = None,
             relu: bool = False) -> torch.Tensor:
    """Plain version: (B, C[, H, W]) ``x``, float32 (C,) statistics and
    affine parameters -> ``dtype``, then ``residual + y`` and ``relu``."""
    shape = (1, -1) + (1,) * (x.ndim - 2)
    mul = (torch.rsqrt(var + EPSILON) * weight).reshape(shape)
    y = x.to(torch.float32) - mean.reshape(shape)
    b = bias.reshape(shape)
    if shifted:
        # ShiftedBatchNorm casts y, mul and bias to the compute dtype
        # before the affine step (handpose_tpu/nn/norm.py:121-125)
        y, mul, b = (t.to(dtype) for t in (y, mul, b))
    y = (y * mul + b).to(dtype)
    if residual is not None:
        y = residual + y
    return F.relu(y) if relu else y


def _rows(t: torch.Tensor, what: str) -> None:
    if t.ndim != 4 or not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{what} must be a (B, C, H, W) tensor in "
                         f"channels_last memory; got shape {tuple(t.shape)}, "
                         f"strides {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{what} must be 16-byte aligned")


class BnApplyKernel:
    """The loaded library and the launch count."""

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _entry(self):
        if self._fn is None:
            fn = cuda_build.load(SOURCE).hpt_bn_apply
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, x, mean, var, weight, bias, residual, relu, shifted):
        _rows(x, "x")
        dtype = _DTYPES.get(x.dtype)
        if dtype is None:
            raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
        C = x.shape[1]
        if C % 8:
            raise ValueError(f"C={C} is not a multiple of 8")
        for name, t in (("mean", mean), ("var", var), ("weight", weight),
                        ("bias", bias)):
            if t.dtype != torch.float32 or t.shape != (C,) \
                    or not t.is_contiguous():
                raise ValueError(f"{name} must be a contiguous float32 ({C},)")
            if t.device != x.device:
                raise ValueError(f"x and {name} lie on different devices")
        if residual is not None:
            _rows(residual, "residual")
            if residual.shape != x.shape or residual.dtype != x.dtype:
                raise ValueError(
                    f"residual {tuple(residual.shape)} {residual.dtype} "
                    f"must match x {tuple(x.shape)} {x.dtype}")
            if residual.device != x.device:
                raise ValueError("x and residual lie on different devices")
        y = torch.empty_like(x)
        if y.numel() == 0:
            return y
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = self._entry()(
                x.data_ptr(), None if residual is None else residual.data_ptr(),
                y.data_ptr(), dtype, mean.data_ptr(), var.data_ptr(),
                weight.data_ptr(), bias.data_ptr(), y.numel() // C, C,
                int(relu), int(shifted), stream)
        if err != 0:
            raise RuntimeError(f"bn_apply kernel launch failed: CUDA error "
                               f"{err}")
        self.launches += 1
        return y


KERNEL = BnApplyKernel()

OP_NAME = "handpose_tpu_torch::bn_eval_apply"


@torch.library.custom_op(OP_NAME, mutates_args=())
def bn_eval_apply(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                  weight: torch.Tensor, bias: torch.Tensor,
                  residual: Optional[torch.Tensor], relu: bool,
                  shifted: bool, dtype: torch.dtype) -> torch.Tensor:
    """The registered operator: eval-mode BatchNorm of a (B, C, H, W)
    ``x`` with float32 (C,) running statistics and affine parameters, in
    ``dtype`` and x's layout, then ``residual + y`` and ``relu``.  The
    kernel writes x's dtype: on the card x must be in ``dtype`` and in
    channels_last memory."""
    if x.device.type == "cpu":
        return bn_apply(x, mean, var, weight, bias, dtype, shifted,
                        residual, relu)
    if x.device.type != "cuda":
        raise ValueError(f"no bn_apply kernel for device {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"x is {x.dtype}; the kernel writes x's dtype, "
                         f"and this BatchNorm computes in {dtype}")
    return KERNEL(x, mean, var, weight, bias, residual, relu, shifted)


@bn_eval_apply.register_fake
def _bn_eval_apply_fake(x, mean, var, weight, bias, residual, relu, shifted,
                        dtype):
    return torch.empty_like(x, dtype=dtype)
