"""Per-channel shifted moments, the reduction of train-mode BatchNorm.

Port of ``handpose_tpu/ops/pallas_kernels.py:333-359``
(``fused_shifted_moments``): over the rows of an (N, C) view of ``x``,

    s  = sum(x - shift)          ss = sum((x - shift)^2)

each element converted to float32 before the subtraction, both sums in
float32.  :func:`shifted_moments` is the plain version;
:func:`fused_shifted_moments` is differentiable and, on a CUDA tensor,
computes the sums with the hand-written kernel (``csrc/moments.cu``, via
``ops/moments_cuda.py``).  Its backward is the JAX custom VJP's formula,
a plain torch expression as in the JAX package:

    dx     = gs + 2 (x - shift) gss          (cast to x's dtype)
    dshift = -n gs - 2 s gss
"""

from __future__ import annotations

from typing import Tuple

import torch


def rows_view(x: torch.Tensor) -> torch.Tensor:
    """The (N, C) row view of a BatchNorm input: a (B, C) tensor as it
    is, a (B, C, H, W) tensor in channels_last memory as the (B·H·W, C)
    view of that memory (no copy).  Raises on any other layout: the
    caller converts explicitly."""
    if x.ndim == 2:
        if not x.is_contiguous():
            raise ValueError("a (B, C) input must be contiguous")
        return x
    if x.ndim == 4:
        if not x.is_contiguous(memory_format=torch.channels_last):
            raise ValueError("a (B, C, H, W) input must be in channels_last "
                             "memory")
        return x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])
    raise ValueError(f"expected a 2-D or 4-D input, got {x.ndim}-D")


def shifted_moments(x2d: torch.Tensor,
                    shift: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (N, C) bf16 or f32 ``x2d`` and f32 (C,) ``shift`` ->
    (s, ss), two f32 (C,)."""
    d = x2d.to(torch.float32) - shift.to(torch.float32)
    return d.sum(0), (d * d).sum(0)


def _moments(x2d, shift):
    # the seam a caller patches to route the sums elsewhere
    from .moments_cuda import shifted_moments_cuda
    return shifted_moments_cuda(x2d, shift)


class FusedShiftedMoments(torch.autograd.Function):
    """(x2d, shift) -> (s, ss) with the JAX custom VJP's backward."""

    @staticmethod
    def forward(ctx, x2d, shift):
        ctx.set_materialize_grads(False)
        s, ss = _moments(x2d, shift)
        ctx.save_for_backward(x2d, shift, s)
        return s, ss

    @staticmethod
    def backward(ctx, gs, gss):
        x2d, shift, s = ctx.saved_tensors
        n = x2d.shape[0]
        dx = dshift = None
        if gss is not None:
            d = x2d.to(torch.float32) - shift
            dx = 2.0 * d * gss
            dshift = -2.0 * s * gss
        if gs is not None:
            dx = gs.expand_as(x2d) if dx is None else gs + dx
            ns = -float(n) * gs
            dshift = ns if dshift is None else ns + dshift
        if dx is not None:
            dx = dx.to(x2d.dtype)
        return dx, dshift


def fused_shifted_moments(x2d: torch.Tensor, shift: torch.Tensor):
    """Differentiable (s, ss) of :func:`shifted_moments`; the CUDA kernel
    computes the forward on the card."""
    return FusedShiftedMoments.apply(x2d, shift)
