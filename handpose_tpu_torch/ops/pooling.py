"""ResNet-stem max pool with its backward.

Port of ``handpose_tpu/ops/pooling.py:169-206``: 3x3 window, stride 2, one
pixel of padding that never wins, which is what ``F.max_pool2d(x, 3, 2,
1)`` computes forward.

The JAX package offers three gradient routes (``cfg.pool_grad``):
'native' (XLA's select-and-scatter), 'argmax' (a recomputed in-window
argmax) and 'pallas' (the TPU kernel ``max_pool_3x3s2p1_bwd_pallas``).
All three compute one gradient: each window's cotangent goes to the first
maximum of the window in row-major order, torch ``MaxPool2d``'s rule.
So the port has one backward, whatever ``pool_grad`` says (the config
still accepts only those three values): :func:`max_pool_3x3s2p1_bwd`
is its plain version, and on the card :func:`stem_max_pool` takes the
hand-written kernel (``csrc/pool_bwd.cu`` via ``ops/pool_bwd_cuda.py``).

The plain version computes what the TPU kernel does: the first-max tap
of every window, then the <= 4 terms of each input element summed in
float32 in the TPU kernel's order (ascending tap index) and rounded once
to ``x``'s dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

POOL_GRADS = ("argmax", "native", "pallas")


def pooled_size(H: int, W: int) -> Tuple[int, int]:
    """Output size of the 3x3/s2/p1 pool."""
    return (H + 1) // 2, (W + 1) // 2


def max_pool_3x3s2p1_bwd(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain version: ``x`` (N, C, H, W), ``dy`` (N, C, Ho, Wo) -> dx,
    (N, C, H, W) in ``x``'s dtype and memory format."""
    N, C, H, W = x.shape
    Ho, Wo = pooled_size(H, W)
    xp = F.pad(x.to(torch.float32), (1, 1, 1, 1))
    g = dy.to(x.dtype).to(torch.float32)
    rows = torch.arange(Ho, device=x.device)
    cols = torch.arange(Wo, device=x.device)
    m = idx = have = None
    for k in range(9):
        di, dj = divmod(k, 3)
        v = xp[:, :, di:di + 2 * Ho - 1:2, dj:dj + 2 * Wo - 1:2]
        ih, iw = 2 * rows - 1 + di, 2 * cols - 1 + dj
        valid = (((ih >= 0) & (ih < H))[:, None]
                 & ((iw >= 0) & (iw < W))[None, :])
        if k == 0:
            take = valid.expand_as(v)
            m = torch.where(take, v, torch.zeros_like(v))
            idx = torch.zeros(v.shape, dtype=torch.int8, device=x.device)
            have = take
            continue
        # a padded tap never wins; among real taps strict > keeps the
        # first maximum in row-major order
        take = valid & (~have | (v > m))
        m = torch.where(take, v, m)
        idx = torch.where(take, torch.tensor(k, dtype=torch.int8,
                                             device=x.device), idx)
        have = have | valid
    dxp = torch.zeros_like(xp)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    for k in range(9):
        di, dj = divmod(k, 3)
        dxp[:, :, di:di + 2 * Ho - 1:2, dj:dj + 2 * Wo - 1:2] += \
            torch.where(idx == k, g, zero)
    dx = dxp[:, :, 1:H + 1, 1:W + 1].to(x.dtype)
    if x.is_contiguous(memory_format=torch.channels_last):
        return dx.contiguous(memory_format=torch.channels_last)
    return dx.contiguous()


def _pool_bwd(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    # the seam a caller patches to route the backward elsewhere
    from .pool_bwd_cuda import KERNEL, max_pool_3x3s2p1_bwd_cuda
    # the kernel reads channels_last and raises on any other layout of x;
    # autograd may hand back dy in the NCHW-contiguous layout, converted
    # here (a visible copy, counted)
    if dy.dtype != x.dtype or not dy.is_contiguous(
            memory_format=torch.channels_last):
        dy = dy.to(dtype=x.dtype, memory_format=torch.channels_last)
        KERNEL.dy_copies += 1
    return max_pool_3x3s2p1_bwd_cuda(x, dy)


class StemMaxPool(torch.autograd.Function):
    """Forward ``F.max_pool2d(x, 3, 2, 1)``; backward the kernel on the
    card, the plain version on the host."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)

    @staticmethod
    def backward(ctx, dy):
        x, = ctx.saved_tensors
        return _pool_bwd(x, dy)


def stem_max_pool(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, ceil(H/2), ceil(W/2))."""
    return StemMaxPool.apply(x)
