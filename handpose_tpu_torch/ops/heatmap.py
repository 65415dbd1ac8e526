"""Gaussian scoremap rendering: the plain PyTorch version.

Port of ``handpose_tpu/ops/heatmap.py:23-60`` (reference
dataloaderRHD.py:538-584).  The 2-D Gaussian is separable, so each map is
the outer product of a (H,) and a (W,) factor.  This is the function the
CUDA kernel (``ops/scoremap_cuda.py``) is held to; the preprocessing path
calls the kernel's wrapper, which uses this version for host tensors only.
"""

from __future__ import annotations

import numpy as np
import torch


def inv_sigma_sq(sigma: float) -> float:
    """``1 / sigma^2`` rounded as the JAX package computes it, in f32."""
    return float(np.float32(1.0) / np.float32(sigma) ** 2)


def render_gaussian_maps(coords_hw: torch.Tensor,
                         output_size: tuple[int, int],
                         sigma: float,
                         valid: torch.Tensor | None = None) -> torch.Tensor:
    """(B, K, 2) (row, col) coords [+ (B, K[,1]) visibility] -> (B, K, H, W)
    float32 maps.

    Coords are truncated to integer grid positions first (like the
    reference, dataloaderRHD.py:545).  A map is zero unless its keypoint
    is visible and strictly inside ``0 < row < H-1``, ``0 < col < W-1``.
    """
    H, W = output_size
    coords = coords_hw.to(torch.int32).to(torch.float32)
    cy = coords[..., 0]                                    # (B, K)
    cx = coords[..., 1]
    if valid is not None:
        cond_val = valid.reshape(cy.shape).to(torch.float32) > 0.5
    else:
        cond_val = torch.ones_like(cy, dtype=torch.bool)
    cond_in = (cy < H - 1) & (cy > 0) & (cx < W - 1) & (cx > 0)
    cond = (cond_val & cond_in).to(torch.float32)

    inv_s2 = inv_sigma_sq(sigma)
    ys = torch.arange(H, dtype=torch.float32, device=coords.device)
    xs = torch.arange(W, dtype=torch.float32, device=coords.device)
    gy = torch.exp(-((ys[None, None, :] - cy[..., None]) ** 2) * inv_s2)
    gx = torch.exp(-((xs[None, None, :] - cx[..., None]) ** 2) * inv_s2)
    maps = gy[..., :, None] * gx[..., None, :]                  # (B,K,H,W)
    return maps * cond[..., None, None]
