"""Gaussian scoremap rendering: the plain PyTorch version, and the 3-D
heatmap volumes.

Port of ``handpose_tpu/ops/heatmap.py:23-89`` (reference
dataloaderRHD.py:538-584, utils/compute_heatmap.py:12-26).  The 2-D Gaussian is separable, so each map is
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


def render_gaussian_heatmap_3d(joint_coords: torch.Tensor,
                               output_hm_shape: tuple[int, int, int],
                               sigma: float = 2.5) -> torch.Tensor:
    """(B, J, 3) (x, y, z) in heatmap voxels -> (B, J, D, H, W) Gaussian
    volumes times 255 (reference utils/compute_heatmap.py:12-26).

    Not the 2-D map's formula: the coordinates are not truncated, the
    exponent is ``-d^2 / (2 sigma^2)``, and there is no visibility gate.
    Separable: the outer product of a (D,), an (H,) and a (W,) factor.
    No Pallas kernel computes it in the JAX package either.
    """
    D, H, W = output_hm_shape
    dev = joint_coords.device
    x = joint_coords[..., 0]
    y = joint_coords[..., 1]
    z = joint_coords[..., 2]
    inv = 1.0 / (2.0 * sigma ** 2)
    zz = torch.arange(D, dtype=torch.float32, device=dev)
    yy = torch.arange(H, dtype=torch.float32, device=dev)
    xx = torch.arange(W, dtype=torch.float32, device=dev)
    gz = torch.exp(-((zz[None, None, :] - z[..., None]) ** 2) * inv)
    gy = torch.exp(-((yy[None, None, :] - y[..., None]) ** 2) * inv)
    gx = torch.exp(-((xx[None, None, :] - x[..., None]) ** 2) * inv)
    vol = (gz[..., :, None, None] * gy[..., None, :, None]
           * gx[..., None, None, :])
    return vol * 255.0
