"""World, camera and pixel coordinate conversions (InterHand2.6M style).

Port of ``handpose_tpu/ops/camera.py:12-34`` (reference
utils/transforms.py:11-27).  Batched over leading axes: points are
(..., N, 3), rotations (..., 3, 3), translations (..., 3) and the focal
lengths and principal points (..., 2).
"""

from __future__ import annotations

import torch


def world2cam(world_coord: torch.Tensor, R: torch.Tensor,
              t: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) world -> camera coords: ``R x + t``."""
    return torch.einsum("...ij,...nj->...ni", R, world_coord) + t[..., None, :]


def cam2pixel(cam_coord: torch.Tensor, f: torch.Tensor,
              c: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) camera coords -> (..., N, 3) of (u, v, z)."""
    z = cam_coord[..., 2]
    # the reference's +1e-8 depth guard (transforms.py:11-16)
    x = cam_coord[..., 0] / (z + 1e-8) * f[..., None, 0] + c[..., None, 0]
    y = cam_coord[..., 1] / (z + 1e-8) * f[..., None, 1] + c[..., None, 1]
    return torch.stack([x, y, z], dim=-1)


def pixel2cam(pixel_coord: torch.Tensor, f: torch.Tensor,
              c: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) of (u, v, z) -> camera xyz."""
    z = pixel_coord[..., 2]
    x = (pixel_coord[..., 0] - c[..., None, 0]) / f[..., None, 0] * z
    y = (pixel_coord[..., 1] - c[..., None, 1]) / f[..., None, 1] * z
    return torch.stack([x, y, z], dim=-1)
