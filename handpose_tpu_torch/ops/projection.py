"""Pinhole projection and absolute/relative coordinate rescaling.

Port of ``handpose_tpu/ops/projection.py:12-63`` (reference
utils/coordinate_trans.py:6-73, forwardKinematicsLayer.py:333-358,
dataloaderRHD.py:229-238).
"""

from __future__ import annotations

import torch


def camera_xyz_to_uv(xyz: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """(N, 3) points + (3, 3) intrinsics -> (N, 2) pixel coords (no
    zero-depth guard, as in the reference)."""
    uvw = xyz @ K.T
    return uvw[..., :2] / uvw[..., 2:3]


def batch_project_xyz_to_uv(xyz: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) points + (B, 3, 3) intrinsics -> (B, N, 2), with the
    reference's w == 0 -> 1e-10 guard."""
    p = torch.einsum("bij,bnj->bni", K, xyz)
    w = p[..., 2]
    w = torch.where(w == 0, torch.full_like(w, 1e-10), w)
    return p[..., :2] / w[..., None]


def rel_normed_to_absolute(xyz_rel_normed: torch.Tensor,
                           index_root_bone_length: torch.Tensor,
                           xyz_root: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) root-relative normalised coords, (B, 1) scale and (B, 3)
    root -> (B, N, 3) absolute coords."""
    scaled = xyz_rel_normed * index_root_bone_length[..., None]
    return scaled + xyz_root[:, None, :]


def absolute_to_rel_normed(xyz: torch.Tensor):
    """(B, N, 3) absolute coords -> (root-relative coords divided by the
    root-to-middle-MCP (joint 12) length, that length (B, 1), the root
    (B, 3)): the inverse of :func:`rel_normed_to_absolute`."""
    root = xyz[:, 0, :]
    rel = xyz - root[:, None, :]
    scale = torch.sqrt(torch.sum(rel[:, 12, :] ** 2, dim=-1, keepdim=True))
    return rel / scale[..., None], scale, root
