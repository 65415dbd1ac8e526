"""Pinhole projection and relative-to-absolute rescaling.

Port of ``handpose_tpu/ops/projection.py:21-50`` (reference
utils/coordinate_trans.py:29-73, forwardKinematicsLayer.py:333-358).
"""

from __future__ import annotations

import torch


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
