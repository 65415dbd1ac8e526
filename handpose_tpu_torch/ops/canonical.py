"""Canonical-frame alignment of 21-keypoint hands.

Port of ``handpose_tpu/ops/canonical.py:21-81`` (reference
utils/canonical_trafo.py:93-184).
"""

from __future__ import annotations

import torch

from .rotations import atan2_safe, rot_mat_x, rot_mat_y, rot_mat_z

_PI = 3.141592653589793

ROOT_NODE_ID = 0    # palm/wrist root -> origin
ALIGN_NODE_ID = 12  # middle-finger MCP -> y axis
ROT_NODE_ID = 20    # pinky root -> fixes rotation about y


def canonical_trafo(coords_xyz: torch.Tensor):
    """(B, 21, 3) -> (coords_normed (B, 21, 3), total_rot_mat (B, 3, 3))
    with ``coords_normed = coords_translated @ total_rot_mat``."""
    coords_xyz = coords_xyz.reshape(-1, 21, 3)

    trans = coords_xyz[:, ROOT_NODE_ID:ROOT_NODE_ID + 1, :]
    coords_t = coords_xyz - trans

    # 1) rotate the align node into the yz-plane (about z)
    p = coords_t[:, ALIGN_NODE_ID, :]
    alpha = atan2_safe(p[:, 0], p[:, 1])
    r1 = rot_mat_z(alpha)
    coords_r1 = coords_t @ r1.transpose(-1, -2)
    total = r1

    # 2) rotate it within the yz-plane onto -y (about x, +pi flip)
    p = coords_r1[:, ALIGN_NODE_ID, :]
    beta = -atan2_safe(p[:, 2], p[:, 1])
    r2 = rot_mat_x(beta + _PI)
    coords_r2 = coords_r1 @ r2.transpose(-1, -2)
    total = total @ r2

    # 3) rotate the pinky root to define rotation about y
    p = coords_r2[:, ROT_NODE_ID, :]
    gamma = atan2_safe(p[:, 2], p[:, 0])
    r3 = rot_mat_y(gamma)
    coords_normed = coords_r2 @ r3.transpose(-1, -2)
    total = total @ r3

    return coords_normed, total


def flip_right_hand(coords_xyz_canonical: torch.Tensor,
                    cond_right) -> torch.Tensor:
    """Mirror canonical coords along z where ``cond_right`` holds.

    ``coords_xyz_canonical`` is (B, N, 3) or (N, 3).  ``cond_right`` gets
    one trailing singleton axis, and a leading batch axis beside
    unbatched coords (the reference's broadcasting): (B, N) and (B, 1)
    select per keypoint and per sample, and an unbatched (N,) or scalar
    cond pairs with (N, 3) coords.
    """
    expanded = coords_xyz_canonical.ndim == 2
    c = coords_xyz_canonical[None] if expanded else coords_xyz_canonical
    cond = torch.as_tensor(cond_right, device=c.device).to(torch.bool)
    if expanded:
        cond = cond[None]
    mirrored = torch.stack([c[..., 0], c[..., 1], -c[..., 2]], dim=-1)
    out = torch.where(cond[..., None], mirrored, c)
    return out[0] if expanded else out
