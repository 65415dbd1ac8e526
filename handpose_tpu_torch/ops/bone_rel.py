"""Bone-relative (kinematic-chain) coordinate transform.

Port of ``handpose_tpu/ops/bone_rel.py:35-105`` (reference
utils/relative_trafo.py:167-218).  The five finger chains are stacked on
a finger axis and advanced together over chain depth (3 steps of a Python
loop where the JAX package scans).
"""

from __future__ import annotations

import torch

from .rotations import rot_mat_x, rot_mat_y

# Finger chains in evaluation order (root-side first).
FINGER_CHAINS = ((4, 3, 2, 1),
                 (8, 7, 6, 5),
                 (12, 11, 10, 9),
                 (16, 15, 14, 13),
                 (20, 19, 18, 17))
ROOT_CHILDREN = (0, 4, 8, 12, 16, 20)


def _backward_step(delta: torch.Tensor):
    """Bone vector in the parent frame -> ((length, angle_x, angle_y),
    R_this)."""
    length = torch.sqrt(torch.sum(delta * delta, dim=-1))
    # reference _atan2(y, x) = atan2(y, x + 1e-8)  (relative_trafo.py:30-35)
    angle_y = torch.atan2(delta[..., 0], delta[..., 2] + 1e-8)
    tmp = torch.einsum("...ij,...j->...i", rot_mat_y(-angle_y), delta)
    angle_x = torch.atan2(-tmp[..., 1], tmp[..., 2] + 1e-8)
    R_this = rot_mat_x(-angle_x) @ rot_mat_y(-angle_y)
    return (length, angle_x, angle_y), R_this


def bone_rel_trafo(coords_xyz: torch.Tensor) -> torch.Tensor:
    """(B, 21, 3) xyz -> (B, 21, 3) of [length, angle_x, angle_y] per bone."""
    coords = coords_xyz.reshape(-1, 21, 3)
    B = coords.shape[0]
    out = torch.zeros((B, 21, 3), dtype=coords.dtype, device=coords.device)

    root_ids = list(ROOT_CHILDREN)
    (l0, ax0, ay0), R0 = _backward_step(coords[:, root_ids, :])
    out[:, root_ids, :] = torch.stack([l0, ax0, ay0], dim=-1)

    # Only the rotation part of each chain's transform reaches the
    # output; the JAX package also carries the translation, which no
    # output reads.
    R = R0[:, 1:]                                   # (B, 5, 3, 3) skip node 0
    for d in range(1, 4):
        child = [c[d] for c in FINGER_CHAINS]
        parent = [c[d - 1] for c in FINGER_CHAINS]
        delta_g = coords[:, child, :] - coords[:, parent, :]
        delta = torch.einsum("bfij,bfj->bfi", R, delta_g)
        (l, ax, ay), R_this = _backward_step(delta)
        R = R_this @ R
        out[:, child, :] = torch.stack([l, ax, ay], dim=-1)
    return out
