"""Differentiable forward kinematics over the 20-node hand graph.

Port of ``handpose_tpu/nn/fk.py`` (reference
network/sub_modules/forwardKinematicsLayer.py:142-358):

* the per-node angle wiring (thumb 3+3+1 DOF, the other fingers 2+1+1;
  reference bonePrediction.py:5-46) is a static (20, 3, 23) selection
  table, so one einsum gathers every joint's euler triple;
* the five finger chains are alike, so the local rotations of all 20
  joints come from one batched euler call and are chained over depth 4
  with the fingers stacked on an axis (the JAX package's ``lax.scan``,
  here a loop of 4 steps of B x 5 batched 3x3 products).

Node order: A1..A4, B1..B4, C1..C4, D1..D4, E1..E4 (A = thumb .. E =
pinky); ``bone_lengths[:, i]`` is the parent->node_i bone, same order.
Geometry is float32 whatever the trunk's compute dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.projection import batch_project_xyz_to_uv, rel_normed_to_absolute
from ..ops.rotations import euler_xyz_rot_mat


def _angle_selection_table() -> np.ndarray:
    """(20, 3, 23) one-hot map: other_angles -> per-node (x, y, z) euler."""
    S = np.zeros((20, 3, 23), np.float32)
    # thumb (reference forwardKinematicsLayer.py:239-255)
    S[0, 0, 0] = S[0, 1, 1] = S[0, 2, 2] = 1.0   # A1: x,y,z <- 0,1,2
    S[1, 0, 3] = S[1, 1, 4] = S[1, 2, 5] = 1.0   # A2: x,y,z <- 3,4,5
    S[2, 1, 6] = 1.0                             # A3: y <- 6
    # other fingers (reference forwardKinematicsLayer.py:257-274)
    slot = 7
    for f in range(1, 5):
        base = 4 * f
        S[base + 0, 0, slot] = 1.0       # *1: x
        S[base + 0, 1, slot + 1] = 1.0   # *1: y
        S[base + 1, 0, slot + 2] = 1.0   # *2: x
        S[base + 2, 0, slot + 3] = 1.0   # *3: x
        slot += 4
    return S


ANGLE_SELECTION = _angle_selection_table()

# MANO <-> RHD joint-order swap (reference forwardKinematicsLayer.py:
# 324-327): within each finger block [i..i+3], reverse the order
JOINT_SWITCH_PERM = [0] + [i + d for i in (1, 5, 9, 13, 17)
                           for d in (3, 2, 1, 0)]


def fk_positions(root_angles: torch.Tensor, other_angles: torch.Tensor,
                 bone_lengths: torch.Tensor) -> torch.Tensor:
    """Root-relative joint positions (B, 21, 3) from the wrist's euler
    angles (B, 3), the 23 articulation DOFs (B, 23) and the 20 bone
    lengths (B, 20)."""
    B = root_angles.shape[0]
    sel = torch.from_numpy(ANGLE_SELECTION).to(other_angles.device)
    joint_angles = torch.einsum("nak,bk->bna", sel, other_angles)
    local = euler_xyz_rot_mat(joint_angles).reshape(B, 5, 4, 3, 3)
    lengths = bone_lengths.reshape(B, 5, 4)
    R = euler_xyz_rot_mat(root_angles)[:, None].expand(B, 5, 3, 3)
    p = torch.zeros((B, 5, 3), dtype=root_angles.dtype,
                    device=root_angles.device)
    positions = []
    for depth in range(4):
        R = R @ local[:, :, depth]
        p = p + R[..., :, 2] * lengths[:, :, depth, None]   # R @ [0, 0, l]
        positions.append(p)
    ps = torch.stack(positions, dim=2).reshape(B, 20, 3)     # node order
    return torch.cat([torch.zeros_like(ps[:, :1]), ps], dim=1)


def forward_kinematics(root_angles: torch.Tensor, other_angles: torch.Tensor,
                       bone_lengths: torch.Tensor,
                       camera_intrinsic_matrix: torch.Tensor,
                       index_root_bone_length: torch.Tensor,
                       kp_coord_xyz_root: torch.Tensor,
                       joint_order_switched: bool = True):
    """Articulation -> (absolute xyz (B, 21, 3), projected uv (B, 21, 2))
    (reference forwardKinematicsLayer.py:147-330).  With
    ``joint_order_switched`` False the output is permuted back to RHD
    order by a static gather."""
    positions = fk_positions(root_angles, other_angles, bone_lengths)
    xyz = rel_normed_to_absolute(positions, index_root_bone_length,
                                 kp_coord_xyz_root)
    if not joint_order_switched:
        xyz = xyz[:, JOINT_SWITCH_PERM, :]
    return xyz, batch_project_xyz_to_uv(xyz, camera_intrinsic_matrix)
