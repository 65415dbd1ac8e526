"""Synthetic (fake-data) batches: the reference's debug backend.

Port of ``handpose_tpu/data/synthetic.py:19-65`` (reference
trainval.py:405-587, trainval_hand3DPose.py:337-478): a
half-bright/half-dark image, a fixed 21x3 pose with a per-run random
bias, a pinhole camera (f 600, c 300), full visibility and a random
ground-truth rotation.  Its inputs come from ``np.random.default_rng(seed)``
in the JAX function's order, so both packages make the same batch for one
seed; it runs the model, loss and optimizer with no dataset on disk.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.rotations import axis_angle_rot_mat


def fake_sample_batch(batch_size: int, image_size: int = 256,
                      input_channels: int = 3, seed: int = 0,
                      bias: Optional[float] = None) -> dict:
    """The sample-dict contract from synthetic data, as host tensors."""
    rng = np.random.default_rng(seed)
    if bias is None:
        bias = float(rng.uniform(-0.001, 0.001))

    B, S = batch_size, image_size
    image = np.full((B, S, S, 3), 0.5, np.float32)
    image[:, S // 2:, :, :] = -0.5

    xyz = np.full((B, 21, 3), 0.5, np.float32)
    xyz[:, 0] = 0.0
    xyz[:, -10:] = -0.5
    xyz += bias

    K = np.zeros((B, 3, 3), np.float32)
    K[:, 0, 0] = K[:, 1, 1] = 600.0
    K[:, 0, 2] = K[:, 1, 2] = 300.0
    K[:, 2, 2] = 1.0

    uvw = np.einsum("bij,bnj->bni", K, xyz + np.array([0, 0, 1.0],
                                                     np.float32))
    uv = uvw[..., :2] / uvw[..., 2:3]
    u = rng.uniform(-1, 1, (B, 3)).astype(np.float32)
    gt_rot = axis_angle_rot_mat(torch.from_numpy(u))

    t = torch.from_numpy
    return {
        "image_crop": t(image),
        "keypoint_vis21": torch.ones(B, 21, 1),
        "keypoint_scale": torch.ones(B, 1),
        "keypoint_xyz_root": torch.zeros(B, 3),
        "keypoint_uv21": t(uv),
        "keypoint_xyz21": t(xyz),
        "keypoint_xyz21_rel_normed": t(xyz.copy()),
        "kp_coord_xyz21_rel_can": t(xyz.copy()),
        "rot_mat": gt_rot,
        "scoremap": torch.zeros(B, 21, S, S),
        "camera_intrinsic_matrix": t(K),
        "right_hand_mask": torch.zeros(B, S, S),
    }
