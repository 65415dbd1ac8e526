"""Device-side RHD preprocessing, serving path.

Port of ``handpose_tpu/data/preprocess.py:32-283,319-329``: dominant-hand
selection from the mask, mirroring of left hands, root-relative,
bone-relative and canonical transforms, crop with bilinear resize,
intrinsics rewrite and the Gaussian scoremaps, batched on the device of
the raw batch.  The scoremaps go through the CUDA kernel's wrapper, so on
the card the render is always the hand-written kernel.

Layouts follow the JAX package: images and ``model_input`` are NHWC, the
scoremap is (B, K, H, W).  The train-time augmentations and the terminal
dataset transforms wait for the training slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops.bone_rel import bone_rel_trafo
from ..ops.canonical import canonical_trafo
from ..ops.crop import (compute_crop_params, crop_intrinsics,
                        crop_resize_bilinear, crop_resize_nearest, crop_uv)
from ..ops.scoremap_cuda import render_gaussian_maps_cuda


class RawBatch(NamedTuple):
    """Host-produced raw inputs (uint8 images, float annotations)."""

    image: torch.Tensor         # (B, H, W, 3) uint8 RGB
    mask: torch.Tensor          # (B, H, W) uint8 hand-parts segmentation
    keypoint_uv: torch.Tensor   # (B, 42, 2) float32
    keypoint_vis: torch.Tensor  # (B, 42) bool/float
    keypoint_xyz: torch.Tensor  # (B, 42, 3) float32
    camera_K: torch.Tensor      # (B, 3, 3) float32

    def to(self, device, non_blocking: bool = False) -> "RawBatch":
        """Every field as a tensor on ``device`` (numpy fields converted)."""
        return RawBatch(*(torch.as_tensor(a).to(device, non_blocking=non_blocking)
                          for a in self))


# MANO<->RHD joint-order switch (reference dataloaderRHD.py:587-591)
_SWITCH_PERM = [0] + [i + d for i in (1, 5, 9, 13, 17) for d in (3, 2, 1, 0)]

# flags of the JAX preprocess_batch that this slice does not carry
_TRAINING_SLICE_FLAGS = ("coord_uv_noise", "crop_center_noise",
                         "crop_scale_noise", "crop_offset_noise",
                         "scoremap_dropout", "hue_aug", "full_contract",
                         "scale_to_size", "random_crop_to_size")


def preprocess_batch(raw: RawBatch, crop_size: int = 256, sigma: float = 25.0,
                     use_wrist_coord: bool = True,
                     switch_joint_order: bool = True,
                     calculate_scoremap: bool = True,
                     hand_crop: bool = True, **flags) -> dict:
    """(B, ...) raw tensors -> the reference sample dict, batched.

    Returns the keys of the JAX function with all augmentations off.  Any
    augmentation or terminal-transform flag set true raises
    ``NotImplementedError``.
    """
    unknown = set(flags) - set(_TRAINING_SLICE_FLAGS)
    if unknown:
        raise TypeError(f"unexpected arguments {sorted(unknown)}")
    on = sorted(k for k, v in flags.items() if v)
    if on:
        raise NotImplementedError(
            f"{on}: augmentations and terminal dataset transforms wait for "
            "the training slice (ROADMAP.md, queue 1)")
    B, H, W, _ = raw.image.shape
    image = raw.image.to(torch.float32) / 255.0 - 0.5
    kp_uv = raw.keypoint_uv.to(torch.float32)
    kp_vis = raw.keypoint_vis.reshape(B, -1).bool()
    kp_xyz = raw.keypoint_xyz.to(torch.float32)
    K = raw.camera_K.to(torch.float32)

    if not use_wrist_coord:
        kp_xyz = kp_xyz.clone()
        kp_uv = kp_uv.clone()
        kp_vis = kp_vis.clone()
        for r, m in ((0, 12), (21, 33)):
            kp_xyz[:, r] = 0.5 * (kp_xyz[:, r] + kp_xyz[:, m])
            kp_uv[:, r] = 0.5 * (kp_uv[:, r] + kp_uv[:, m])
            kp_vis[:, r] = kp_vis[:, r] | kp_vis[:, m]

    # dominant-hand selection from the segmentation mask
    # (reference dataloaderRHD.py:171-201)
    m = raw.mask
    hand_map_l = (m > 1) & (m < 18)
    hand_map_r = m > 17
    n_l = hand_map_l.sum((1, 2))
    n_r = hand_map_r.sum((1, 2))
    cond_left = n_l > n_r                                   # (B,)
    hand_side = torch.where(cond_left, 0, 1)
    right_hand_mask = torch.where(cond_left[:, None, None],
                                  hand_map_l.flip(2), hand_map_r)

    cl3 = cond_left[:, None, None]
    kp_xyz21 = torch.where(cl3, kp_xyz[:, :21], kp_xyz[:, 21:])
    # mirror left hands into the right-hand convention: negate x
    mirror = torch.tensor([-1.0, 1.0, 1.0], device=kp_xyz.device)
    kp_xyz21 = torch.where(cl3, kp_xyz21 * mirror, kp_xyz21)
    kp_vis21 = torch.where(cond_left[:, None], kp_vis[:, :21], kp_vis[:, 21:])
    kp_uv21 = torch.where(cl3, kp_uv[:, :21], kp_uv[:, 21:])

    # root-relative + scale-normalised coords (dataloaderRHD.py:229-238)
    root = kp_xyz21[:, 0, :]
    rel = kp_xyz21 - root[:, None, :]
    if use_wrist_coord:
        scale = torch.sqrt(torch.sum(rel[:, 12, :] ** 2, dim=-1))
    else:
        scale = torch.sqrt(torch.sum((rel[:, 12, :] - rel[:, 11, :]) ** 2,
                                     dim=-1))
    rel_normed = rel / scale[:, None, None]

    local = bone_rel_trafo(rel_normed)
    can, rot = canonical_trafo(rel_normed)
    # orthonormal: inverse == transpose.  The reversed composition order of
    # the accumulated rotation is the reference's (see the JAX function).
    rot_inv = rot.transpose(-1, -2)

    # mirror the image + u coordinate for left hands
    image = torch.where(cond_left[:, None, None, None], image.flip(2), image)
    u_mirr = torch.where(cond_left[:, None], W - kp_uv21[:, :, 0],
                         kp_uv21[:, :, 0])
    kp_uv21 = torch.stack([u_mirr, kp_uv21[:, :, 1]], dim=-1)

    out = {
        "image": image,
        "hand_side": F.one_hot(hand_side, 2).to(torch.float32),
        "keypoint_xyz21": kp_xyz21,
        "keypoint_vis21": kp_vis21[..., None],
        "keypoint_uv21": kp_uv21,
        "keypoint_scale": scale[:, None],
        "keypoint_xyz_root": root,
        "keypoint_xyz21_rel_normed": rel_normed,
        "keypoint_xyz21_local": local,
        "kp_coord_xyz21_rel_can": can,
        "rot_mat": rot_inv,
        "camera_intrinsic_matrix": K,
    }

    if hand_crop:
        params = compute_crop_params(kp_uv21, kp_vis21, (H, W), crop_size)
        out["image_crop"] = crop_resize_bilinear(image, params, crop_size)
        rhm = crop_resize_nearest(right_hand_mask.to(torch.float32), params,
                                  crop_size)
        out["right_hand_mask"] = (rhm > 0).to(torch.float32)
        kp_uv21 = crop_uv(kp_uv21, params)
        out["keypoint_uv21"] = kp_uv21
        out["camera_intrinsic_matrix"] = crop_intrinsics(K, params)
    else:
        out["right_hand_mask"] = right_hand_mask.to(torch.float32)

    if calculate_scoremap:
        size = (crop_size, crop_size) if hand_crop else (H, W)
        coords_hw = torch.stack([kp_uv21[..., 1], kp_uv21[..., 0]], dim=-1)
        out["scoremap"] = render_gaussian_maps_cuda(coords_hw, size, sigma,
                                                    kp_vis21)

    if switch_joint_order:
        for key in ("keypoint_vis21", "keypoint_uv21", "keypoint_xyz21"):
            out[key] = out[key][:, _SWITCH_PERM]
    return out


def model_input(sample: dict, input_channels: int) -> torch.Tensor:
    """The network input per ``input_channels`` (reference
    trainval.py:293-300); NHWC.  For 21 channels it is a view of the
    (B, K, H, W) scoremap, so the trunk reads it back as NCHW without a
    copy."""
    if input_channels == 24:
        score = sample["scoremap"].permute(0, 2, 3, 1)
        return torch.cat([sample["image_crop"], score], dim=-1)
    if input_channels == 21:
        return sample["scoremap"].permute(0, 2, 3, 1)
    if input_channels == 3:
        return sample["image_crop"]
    raise ValueError("input_channels are not supported")
