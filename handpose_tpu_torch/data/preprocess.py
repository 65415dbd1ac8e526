"""Device-side RHD and InterHand2.6M preprocessing, serving and training.

Port of ``handpose_tpu/data/preprocess.py:32-497``: dominant-hand
selection from the mask, mirroring of left hands, root-relative,
bone-relative and canonical transforms, crop with bilinear resize,
intrinsics rewrite and the Gaussian scoremaps, batched on the device of
the raw batch.  The scoremaps go through the CUDA kernel's wrapper, so on
the card the render is always the hand-written kernel.

Layouts follow the JAX package: images and ``model_input`` are NHWC, the
scoremap is (B, K, H, W).  The train-time augmentations (uv, crop
centre, scale and offset noise, hue rotation and scoremap dropout) take
their random draws from an :class:`AugmentDraws` made on the raw batch's
device (:func:`draw_augmentations`); the terminal dataset transforms
``scale_to_size`` and ``random_crop_to_size`` follow the JAX function.
:func:`preprocess_interhand_batch` is the InterHand2.6M counterpart: the
hand side from the annotation, the crop window from its bbox, and the
two augmentations the reference's InterHand loader applies.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..ops.bone_rel import bone_rel_trafo
from ..ops.canonical import canonical_trafo
from ..ops.crop import (CropParams, _rdiv, compute_crop_params,
                        crop_intrinsics, crop_resize_bilinear,
                        crop_resize_nearest, crop_uv)
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


class InterHandRawBatch(NamedTuple):
    """Host-parsed InterHand2.6M raw inputs (annotations already in RHD
    joint order and metres)."""

    image: torch.Tensor         # (B, H, W, 3) uint8 RGB (maybe zero-padded)
    keypoint_uv: torch.Tensor   # (B, 42, 2) float32 (truncated to int on use)
    keypoint_vis: torch.Tensor  # (B, 42) float/bool
    keypoint_xyz: torch.Tensor  # (B, 42, 3) float32 metres
    camera_K: torch.Tensor      # (B, 3, 3) float32
    hand_left: torch.Tensor     # (B,) bool: annotation hand_type == 'left'
    bbox: torch.Tensor          # (B, 4) int32 (x, y, w, h), pre-clamped
    orig_wh: torch.Tensor       # (B, 2) int32 original (W, H) pre-padding

    def to(self, device, non_blocking: bool = False) -> "InterHandRawBatch":
        """Every field as a tensor on ``device`` (numpy fields converted)."""
        return InterHandRawBatch(
            *(torch.as_tensor(a).to(device, non_blocking=non_blocking)
              for a in self))


# MANO<->RHD joint-order switch (reference dataloaderRHD.py:587-591)
_SWITCH_PERM = [0] + [i + d for i in (1, 5, 9, 13, 17) for d in (3, 2, 1, 0)]

_P_DROP = 0.8     # scoremap dropout rate (dataloaderRHD.py:357-361)

# the YIQ transform of ``yiq_hue_rotate``
_TO_YIQ = ((0.299, 0.587, 0.114),
           (0.596, -0.274, -0.322),
           (0.211, -0.523, 0.312))


class AugmentDraws(NamedTuple):
    """The random draws of the train-time augmentations, in the units
    :func:`preprocess_batch` applies them.  A field is None when its
    augmentation is off."""

    uv_noise: Optional[torch.Tensor] = None      # (B, 42, 2) px, N(0, 2.5^2)
    hue_turns: Optional[torch.Tensor] = None     # (B,) U(-0.1, 0.1) turns
    center_noise: Optional[torch.Tensor] = None  # (B, 2) (y, x), N(0, 20^2)
    scale_noise: Optional[torch.Tensor] = None   # (B,) U(0, 1) * 0.2 + 1
    offset_noise: Optional[torch.Tensor] = None  # (B, 2) (y, x), N(0, 10^2)
    dropout_keep: Optional[torch.Tensor] = None  # (B, 21, S, S) bool, p 0.2
    crop_yx: Optional[torch.Tensor] = None       # (B, 2) int64 crop offsets

    def split(self, k: int) -> list:
        """``k`` equal slices along the batch axis."""
        def part(a, i):
            if a is None:
                return None
            m = a.shape[0] // k
            return a[i * m:(i + 1) * m]

        return [AugmentDraws(*(part(a, i) for a in self)) for i in range(k)]


# augmentation flag -> the AugmentDraws field it consumes
DRAW_OF_FLAG = {"coord_uv_noise": "uv_noise",
                "hue_aug": "hue_turns",
                "crop_center_noise": "center_noise",
                "crop_scale_noise": "scale_noise",
                "crop_offset_noise": "offset_noise",
                "scoremap_dropout": "dropout_keep",
                "random_crop_to_size": "crop_yx"}


def draw_augmentations(flags, shapes, generator: torch.Generator
                       ) -> AugmentDraws:
    """The draws of the augmentations named in ``flags`` (keys of
    :data:`DRAW_OF_FLAG`), on ``generator``'s device, from it alone.

    ``shapes`` is ``(B, (H, W), (map_h, map_w), random_crop_size)``: the
    batch, the raw image, the scoremap and the random crop's side.  The
    distributions are the JAX package's (``preprocess_batch``, :113-118,
    :193-203, :231-237, :261-283); draws are made in a fixed order, so
    one generator state gives one set of draws.
    """
    B, (H, W), (mh, mw), rc = shapes
    dev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    def offsets(n):
        return torch.randint(0, n - rc + 1, (B,), generator=generator,
                             device=dev)

    d = {}
    if "coord_uv_noise" in flags:
        d["uv_noise"] = 2.5 * normal(B, 42, 2)
    if "hue_aug" in flags:
        d["hue_turns"] = uniform(B) * 0.2 - 0.1
    if "crop_center_noise" in flags:
        d["center_noise"] = 20.0 * normal(B, 2)
    if "crop_scale_noise" in flags:
        d["scale_noise"] = uniform(B) * 0.2 + 1.0
    if "crop_offset_noise" in flags:
        d["offset_noise"] = 10.0 * normal(B, 2)
    if "scoremap_dropout" in flags:
        d["dropout_keep"] = uniform(B, 21, mh, mw) < 1.0 - _P_DROP
    if "random_crop_to_size" in flags:
        d["crop_yx"] = torch.stack([offsets(H), offsets(W)], dim=-1)
    return AugmentDraws(**d)


def _resolve_draws(flags: list, shapes, draws: Optional[AugmentDraws],
                   generator: Optional[torch.Generator],
                   device: torch.device) -> AugmentDraws:
    """The injected ``draws``, or new ones from ``generator``; raises
    ``ValueError`` when an augmentation is on and neither is given."""
    if draws is None:
        if generator is None:
            raise ValueError(f"augmentations {flags} need draws or a "
                             "generator")
        if generator.device.type != device.type:
            raise ValueError(f"the generator lies on {generator.device}, "
                             f"the raw batch on {device}")
        return draw_augmentations(flags, shapes, generator)
    missing = [f for f in flags if getattr(draws, DRAW_OF_FLAG[f]) is None]
    if missing:
        raise ValueError(f"augmentations {missing} are on but the injected "
                         "draws do not hold theirs")
    return draws


def preprocess_batch(raw: RawBatch, crop_size: int = 256, sigma: float = 25.0,
                     use_wrist_coord: bool = True,
                     switch_joint_order: bool = True,
                     calculate_scoremap: bool = True,
                     hand_crop: bool = True,
                     coord_uv_noise: bool = False,
                     crop_center_noise: bool = False,
                     crop_scale_noise: bool = False,
                     crop_offset_noise: bool = False,
                     scoremap_dropout: bool = False,
                     hue_aug: bool = False,
                     full_contract: bool = False,
                     scale_to_size: bool = False,
                     scale_target_size: tuple = (240, 320),
                     random_crop_to_size: bool = False,
                     random_crop_size: int = 256,
                     draws: Optional[AugmentDraws] = None,
                     generator: Optional[torch.Generator] = None) -> dict:
    """(B, ...) raw tensors -> the reference sample dict, batched.

    The keys and flags of the JAX function.  The augmentations' random
    draws are ``draws`` where given (how the tests hold the port to the
    JAX package), else drawn from ``generator``, a ``torch.Generator`` on
    the raw batch's device; with an augmentation on and neither given it
    raises ``ValueError``, as the JAX function asserts its ``rng``.
    ``full_contract`` adds the reference dict's mask keys;
    ``scale_to_size`` and ``random_crop_to_size`` replace the dict with
    the reference's reduced one.
    """
    B, H, W, _ = raw.image.shape
    if random_crop_to_size and not scale_to_size and (
            random_crop_size > H or random_crop_size > W):
        raise ValueError(
            f"random_crop_size {random_crop_size} exceeds the image extent "
            f"({H}x{W}); crops must fit inside the source image")
    used = {"coord_uv_noise": coord_uv_noise, "hue_aug": hue_aug,
            "crop_center_noise": crop_center_noise and hand_crop,
            "crop_scale_noise": crop_scale_noise and hand_crop,
            "crop_offset_noise": crop_offset_noise and hand_crop,
            "scoremap_dropout": scoremap_dropout and calculate_scoremap,
            "random_crop_to_size": random_crop_to_size and not scale_to_size}
    flags = [f for f, on in used.items() if on]
    map_hw = (crop_size, crop_size) if hand_crop else (H, W)
    if flags:
        draws = _resolve_draws(flags, (B, (H, W), map_hw, random_crop_size),
                               draws, generator, raw.image.device)

    def drawn(flag):
        """The draw of ``flag`` where it is on, else None."""
        return getattr(draws, DRAW_OF_FLAG[flag]) if used[flag] else None

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

    if coord_uv_noise:      # dataloaderRHD.py:102-104
        kp_uv = kp_uv + drawn("coord_uv_noise")
    if hue_aug:
        image = yiq_hue_rotate(image, drawn("hue_aug"))

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

    if full_contract:
        # reference dataloaderRHD.py:117-123, 171-187
        parts = raw.mask.to(torch.int32)
        hand_any = parts > 1
        out["hand_parts"] = parts
        out["hand_map_l"] = hand_map_l.to(torch.int32)
        out["hand_map_r"] = hand_map_r.to(torch.int32)
        out["hand_mask"] = torch.stack([(~hand_any).to(torch.int32),
                                        hand_any.to(torch.int32)], dim=-1)

    if hand_crop:
        params = compute_crop_params(kp_uv21, kp_vis21, (H, W), crop_size,
                                     drawn("crop_center_noise"),
                                     drawn("crop_scale_noise"),
                                     drawn("crop_offset_noise"))
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
        coords_hw = torch.stack([kp_uv21[..., 1], kp_uv21[..., 0]], dim=-1)
        scoremap = render_gaussian_maps_cuda(coords_hw, map_hw, sigma,
                                             kp_vis21)
        if scoremap_dropout:
            # torch F.dropout(p=0.8) then *0.8 (dataloaderRHD.py:357-361),
            # in the JAX function's order of operations: kept elements end
            # up scaled by p / (1 - p) = 4
            scoremap = scoremap * drawn("scoremap_dropout") \
                / (1.0 - _P_DROP) * _P_DROP
        out["scoremap"] = scoremap

    if switch_joint_order:
        for key in ("keypoint_vis21", "keypoint_uv21", "keypoint_xyz21"):
            out[key] = out[key][:, _SWITCH_PERM]

    # terminal dataset-output transforms (dataloaderRHD.py:464-512): both
    # replace the sample dict with a reduced one no model can take
    if scale_to_size:
        # the live reference branch scales the uv by target / full image
        # even when it is in crop space; kept as the JAX function keeps it
        th, tw = scale_target_size
        scale = torch.tensor([tw / W, th / H], dtype=torch.float32,
                             device=image.device)
        return {"image": _resize_bilinear(out["image"], (th, tw)),
                "keypoint_uv21": out["keypoint_uv21"] * scale,
                "keypoint_vis21": out["keypoint_vis21"]}
    if random_crop_to_size:
        # the JAX function's reading of the reference's commented-out
        # branch: one random window of image, parts and hand mask
        S = random_crop_size
        ar = torch.arange(S, device=image.device)
        yx = drawn("random_crop_to_size")
        rows = (yx[:, 0:1] + ar)[:, :, None]                # (B, S, 1)
        cols = (yx[:, 1:2] + ar)[:, None, :]                # (B, 1, S)
        b = torch.arange(B, device=image.device)[:, None, None]
        parts = raw.mask.to(torch.int32)[b, rows, cols]
        hand_any = parts > 1
        return {"image": out["image"][b, rows, cols],
                "hand_parts": parts,
                "hand_mask": torch.stack([(~hand_any).to(torch.int32),
                                          hand_any.to(torch.int32)], dim=-1)}
    return out


def preprocess_interhand_batch(raw: InterHandRawBatch, crop_size: int = 256,
                               sigma: float = 25.0,
                               use_wrist_coord: bool = True,
                               switch_joint_order: bool = True,
                               calculate_scoremap: bool = True,
                               hand_crop: bool = True,
                               coord_uv_noise: bool = False,
                               scoremap_dropout: bool = False,
                               draws: Optional[AugmentDraws] = None,
                               generator: Optional[torch.Generator] = None
                               ) -> dict:
    """InterHand2.6M raw tensors -> the reference sample dict, batched
    (reference dataloaderInterHand2M6.py:180-532; JAX
    ``preprocess_interhand_batch``).

    Unlike the RHD path the hand side comes from the annotation, the crop
    window is the pre-clamped bbox, uv is truncated to int32 on load (the
    reference's ``torch.tensor(..., dtype=torch.int32)``), and the
    right_hand_mask is the bbox interior inset by 10 px.  Each step keeps
    the JAX function's types: integer uv until ``coord_uv_noise`` makes
    it float, floor division in the palm block.  The two augmentations
    are ``coord_uv_noise`` (N(0, 2.5^2) px on all 42 uv) and
    ``scoremap_dropout`` (kept with p 0.2, scaled by 4); their draws are
    ``draws`` or new ones from ``generator``, as in
    :func:`preprocess_batch`.
    """
    B, H, W, _ = raw.image.shape
    used = {"coord_uv_noise": coord_uv_noise,
            "scoremap_dropout": scoremap_dropout and calculate_scoremap}
    flags = [f for f, on in used.items() if on]
    map_hw = (crop_size, crop_size) if hand_crop else (H, W)
    if flags:
        draws = _resolve_draws(flags, (B, (H, W), map_hw, 0), draws,
                               generator, raw.image.device)
    kp_uv = torch.trunc(raw.keypoint_uv).to(torch.int32)
    kp_vis = raw.keypoint_vis.reshape(B, -1).bool()
    kp_xyz = raw.keypoint_xyz.to(torch.float32)
    K = raw.camera_K.to(torch.float32)

    if not use_wrist_coord:
        kp_xyz = kp_xyz.clone()
        kp_uv = kp_uv.clone()
        kp_vis = kp_vis.clone()
        for r, m in ((0, 12), (21, 33)):
            kp_xyz[:, r] = 0.5 * (kp_xyz[:, r] + kp_xyz[:, m])
            kp_uv[:, r] = torch.div(kp_uv[:, r] + kp_uv[:, m], 2,
                                    rounding_mode="floor")
            kp_vis[:, r] = kp_vis[:, r] | kp_vis[:, m]

    if coord_uv_noise:
        # right after the palm block (:317-318), before the side selection
        kp_uv = kp_uv.to(torch.float32) + draws.uv_noise

    cond_left = raw.hand_left.bool()
    orig_w = raw.orig_wh[:, 0]
    hand_side = torch.where(cond_left, 0, 1)
    cl3 = cond_left[:, None, None]
    kp_xyz21 = torch.where(cl3, kp_xyz[:, :21], kp_xyz[:, 21:])
    mirror = torch.tensor([-1.0, 1.0, 1.0], device=kp_xyz.device)
    kp_xyz21 = torch.where(cl3, kp_xyz21 * mirror, kp_xyz21)
    kp_vis21 = torch.where(cond_left[:, None], kp_vis[:, :21], kp_vis[:, 21:])
    kp_uv21 = torch.where(cl3, kp_uv[:, :21], kp_uv[:, 21:])

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
    rot_inv = rot.transpose(-1, -2)

    # mirror left hands about each sample's ORIGINAL width, the padding
    # left in place; the gather runs on the uint8 image (exact, 4x fewer
    # bytes than on floats)
    cols = torch.arange(W, device=raw.image.device)[None, :]
    ow = orig_w.to(cols.dtype)[:, None]
    mirror_col = (ow - 1 - cols).clamp(0, W - 1)
    col_idx = torch.where(cond_left[:, None] & (cols < ow), mirror_col, cols)
    image = torch.gather(raw.image, 2,
                         col_idx[:, None, :, None].expand(B, H, W, 3))
    image = image.to(torch.float32) / 255.0 - 0.5
    u_mirr = torch.where(cond_left[:, None],
                         orig_w.to(kp_uv21.dtype)[:, None] - kp_uv21[:, :, 0],
                         kp_uv21[:, :, 0])
    kp_uv21 = torch.stack([u_mirr, kp_uv21[:, :, 1]],
                          dim=-1).to(torch.float32)

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
        x1, y1, w, h = raw.bbox.unbind(-1)
        params = CropParams(y1=y1, x1=x1, len_y=h, len_x=w,
                            scale_y=_rdiv(crop_size, h.to(torch.float32)),
                            scale_x=_rdiv(crop_size, w.to(torch.float32)))
        out["image_crop"] = crop_resize_bilinear(image, params, crop_size)
        # the bbox interior inset by 10 px, nearest-resized: pixel (i, j)
        # is 1 iff floor(i*h/S) and floor(j*w/S) lie in [10, extent - 10)
        offset = 10
        o = torch.arange(crop_size, device=image.device)
        src_y = torch.div(o[None, :] * h[:, None], crop_size,
                          rounding_mode="floor")
        src_x = torch.div(o[None, :] * w[:, None], crop_size,
                          rounding_mode="floor")
        my = (src_y >= offset) & (src_y < (h - offset)[:, None])
        mx = (src_x >= offset) & (src_x < (w - offset)[:, None])
        out["right_hand_mask"] = (my[:, :, None]
                                  & mx[:, None, :]).to(torch.float32)
        kp_uv21 = crop_uv(kp_uv21, params)
        out["keypoint_uv21"] = kp_uv21
        out["camera_intrinsic_matrix"] = crop_intrinsics(K, params)
    else:
        out["right_hand_mask"] = torch.zeros((B, H, W), dtype=torch.float32,
                                             device=image.device)

    if calculate_scoremap:
        coords_hw = torch.stack([kp_uv21[..., 1], kp_uv21[..., 0]], dim=-1)
        scoremap = render_gaussian_maps_cuda(coords_hw, map_hw, sigma,
                                             kp_vis21)
        if scoremap_dropout:
            # torch F.dropout(p=0.8) then *0.8 (:549-552), as the RHD path
            scoremap = scoremap * draws.dropout_keep \
                / (1.0 - _P_DROP) * _P_DROP
        out["scoremap"] = scoremap

    if switch_joint_order:
        for key in ("keypoint_vis21", "keypoint_uv21", "keypoint_xyz21"):
            out[key] = out[key][:, _SWITCH_PERM]
    return out


def preprocess_fn_for(raw):
    """The preprocessing of a raw batch's type (the JAX Worker's and
    Evaluator's ``isinstance`` choice)."""
    if isinstance(raw, InterHandRawBatch):
        return preprocess_interhand_batch
    return preprocess_batch


def yiq_hue_rotate(image: torch.Tensor, turns: torch.Tensor) -> torch.Tensor:
    """Hue rotation in YIQ space, batched; ``turns`` in fractions of a
    full rotation (the reference's hue_aug_max is 0.1), on the pipeline's
    [-0.5, 0.5] image range.  The inverse transform is inverted in
    float32, as the JAX function inverts it."""
    to_yiq = torch.tensor(_TO_YIQ, dtype=torch.float32)
    mats = torch.stack([to_yiq, torch.linalg.inv(to_yiq)]).to(image.device)
    theta = turns * 2.0 * math.pi
    yiq = torch.einsum("ij,bhwj->bhwi", mats[0], image + 0.5)
    c = torch.cos(theta)[:, None, None]
    s = torch.sin(theta)[:, None, None]
    i = yiq[..., 1] * c - yiq[..., 2] * s
    q = yiq[..., 1] * s + yiq[..., 2] * c
    yiq = torch.stack([yiq[..., 0], i, q], dim=-1)
    out = torch.einsum("ij,bhwj->bhwi", mats[1], yiq)
    return out.clamp(0.0, 1.0) - 0.5


def _resize_bilinear(image: torch.Tensor, target_hw) -> torch.Tensor:
    """(B, H, W, C) -> (B, th, tw, C): ``jax.image.resize(method=
    "bilinear")``, which widens its triangle kernel by the scale when it
    downsamples (antialias) and renormalises the taps inside the image,
    as torch's antialiased bilinear does."""
    x = F.interpolate(image.permute(0, 3, 1, 2), size=tuple(target_hw),
                      mode="bilinear", align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1)


def scale_to_size(sample: dict, target_hw: tuple[int, int]) -> dict:
    """Resize the full image and uv to ``target_hw`` (the reference's
    scale_to_size branch; like it, returns only image, uv and vis)."""
    _, H, W, _ = sample["image"].shape
    th, tw = target_hw
    uv = sample["keypoint_uv21"]
    uv = torch.stack([uv[..., 0] * (tw / W), uv[..., 1] * (th / H)], dim=-1)
    return {"image": _resize_bilinear(sample["image"], target_hw),
            "keypoint_uv21": uv,
            "keypoint_vis21": sample["keypoint_vis21"]}


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
