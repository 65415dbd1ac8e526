"""InterHand-style patch preprocessing.

Port of ``handpose_tpu/ops/patch.py`` (reference utils/preprocessing.py):

* host-side numpy, kept as the JAX module's own numpy code so their
  results are bit-equal: the bbox helpers ``get_bbox`` and
  ``process_bbox`` (they run once per annotation while the dataset
  parses its json), the augmentation draws ``get_aug_config`` and the
  affine transforms ``gen_trans_from_patch`` and ``trans_point2d``;
* on the tensors' device: the batched bilinear affine warp
  :func:`affine_warp_bilinear` (cv2.warpAffine's counterpart) and the
  heatmap-space transform :func:`transform_input_to_output_space`.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def get_bbox(joint_img: np.ndarray, joint_valid: np.ndarray) -> np.ndarray:
    """(x, y, w, h) around the valid joints, widened by 1.2."""
    x = joint_img[:, 0][joint_valid == 1]
    y = joint_img[:, 1][joint_valid == 1]
    xmin, xmax = x.min(), x.max()
    ymin, ymax = y.min(), y.max()
    xc, w = (xmin + xmax) / 2.0, xmax - xmin
    yc, h = (ymin + ymax) / 2.0, ymax - ymin
    return np.array([xc - 0.6 * w, yc - 0.6 * h, 1.2 * w, 1.2 * h],
                    np.float32)


def process_bbox(bbox: np.ndarray,
                 original_img_shape: Tuple[int, int],
                 input_img_shape: Tuple[int, int] = (256, 256)) -> np.ndarray:
    """The bbox brought to the input's aspect ratio about its centre, then
    widened by 1.25 (``original_img_shape`` is unused, as in the
    reference)."""
    bbox = np.asarray(bbox, np.float32).copy()
    w, h = bbox[2], bbox[3]
    c_x = bbox[0] + w / 2.0
    c_y = bbox[1] + h / 2.0
    aspect = input_img_shape[1] / input_img_shape[0]
    if w > aspect * h:
        h = w / aspect
    elif w < aspect * h:
        w = h * aspect
    bbox[2] = w * 1.25
    bbox[3] = h * 1.25
    bbox[0] = c_x - bbox[2] / 2.0
    bbox[1] = c_y - bbox[3] / 2.0
    return bbox


def get_aug_config(rng: np.random.Generator):
    """Train-time augmentation parameters (reference
    preprocessing.py:33-48): (trans, scale, rot, do_flip, color_scale).
    Python evaluates the rotation's gate before its normal draw, and
    draws the normal only when the gate passes, so one generator state
    gives the JAX function's five results."""
    trans_factor, scale_factor, rot_factor, color_factor = 0.15, 0.25, 45, 0.2
    trans = [rng.uniform(-trans_factor, trans_factor),
             rng.uniform(-trans_factor, trans_factor)]
    scale = float(np.clip(rng.standard_normal(), -1.0, 1.0)) * scale_factor + 1.0
    rot = float(np.clip(rng.standard_normal(), -2.0, 2.0)) * rot_factor \
        if rng.uniform() <= 0.6 else 0.0
    do_flip = rng.uniform() <= 0.5
    color_scale = rng.uniform(1 - color_factor, 1 + color_factor, 3)
    return trans, scale, rot, do_flip, color_scale


def _rotate_2d(pt, rot_rad):
    sn, cs = math.sin(rot_rad), math.cos(rot_rad)
    return np.array([pt[0] * cs - pt[1] * sn, pt[0] * sn + pt[1] * cs],
                    np.float32)


def gen_trans_from_patch(c_x, c_y, src_w, src_h, dst_w, dst_h, scale, rot,
                         inv=False) -> np.ndarray:
    """2x3 float32 affine from the source window (centre, size, scale,
    rotation in degrees) to the (dst_w, dst_h) patch, or back with
    ``inv`` (reference preprocessing.py:192-232), solved in numpy."""
    sw, sh = src_w * scale, src_h * scale
    rot_rad = math.pi * rot / 180.0
    src_center = np.array([c_x, c_y], np.float32)
    src_down = _rotate_2d(np.array([0, sh * 0.5], np.float32), rot_rad)
    src_right = _rotate_2d(np.array([sw * 0.5, 0], np.float32), rot_rad)
    dst_center = np.array([dst_w * 0.5, dst_h * 0.5], np.float32)
    dst_down = np.array([0, dst_h * 0.5], np.float32)
    dst_right = np.array([dst_w * 0.5, 0], np.float32)
    src = np.stack([src_center, src_center + src_down,
                    src_center + src_right])
    dst = np.stack([dst_center, dst_center + dst_down,
                    dst_center + dst_right])
    if inv:
        src, dst = dst, src
    # solve A [src | 1]^T = dst^T for the 2x3 affine A
    M = np.concatenate([src, np.ones((3, 1), np.float32)], axis=1)
    A = np.linalg.solve(M, dst).T
    return A.astype(np.float32)


def trans_point2d(pt, trans):
    """A 2-D point through a 2x3 affine."""
    p = np.array([pt[0], pt[1], 1.0], np.float32)
    return (trans @ p)[:2]


def affine_warp_bilinear(images: torch.Tensor, trans: torch.Tensor,
                         out_shape: Tuple[int, int]) -> torch.Tensor:
    """Batched inverse-mapped bilinear warp: (B, H, W, C) images and
    (B, 2, 3) source-to-patch affines (as :func:`gen_trans_from_patch`
    gives them) -> (B, out_h, out_w, C).  Each output pixel samples the
    source at the inverted affine's image of it; a tap outside the source
    reads 0, cv2's default border.

    The affine's inverse and the sampling positions are computed in
    float64 and rounded once to ``trans``'s dtype: chained in float32
    (the JAX function's way) the positions of a patch that reaches far
    from the source's origin are a few ulps off, and the bilinear weights
    carry that into the output.
    """
    B, H, W, C = images.shape
    oh, ow = out_shape
    f64 = dict(dtype=torch.float64, device=trans.device)
    A = trans[:, :, :2].to(torch.float64)
    t = trans[:, :, 2].to(torch.float64)
    Ainv = torch.linalg.inv(A)
    tinv = -torch.einsum("bij,bj->bi", Ainv, t)
    ys, xs = torch.meshgrid(torch.arange(oh, **f64), torch.arange(ow, **f64),
                            indexing="ij")
    dst = torch.stack([xs, ys], dim=-1).reshape(-1, 2)           # (P, 2)
    src = (torch.einsum("bij,pj->bpi", Ainv, dst)
           + tinv[:, None, :]).to(trans.dtype)
    sx, sy = src[..., 0], src[..., 1]

    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = sx - x0
    wy = sy - y0
    flat = images.reshape(B, H * W, C)

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        yc = yi.clamp(0, H - 1).to(torch.int64)
        xc = xi.clamp(0, W - 1).to(torch.int64)
        idx = (yc * W + xc)[..., None].expand(-1, -1, C)
        return torch.gather(flat, 1, idx) * valid[..., None]

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    top = v00 + (v01 - v00) * wx[..., None]
    bot = v10 + (v11 - v10) * wx[..., None]
    out = top + (bot - top) * wy[..., None]
    return out.reshape(B, oh, ow, C)


def transform_input_to_output_space(joint_coord: torch.Tensor,
                                    joint_valid: torch.Tensor,
                                    rel_root_depth, root_valid,
                                    root_joint_idx: dict, joint_type: dict,
                                    input_img_shape=(256, 256),
                                    output_hm_shape=(64, 64, 64),
                                    bbox_3d_size=400.0,
                                    bbox_3d_size_root=400.0,
                                    output_root_hm_shape=64):
    """(..., N, 3) uvz in input pixels -> heatmap-voxel coords, the
    joints' validity inside the depth range, the root depth in its
    heatmap bins and its validity (reference preprocessing.py:87-120).
    Each hand's depth is taken relative to its own root
    (``root_joint_idx``), the hand of a joint given by ``joint_type``."""
    jc = joint_coord
    x = jc[..., 0] / input_img_shape[1] * output_hm_shape[2]
    y = jc[..., 1] / input_img_shape[0] * output_hm_shape[1]
    z = jc[..., 2]
    zr = z - z[..., root_joint_idx["right"]][..., None]
    zl = z - z[..., root_joint_idx["left"]][..., None]
    is_right = torch.zeros(jc.shape[-2], dtype=torch.bool, device=jc.device)
    is_right[torch.as_tensor(joint_type["right"], device=jc.device)] = True
    z = torch.where(is_right, zr, zl)
    z = (z / (bbox_3d_size / 2) + 1) / 2.0 * output_hm_shape[0]
    valid = joint_valid * ((z >= 0) & (z < output_hm_shape[0]))
    rel_root_depth = (torch.as_tensor(rel_root_depth, device=jc.device)
                      / (bbox_3d_size_root / 2) + 1) / 2.0 \
        * output_root_hm_shape
    root_valid = root_valid * ((rel_root_depth >= 0) &
                               (rel_root_depth < output_root_hm_shape))
    return torch.stack([x, y, z], dim=-1), valid, rel_root_depth, root_valid
