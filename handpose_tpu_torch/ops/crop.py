"""Visibility-driven hand crop with fixed shapes.

Port of ``handpose_tpu/ops/crop.py:27-214`` (reference
dataloaderRHD.py:293-431).  The window arithmetic reproduces the
reference's int truncation; the resize is two separable batched gathers
(torch ``align_corners=False`` bilinear, and floor-nearest for masks).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class CropParams(NamedTuple):
    y1: torch.Tensor        # (B,) int32 crop top (pixels)
    x1: torch.Tensor        # (B,) int32 crop left
    len_y: torch.Tensor     # (B,) int32 crop height
    len_x: torch.Tensor     # (B,) int32 crop width
    scale_y: torch.Tensor   # (B,) float32 crop_size / len_y
    scale_x: torch.Tensor   # (B,) float32 crop_size / len_x


def _rdiv(a: float, t: torch.Tensor) -> torch.Tensor:
    """``a / t`` rounded once.  Python's ``a / t`` becomes
    ``t.reciprocal() * a`` in torch, which rounds twice and can move a
    truncated crop window by a pixel."""
    return torch.div(torch.tensor(a, dtype=t.dtype, device=t.device), t)


def _sum_in_order(x: torch.Tensor) -> torch.Tensor:
    """(B, N) -> (B,), added left to right as XLA's CPU reduction does.
    The crop window truncates this mean to whole pixels, so a sum taken in
    another order can move the window by one pixel."""
    s = x[:, 0]
    for i in range(1, x.shape[1]):
        s = s + x[:, i]
    return s


def compute_crop_params(keypoint_uv21: torch.Tensor,
                        keypoint_vis21: torch.Tensor,
                        image_hw: tuple[int, int],
                        crop_size: int,
                        center_noise: Optional[torch.Tensor] = None,
                        scale_noise: Optional[torch.Tensor] = None,
                        offset_noise: Optional[torch.Tensor] = None
                        ) -> CropParams:
    """Crop window of reference dataloaderRHD.py:297-343, batched.

    The train-time noises, each optional: ``center_noise`` (B, 2) (y, x)
    is added to the centre before the extent is computed
    (dataloaderRHD.py:304-306); ``scale_noise`` (B,) multiplies the scale
    after its ``[1, 10]`` clip (:308-310); ``offset_noise`` (B, 2) moves
    the centre after the extent (:359-361).
    """
    H, W = image_hw
    u = keypoint_uv21[..., 0]
    v = keypoint_uv21[..., 1]
    vis = keypoint_vis21.reshape(u.shape).bool()
    zero = torch.zeros((), dtype=u.dtype, device=u.device)

    # crop center: mean of keypoints strictly inside the image
    in_img = (u > 0) & (u < W) & (v > 0) & (v < H)
    n_in = in_img.sum(-1, dtype=torch.int32)
    denom = n_in.clamp(min=1).to(u.dtype)
    mean_u = _sum_in_order(torch.where(in_img, u, zero)) / denom
    mean_v = _sum_in_order(torch.where(in_img, v, zero)) / denom
    has_in = n_in > 0
    center_y = torch.where(has_in, mean_v, crop_size / 2.0)
    center_x = torch.where(has_in, mean_u, crop_size / 2.0)
    if center_noise is not None:
        center_y = center_y + center_noise[:, 0]
        center_x = center_x + center_noise[:, 1]

    # crop extent: min/max over visible keypoints, clamped to the image
    big = torch.tensor(1e9, dtype=u.dtype, device=u.device)
    has_vis = vis.any(-1)
    min_y = torch.where(vis, v, big).amin(-1).clamp(min=0.0)
    min_x = torch.where(vis, u, big).amin(-1).clamp(min=0.0)
    max_y = torch.where(vis, v, -big).amax(-1).clamp(max=float(H))
    max_x = torch.where(vis, u, -big).amax(-1).clamp(max=float(W))
    min_y = torch.where(has_vis, min_y, 0.0)
    min_x = torch.where(has_vis, min_x, 0.0)
    max_y = torch.where(has_vis, max_y, float(H))
    max_x = torch.where(has_vis, max_x, float(W))

    ext_y = torch.maximum(max_y - center_y, center_y - min_y)
    ext_x = torch.maximum(max_x - center_x, center_x - min_x)
    crop_size_best = (2.0 * torch.maximum(ext_y, ext_x) + 20.0).clamp(50.0, 500.0)
    scale = _rdiv(crop_size, crop_size_best).clamp(1.0, 10.0)
    if scale_noise is not None:
        scale = scale * scale_noise
    if offset_noise is not None:
        center_y = center_y + offset_noise[:, 0]
        center_x = center_x + offset_noise[:, 1]
    # int() truncation of python / torch (dataloaderRHD.py:364)
    css = torch.trunc(_rdiv(crop_size, scale)).to(torch.int32)

    # start clamped inside the image, window length >= 1: a noisy centre
    # can land past the border
    y1 = torch.trunc(center_y - css // 2).to(torch.int32).clamp(0, H - 1)
    x1 = torch.trunc(center_x - css // 2).to(torch.int32).clamp(0, W - 1)
    y2 = torch.where(y1 + css < H, y1 + css, H)
    x2 = torch.where(x1 + css < W, x1 + css, W)
    len_y = (y2 - y1).clamp(min=1)
    len_x = (x2 - x1).clamp(min=1)
    scale_y = _rdiv(crop_size, len_y.to(u.dtype))
    scale_x = _rdiv(crop_size, len_x.to(u.dtype))
    return CropParams(y1, x1, len_y, len_x, scale_y, scale_x)


def _source_coords(starts: torch.Tensor, lengths: torch.Tensor,
                   out_size: int, max_idx: int):
    """Per-sample bilinear source indices and weights along one axis:
    f = max(0, (o + 0.5) * len / out - 0.5), i0 = floor(f), i1 = i0 + 1,
    both clamped to the window and the image."""
    o = torch.arange(out_size, dtype=torch.float32, device=starts.device)[None, :]
    lf = lengths.to(torch.float32)[:, None]
    f = ((o + 0.5) * lf / out_size - 0.5).clamp(min=0.0)
    i0 = torch.minimum(torch.floor(f).to(torch.int64), lengths[:, None] - 1)
    i1 = torch.minimum(i0 + 1, lengths[:, None] - 1)
    w = f - i0.to(torch.float32)
    g0 = (starts[:, None] + i0).clamp(0, max_idx - 1)
    g1 = (starts[:, None] + i1).clamp(0, max_idx - 1)
    return g0, g1, w


def _take_rows(images: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C), (B, S) -> (B, S, W, C)."""
    B, _, W, C = images.shape
    return torch.gather(images, 1, idx[:, :, None, None].expand(B, -1, W, C))


def _take_cols(images: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, S, W, C), (B, S') -> (B, S, S', C)."""
    B, S, _, C = images.shape
    return torch.gather(images, 2, idx[:, None, :, None].expand(B, S, -1, C))


def crop_resize_bilinear(images: torch.Tensor, params: CropParams,
                         out_size: int) -> torch.Tensor:
    """(B, H, W, C) float -> (B, out_size, out_size, C); matches torch
    ``F.interpolate(img[y1:y2, x1:x2], (S, S), bilinear,
    align_corners=False)`` per sample."""
    _, H, W, _ = images.shape
    y0, y1i, wy = _source_coords(params.y1, params.len_y, out_size, H)
    x0, x1i, wx = _source_coords(params.x1, params.len_x, out_size, W)
    rows0 = _take_rows(images, y0)
    rows1 = _take_rows(images, y1i)
    rows = rows0 + (rows1 - rows0) * wy[:, :, None, None]
    cols0 = _take_cols(rows, x0)
    cols1 = _take_cols(rows, x1i)
    return cols0 + (cols1 - cols0) * wx[:, None, :, None]


def crop_resize_nearest(images: torch.Tensor, params: CropParams,
                        out_size: int) -> torch.Tensor:
    """Nearest-neighbour variant for masks, (B, H, W[, C]); torch
    'nearest': src = floor(o * len / out)."""
    H, W = images.shape[1:3]
    squeeze = images.ndim == 3
    if squeeze:
        images = images[..., None]
    o = torch.arange(out_size, dtype=torch.float32, device=images.device)[None, :]

    def idx(starts, lengths, max_idx):
        f = torch.floor(o * lengths.to(torch.float32)[:, None] / out_size)
        i = torch.minimum(f.to(torch.int64), lengths[:, None] - 1)
        return (starts[:, None] + i).clamp(0, max_idx - 1)

    rows = _take_rows(images, idx(params.y1, params.len_y, H))
    out = _take_cols(rows, idx(params.x1, params.len_x, W))
    return out[..., 0] if squeeze else out


def crop_intrinsics(K: torch.Tensor, params: CropParams) -> torch.Tensor:
    """K' = T(-x1*sx, -y1*sy) @ diag(sx, sy, 1) @ K, batched
    (dataloaderRHD.py:330-339)."""
    sx = params.scale_x
    sy = params.scale_y
    tx = params.x1.to(sx.dtype) * sx
    ty = params.y1.to(sy.dtype) * sy
    z = torch.zeros_like(sx)
    o = torch.ones_like(sx)
    M = torch.stack([
        torch.stack([sx, z, -tx], dim=-1),
        torch.stack([z, sy, -ty], dim=-1),
        torch.stack([z, z, o], dim=-1),
    ], dim=-2)
    return M @ K


def crop_uv(uv21: torch.Tensor, params: CropParams) -> torch.Tensor:
    """Map pixel coords into the crop (dataloaderRHD.py:391-394)."""
    u = (uv21[..., 0] - params.x1[:, None].to(uv21.dtype)) * params.scale_x[:, None]
    v = (uv21[..., 1] - params.y1[:, None].to(uv21.dtype)) * params.scale_y[:, None]
    return torch.stack([u, v], dim=-1)
