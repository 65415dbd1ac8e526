"""RHD preprocessing of the serving and training paths, plain.

What the reference's ``dataloaderRHD.py`` does to one sample (hongrui16/
3DHandPoseEstimation, as the repository's ports batch it), without the
train-time augmentations: the dominant hand from the part mask, left
hands mirrored, root-relative coordinates normalised by the root to
middle-MCP bone, the canonical frame, the hand crop (window from the
visible keypoints, bilinear resize, intrinsics rewritten), the Gaussian
scoremaps of the cropped keypoints, and the MANO joint order for the
keypoints' visibility, uv and xyz.

The crop window truncates to whole pixels, so its arithmetic is kept
step for step (a mean summed left to right, each division rounded
once): a window one pixel off would move every pixel of the crop.
"""

from __future__ import annotations

import math

import torch

# MANO <-> RHD joint order (reference dataloaderRHD.py:587-591)
SWITCH_PERM = [0] + [i + d for i in (1, 5, 9, 13, 17) for d in (3, 2, 1, 0)]


def _rdiv(a: float, t: torch.Tensor) -> torch.Tensor:
    return torch.div(torch.tensor(a, dtype=t.dtype, device=t.device), t)


def _rot(axis: str, a: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    rows = {"x": [o, z, z, z, c, -s, z, s, c],
            "y": [c, z, s, z, o, z, -s, z, c],
            "z": [c, -s, z, s, c, z, z, z, o]}[axis]
    m = torch.stack(rows, -1)
    return m.reshape(m.shape[:-1] + (3, 3))


def _atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """atan2 in (-pi, pi] through atan, with the reference's 1e-8 on x
    (utils/canonical_trafo.py:23-40)."""
    t = torch.atan(y / (x + 1e-8))
    t = torch.where(x + 1e-8 < 0.0, t + math.pi, t)
    t = torch.where(t < 0.0, t + 2.0 * math.pi, t)
    return torch.where(t > math.pi, t - 2.0 * math.pi, t)


def canonical(xyz: torch.Tensor):
    """(B, 21, 3) -> (canonical coords, rotation R) with canonical =
    (xyz - xyz[:, 0]) @ R (reference utils/canonical_trafo.py:93-184):
    the middle MCP (12) rotated onto -y, the pinky root (20) fixing the
    rotation about y."""
    t = xyz - xyz[:, :1]
    p = t[:, 12]
    r1 = _rot("z", _atan2(p[:, 0], p[:, 1]))
    t = t @ r1.transpose(-1, -2)
    p = t[:, 12]
    r2 = _rot("x", -_atan2(p[:, 2], p[:, 1]) + math.pi)
    t = t @ r2.transpose(-1, -2)
    p = t[:, 20]
    r3 = _rot("y", _atan2(p[:, 2], p[:, 0]))
    return t @ r3.transpose(-1, -2), r1 @ r2 @ r3


def _crop_window(uv, vis, H, W, crop):
    """(y1, x1, len_y, len_x, scale_y, scale_x) of reference
    dataloaderRHD.py:297-364."""
    u, v = uv[..., 0], uv[..., 1]
    zero = torch.zeros((), device=u.device)
    inside = (u > 0) & (u < W) & (v > 0) & (v < H)
    n_in = inside.sum(-1, dtype=torch.int32)
    denom = n_in.clamp(min=1).to(u.dtype)
    su = torch.where(inside, u, zero)
    sv = torch.where(inside, v, zero)
    acc_u, acc_v = su[:, 0], sv[:, 0]
    for i in range(1, u.shape[1]):
        acc_u = acc_u + su[:, i]
        acc_v = acc_v + sv[:, i]
    cy = torch.where(n_in > 0, acc_v / denom, crop / 2.0)
    cx = torch.where(n_in > 0, acc_u / denom, crop / 2.0)
    big = torch.tensor(1e9, device=u.device)
    any_vis = vis.any(-1)
    min_y = torch.where(any_vis, torch.where(vis, v, big).amin(-1)
                        .clamp(min=0.0), 0.0)
    min_x = torch.where(any_vis, torch.where(vis, u, big).amin(-1)
                        .clamp(min=0.0), 0.0)
    max_y = torch.where(any_vis, torch.where(vis, v, -big).amax(-1)
                        .clamp(max=float(H)), float(H))
    max_x = torch.where(any_vis, torch.where(vis, u, -big).amax(-1)
                        .clamp(max=float(W)), float(W))
    ext = torch.maximum(torch.maximum(max_y - cy, cy - min_y),
                        torch.maximum(max_x - cx, cx - min_x))
    best = (2.0 * ext + 20.0).clamp(50.0, 500.0)
    scale = _rdiv(crop, best).clamp(1.0, 10.0)
    side = torch.trunc(_rdiv(crop, scale)).to(torch.int32)
    y1 = torch.trunc(cy - side // 2).to(torch.int32).clamp(0, H - 1)
    x1 = torch.trunc(cx - side // 2).to(torch.int32).clamp(0, W - 1)
    len_y = (torch.where(y1 + side < H, y1 + side, H) - y1).clamp(min=1)
    len_x = (torch.where(x1 + side < W, x1 + side, W) - x1).clamp(min=1)
    return (y1, x1, len_y, len_x, _rdiv(crop, len_y.to(u.dtype)),
            _rdiv(crop, len_x.to(u.dtype)))


def _bilinear_crop(image, y1, x1, len_y, len_x, crop):
    """Each sample's window resized to crop x crop as torch's
    ``F.interpolate(bilinear, align_corners=False)`` resizes it."""
    B, H, W, C = image.shape

    def taps(start, length, limit):
        o = torch.arange(crop, dtype=torch.float32, device=image.device)
        f = ((o[None] + 0.5) * length.to(torch.float32)[:, None] / crop
             - 0.5).clamp(min=0.0)
        i0 = torch.minimum(f.floor().long(), length[:, None] - 1)
        i1 = torch.minimum(i0 + 1, length[:, None] - 1)
        return ((start[:, None] + i0).clamp(0, limit - 1),
                (start[:, None] + i1).clamp(0, limit - 1),
                f - i0.to(torch.float32))

    r0, r1, wy = taps(y1, len_y, H)
    c0, c1, wx = taps(x1, len_x, W)
    b = torch.arange(B, device=image.device)[:, None]
    top = image[b, r0]                                   # (B, crop, W, C)
    rows = top + (image[b, r1] - top) * wy[:, :, None, None]
    b = b[:, None]
    left = rows[b, torch.arange(crop, device=image.device)[None, :, None],
                c0[:, None, :]]
    right = rows[b, torch.arange(crop, device=image.device)[None, :, None],
                 c1[:, None, :]]
    return left + (right - left) * wx[:, None, :, None]


def scoremaps(coords_hw, vis, size, sigma):
    """(B, K, H, W) Gaussians at the integer-truncated (row, col) of each
    visible keypoint strictly inside the map, 0 elsewhere (reference
    dataloaderRHD.py:538-584)."""
    H, W = size
    c = coords_hw.to(torch.int32).to(torch.float32)
    cy, cx = c[..., 0], c[..., 1]
    on = vis & (cy > 0) & (cy < H - 1) & (cx > 0) & (cx < W - 1)
    inv = 1.0 / (sigma * sigma)
    ys = torch.arange(H, dtype=torch.float32, device=c.device)
    xs = torch.arange(W, dtype=torch.float32, device=c.device)
    gy = torch.exp(-((ys - cy[..., None]) ** 2) * inv)
    gx = torch.exp(-((xs - cx[..., None]) ** 2) * inv)
    return gy[..., :, None] * gx[..., None, :] * on[..., None, None]


def preprocess(raw, crop: int = 256, sigma: float = 25.0) -> dict:
    """An RHD raw batch (image (B, H, W, 3) uint8, mask (B, H, W), uv
    (B, 42, 2), vis (B, 42) bool, xyz (B, 42, 3), K (B, 3, 3)) -> what
    the networks, the losses and serving read: ``image_crop`` (B, crop,
    crop, 3), ``scoremap`` (B, 21, crop, crop), ``scale`` (B, 1),
    ``root`` (B, 3), ``can`` and ``rot`` (the canonical coords and the
    rotation back), ``vis21`` (B, 21, 1) in MANO order, ``K`` of the
    crop."""
    image_u8, mask, uv, vis, xyz, K = raw
    B, H, W, _ = image_u8.shape
    image = image_u8.to(torch.float32) / 255.0 - 0.5
    vis = vis.reshape(B, -1).bool()
    left = ((mask > 1) & (mask < 18)).sum((1, 2)) > (mask > 17).sum((1, 2))
    lh = left[:, None, None]
    xyz21 = torch.where(lh, xyz[:, :21], xyz[:, 21:])
    xyz21 = torch.where(lh, xyz21 * torch.tensor([-1.0, 1.0, 1.0],
                                                 device=xyz.device), xyz21)
    vis21 = torch.where(left[:, None], vis[:, :21], vis[:, 21:])
    uv21 = torch.where(lh, uv[:, :21], uv[:, 21:])
    root = xyz21[:, 0]
    rel = xyz21 - root[:, None]
    scale = torch.sqrt((rel[:, 12] ** 2).sum(-1))
    can, rot = canonical(rel / scale[:, None, None])
    image = torch.where(left[:, None, None, None], image.flip(2), image)
    uv21 = torch.stack([torch.where(left[:, None], W - uv21[..., 0],
                                    uv21[..., 0]), uv21[..., 1]], -1)
    y1, x1, len_y, len_x, sy, sx = _crop_window(uv21, vis21, H, W, crop)
    crop_img = _bilinear_crop(image, y1, x1, len_y, len_x, crop)
    u = (uv21[..., 0] - x1[:, None].to(torch.float32)) * sx[:, None]
    v = (uv21[..., 1] - y1[:, None].to(torch.float32)) * sy[:, None]
    z, o = torch.zeros_like(sx), torch.ones_like(sx)
    M = torch.stack([torch.stack([sx, z, -x1.to(torch.float32) * sx], -1),
                     torch.stack([z, sy, -y1.to(torch.float32) * sy], -1),
                     torch.stack([z, z, o], -1)], -2)
    maps = scoremaps(torch.stack([v, u], -1), vis21, (crop, crop), sigma)
    return {"image_crop": crop_img, "scoremap": maps,
            "scale": scale[:, None], "root": root, "can": can,
            "rot": rot.transpose(-1, -2),
            "vis21": vis21[:, SWITCH_PERM, None], "K": M @ K}
