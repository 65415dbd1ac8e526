"""RHD-shaped samples made from the seed, and the RHD tree they are
written as.

The geometry is that of the repository's synthetic RHD writer
(``handpose_tpu_torch/data/rhd.py::write_synthetic_rhd``), frozen here:
two hands of 21 keypoints about 0.5-0.8 m in front of a pinhole camera
of focal length 300 +- 20 px, each keypoint visible with probability
0.75, and a segmentation mask with one square blob of left-hand parts
(2..17) and one of right-hand parts (18..33).  The pixels are noise in
8x8 blocks (the preprocessing and the networks do the same work on any
pixels, and blocks keep the PNG tree small on disk).

Every draw is made on ``generator``'s device in a few large calls, so
the same seed gives the same samples.
"""

from __future__ import annotations

import os
import pickle
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

IMAGE_SIZE = 320
BLOCK = 8


def make_samples(n: int, generator: torch.Generator,
                 image_size: int = IMAGE_SIZE) -> dict:
    """``n`` samples on ``generator``'s device: ``image`` (n, S, S, 3)
    uint8, ``mask`` (n, S, S) uint8, ``uv_vis`` (n, 42, 3), ``xyz`` (n,
    42, 3) and ``K`` (n, 3, 3) float32."""
    dev = generator.device
    S = image_size

    def uniform(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                           device=dev)

    def integers(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=generator, device=dev)

    blocks = integers(0, 255, n, S // BLOCK, S // BLOCK, 3).to(torch.uint8)
    image = blocks.repeat_interleave(BLOCK, 1).repeat_interleave(BLOCK, 2)

    # one blob of left-hand parts, then one of right-hand parts over it
    corner = integers(60, 200, n, 2, 2)            # (n, hand, (y, x))
    size = integers(10, 50, n, 2)
    part = torch.stack([integers(2, 18, n), integers(18, 34, n)], 1)
    ar = torch.arange(S, device=dev)
    mask = torch.zeros((n, S, S), dtype=torch.uint8, device=dev)
    for h in range(2):
        y0, x0 = corner[:, h, 0, None], corner[:, h, 1, None]
        rows = (ar >= y0) & (ar < y0 + size[:, h, None])
        cols = (ar >= x0) & (ar < x0 + size[:, h, None])
        inside = rows[:, :, None] & cols[:, None, :]
        mask = torch.where(inside, part[:, h, None, None].to(torch.uint8),
                           mask)

    f = 300.0 + uniform(n, lo=-20.0, hi=20.0)
    K = torch.zeros((n, 3, 3), device=dev)
    K[:, 0, 0] = f
    K[:, 1, 1] = f
    K[:, 0, 2] = S / 2
    K[:, 1, 2] = S / 2
    K[:, 2, 2] = 1.0
    centre = torch.stack([uniform(n, 2, lo=-0.08, hi=0.08),
                          uniform(n, 2, lo=-0.08, hi=0.08),
                          uniform(n, 2, lo=0.5, hi=0.8)], -1)
    pts = centre[:, :, None, :] + 0.04 * torch.randn(
        (n, 2, 21, 3), generator=generator, device=dev)
    pts[..., 2] = pts[..., 2].abs() + 0.3
    xyz = pts.reshape(n, 42, 3)
    uvw = xyz @ K.transpose(1, 2)
    uv = uvw[..., :2] / uvw[..., 2:3]
    vis = (uniform(n, 42) > 0.25).to(torch.float32)
    return {"image": image, "mask": mask,
            "uv_vis": torch.cat([uv, vis[..., None]], -1),
            "xyz": xyz, "K": K}


def raw_fields(samples: dict, idx=None) -> tuple:
    """(image, mask, keypoint_uv, keypoint_vis, keypoint_xyz, camera_K):
    the fields of an RHD raw batch, as the RHD loader collates them."""
    s = samples if idx is None else {k: v[idx] for k, v in samples.items()}
    return (s["image"], s["mask"], s["uv_vis"][..., :2].contiguous(),
            s["uv_vis"][..., 2] == 1, s["xyz"], s["K"])


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_bytes(img: np.ndarray, level: int = 1) -> bytes:
    """An (H, W, 3) RGB or (H, W) gray uint8 image as an 8-bit PNG, every
    row with filter 0, deflated at ``level``."""
    H, W = img.shape[:2]
    C = 1 if img.ndim == 2 else img.shape[2]
    rows = np.zeros((H, W * C + 1), np.uint8)
    rows[:, 1:] = img.reshape(H, W * C)
    ihdr = struct.pack(">IIBBBBB", W, H, 8, 0 if C == 1 else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _png_chunk(b"IEND", b""))


def write_rhd_tree(root: str, split: str, samples: dict,
                   threads: int = 8) -> None:
    """``samples`` (host numpy arrays of :func:`make_samples`' fields) as
    RHD's layout: ``<root>/<split>/color/NNNNN.png``, ``mask/NNNNN.png``
    and ``anno_<split>.pickle``."""
    d = os.path.join(root, split)
    for sub in ("color", "mask"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)

    def write(i):
        for sub, key in (("color", "image"), ("mask", "mask")):
            with open(os.path.join(d, sub, f"{i:05d}.png"), "wb") as f:
                f.write(png_bytes(samples[key][i]))

    n = len(samples["image"])
    with ThreadPoolExecutor(threads) as ex:
        for _ in ex.map(write, range(n)):
            pass
    annos = {i: {"uv_vis": samples["uv_vis"][i], "xyz": samples["xyz"][i],
                 "K": samples["K"][i]} for i in range(n)}
    with open(os.path.join(d, f"anno_{split}.pickle"), "wb") as f:
        pickle.dump(annos, f)
