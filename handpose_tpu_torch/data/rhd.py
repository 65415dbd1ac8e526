"""Host-side RHD dataset on the decoded uint8 cache.

Port of the cache read path of ``handpose_tpu/data/rhd.py:43-185``.  The
JAX package decodes the PNGs once into two ``.npy`` memmaps next to the
split (``cache_decoded=True``):

  <root>/<set_type>/anno_<set_type>.pickle
  <root>/<set_type>/decoded_color_<S>.u8   (N, S, S, 3) uint8 RGB
  <root>/<set_type>/decoded_mask_<S>.u8    (N, S, S) uint8 parts

This dataset reads those files and needs no image decoder.  PNG decode
waits for a later slice; :func:`write_synthetic_rhd` writes a tree in this
form directly.
"""

from __future__ import annotations

import os
import pickle
from typing import Sequence

import numpy as np

from .preprocess import RawBatch


def _cache_paths(root_dir: str, set_type: str, image_size: int):
    d = os.path.join(root_dir, set_type)
    return (os.path.join(d, f"anno_{set_type}.pickle"),
            os.path.join(d, f"decoded_color_{image_size}.u8"),
            os.path.join(d, f"decoded_mask_{image_size}.u8"))


class RHDDataset:
    """Raw-sample access: images as uint8, annotations as float32."""

    def __init__(self, root_dir: str, set_type: str = "training",
                 image_size: int = 320):
        if set_type not in ("evaluation", "training"):
            raise ValueError(f"set_type {set_type!r} not in "
                             "('evaluation', 'training')")
        self.root_dir = root_dir
        self.set_type = set_type
        self.image_size = image_size
        anno_path, cpath, mpath = _cache_paths(root_dir, set_type, image_size)
        with open(anno_path, "rb") as f:
            annotations = pickle.load(f)
        n = len(annotations)
        self._uv_vis = np.stack([
            np.asarray(annotations[i]["uv_vis"], np.float32)
            for i in range(n)]) if n else np.zeros((0, 42, 3), np.float32)
        self._xyz = np.stack([
            np.asarray(annotations[i]["xyz"], np.float32)
            for i in range(n)]) if n else np.zeros((0, 42, 3), np.float32)
        self._K = np.stack([
            np.asarray(annotations[i]["K"], np.float32)
            for i in range(n)]) if n else np.zeros((0, 3, 3), np.float32)
        for path in (cpath, mpath):
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"{path} is missing.  This dataset reads only the "
                    "decoded uint8 cache; build it once with the JAX "
                    "package: handpose_tpu.data.rhd.RHDDataset(root, "
                    f"{set_type!r}, cache_decoded=True)")
        self._color_mm = np.load(cpath, mmap_mode="r")
        self._mask_mm = np.load(mpath, mmap_mode="r")
        S = image_size
        if (self._color_mm.shape != (n, S, S, 3)
                or self._mask_mm.shape != (n, S, S)):
            raise ValueError(
                f"cache shapes {self._color_mm.shape} / {self._mask_mm.shape}"
                f" do not match {n} annotations at {S}x{S}")

    def __len__(self):
        return self._uv_vis.shape[0]

    def raw_batch(self, indices: Sequence[int]) -> RawBatch:
        """Collate a batch of raw samples as numpy arrays."""
        idx = np.asarray(indices)
        uv_vis = self._uv_vis[idx]
        return RawBatch(image=_memmap_take(self._color_mm, idx),
                        mask=_memmap_take(self._mask_mm, idx),
                        keypoint_uv=np.ascontiguousarray(uv_vis[:, :, :2]),
                        keypoint_vis=uv_vis[:, :, 2] == 1,
                        keypoint_xyz=self._xyz[idx],
                        camera_K=self._K[idx])


def _memmap_take(mm, idx: np.ndarray) -> np.ndarray:
    """Batch gather from a sample-major memmap: runs of consecutive
    indices are read as slices (bulk copies), mostly scattered index sets
    with one fancy index."""
    if idx.size == 0:
        return np.asarray(mm[idx])
    starts = np.flatnonzero(np.r_[True, np.diff(idx) != 1])
    if starts.size > max(4, idx.size // 8):
        return np.asarray(mm[idx])
    out = np.empty((idx.size,) + mm.shape[1:], mm.dtype)
    bounds = np.r_[starts, idx.size]
    for a, b in zip(bounds[:-1], bounds[1:]):
        out[a:b] = mm[idx[a]:idx[a] + (b - a)]
    return out


def write_synthetic_rhd(root_dir: str, set_type: str = "evaluation",
                        n: int = 8, seed: int = 0,
                        image_size: int = 320) -> None:
    """Write a miniature RHD tree in the cache form: the annotation pickle
    and the two decoded ``.npy`` files, no PNGs.

    Draws the same numpy random sequence as the JAX package's
    ``write_synthetic_rhd``, so both give the same samples for one seed.
    """
    rng = np.random.default_rng(seed)
    _, cpath, mpath = _cache_paths(root_dir, set_type, image_size)
    os.makedirs(os.path.dirname(cpath), exist_ok=True)
    S = image_size
    color = np.lib.format.open_memmap(cpath, mode="w+", dtype=np.uint8,
                                      shape=(n, S, S, 3))
    masks = np.lib.format.open_memmap(mpath, mode="w+", dtype=np.uint8,
                                      shape=(n, S, S))
    annos = {}
    for i in range(n):
        color[i] = rng.integers(0, 255, (S, S, 3), dtype=np.uint8)
        mask = np.zeros((S, S), np.uint8)
        # one blob of "left hand" parts (2..17), one of "right" (18..33)
        ly, lx = rng.integers(60, 200, 2)
        ry, rx = rng.integers(60, 200, 2)
        sz_l = int(rng.integers(10, 50))
        sz_r = int(rng.integers(10, 50))
        mask[ly:ly + sz_l, lx:lx + sz_l] = rng.integers(2, 18)
        mask[ry:ry + sz_r, rx:rx + sz_r] = rng.integers(18, 34)
        masks[i] = mask
        f = 300.0 + rng.uniform(-20, 20)
        K = np.array([[f, 0, S / 2], [0, f, S / 2], [0, 0, 1]], np.float32)
        xyz = np.zeros((42, 3), np.float32)
        for h in range(2):
            c = np.array([rng.uniform(-0.08, 0.08), rng.uniform(-0.08, 0.08),
                          rng.uniform(0.5, 0.8)])
            pts = c + rng.normal(scale=0.04, size=(21, 3))
            pts[:, 2] = np.abs(pts[:, 2]) + 0.3
            xyz[h * 21:(h + 1) * 21] = pts
        uvw = xyz @ K.T
        uv = uvw[:, :2] / uvw[:, 2:3]
        vis = rng.uniform(size=(42,)) > 0.25
        annos[i] = {
            "uv_vis": np.concatenate([uv, vis[:, None].astype(np.float32)],
                                     axis=1),
            "xyz": xyz,
            "K": K,
        }
    color.flush()
    masks.flush()
    del color, masks
    with open(os.path.join(root_dir, set_type, f"anno_{set_type}.pickle"),
              "wb") as f:
        pickle.dump(annos, f)
