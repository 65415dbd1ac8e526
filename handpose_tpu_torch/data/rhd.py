"""Host-side RHD dataset: annotation pickle + batched PNG decode.

Port of ``handpose_tpu/data/rhd.py:43-232``.  Directory layout (RHD's):

  <root>/<set_type>/anno_<set_type>.pickle
  <root>/<set_type>/color/NNNNN.png   (S x S RGB, S = 320)
  <root>/<set_type>/mask/NNNNN.png    (S x S uint8 hand parts)

Each batch decodes its PNGs in one call of the port's own decoder
(``data/imageio.py``, a C++ thread pool).  With ``cache_decoded=True`` the
split is decoded once into two ``.npy`` memmaps next to it, the JAX
package's cache files byte for byte, so a cache written by either package
is read by the other:

  <root>/<set_type>/decoded_color_<S>.u8   (N, S, S, 3) uint8 RGB
  <root>/<set_type>/decoded_mask_<S>.u8    (N, S, S) uint8 parts

Later epochs then read at memory bandwidth.  The cache is built in
chunks of 256 samples into per-process temporary names and moved into
place with ``os.replace``, so concurrent builders never truncate each
other's file.
"""

from __future__ import annotations

import contextlib
import os
import pickle
from typing import Sequence

import numpy as np

from . import imageio
from .preprocess import RawBatch

CACHE_CHUNK = 256


class RHDDataset:
    """Raw-sample access: images as uint8, annotations as float32."""

    def __init__(self, root_dir: str, set_type: str = "training",
                 num_decode_threads: int = 8, image_size: int = 320,
                 cache_decoded: bool = False):
        if set_type not in ("evaluation", "training"):
            raise ValueError(f"set_type {set_type!r} not in "
                             "('evaluation', 'training')")
        self.root_dir = root_dir
        self.set_type = set_type
        self.image_size = image_size
        self.num_decode_threads = num_decode_threads
        d = os.path.join(root_dir, set_type)
        with open(os.path.join(d, f"anno_{set_type}.pickle"), "rb") as f:
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
        self._color_mm = self._mask_mm = None
        if cache_decoded:
            self._build_cache()

    def __len__(self):
        return self._uv_vis.shape[0]

    def _paths(self, indices: Sequence[int]):
        d = os.path.join(self.root_dir, self.set_type)
        names = [f"{int(i):05d}.png" for i in indices]
        return ([os.path.join(d, "color", m) for m in names],
                [os.path.join(d, "mask", m) for m in names])

    def _decode_indices(self, indices: Sequence[int], out=None):
        """(images (B, S, S, 3), masks (B, S, S)) decoded from the PNGs;
        ``out`` is an optional pair of buffers to decode into."""
        S = self.image_size
        color, mask = self._paths(indices)
        imgs = imageio.decode_batch(color, S, S, 3, self.num_decode_threads,
                                    out=None if out is None else out[0])
        masks = imageio.decode_batch(mask, S, S, 1, self.num_decode_threads,
                                     out=None if out is None else out[1])
        return imgs, masks

    def _build_cache(self):
        """Decode every sample once into the uint8 memmaps (reused when
        they are there)."""
        S = self.image_size
        n = len(self)
        d = os.path.join(self.root_dir, self.set_type)
        cpath = os.path.join(d, f"decoded_color_{S}.u8")
        mpath = os.path.join(d, f"decoded_mask_{S}.u8")
        # .npy container: data + header, so compare with >=
        if not (os.path.exists(cpath) and os.path.exists(mpath)
                and os.path.getsize(cpath) >= n * S * S * 3):
            tag = f".tmp.{os.getpid()}.npy"
            with _removed_on_error(cpath + tag, mpath + tag):
                color = np.lib.format.open_memmap(
                    cpath + tag, mode="w+", dtype=np.uint8,
                    shape=(n, S, S, 3))
                mask = np.lib.format.open_memmap(
                    mpath + tag, mode="w+", dtype=np.uint8, shape=(n, S, S))
                for s in range(0, n, CACHE_CHUNK):
                    e = min(s + CACHE_CHUNK, n)
                    # decoded straight into the memmap's pages
                    self._decode_indices(range(s, e),
                                         (color[s:e], mask[s:e]))
                color.flush()
                mask.flush()
                del color, mask
                os.replace(cpath + tag, cpath)
                os.replace(mpath + tag, mpath)
        self._color_mm = np.load(cpath, mmap_mode="r")
        self._mask_mm = np.load(mpath, mmap_mode="r")
        if (self._color_mm.shape != (n, S, S, 3)
                or self._mask_mm.shape != (n, S, S)):
            raise ValueError(
                f"cache shapes {self._color_mm.shape} / {self._mask_mm.shape}"
                f" do not match {n} annotations at {S}x{S}")

    def raw_batch(self, indices: Sequence[int]) -> RawBatch:
        """Decode (or read from the cache) and collate a batch of raw
        samples as numpy arrays."""
        idx = np.asarray(indices)
        if self._color_mm is not None:
            imgs = _memmap_take(self._color_mm, idx)
            masks = _memmap_take(self._mask_mm, idx)
        else:
            imgs, masks = self._decode_indices(idx)
        uv_vis = self._uv_vis[idx]
        return RawBatch(image=imgs, mask=masks,
                        keypoint_uv=np.ascontiguousarray(uv_vis[:, :, :2]),
                        keypoint_vis=uv_vis[:, :, 2] == 1,
                        keypoint_xyz=self._xyz[idx],
                        camera_K=self._K[idx])


@contextlib.contextmanager
def _removed_on_error(*paths):
    """Delete ``paths`` (a cache's temporary files) if the block raises,
    so that a failed build leaves nothing behind."""
    try:
        yield
    except BaseException:
        for p in paths:
            if os.path.exists(p):
                os.remove(p)
        raise


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
    """Write a miniature RHD tree (PNGs and the annotation pickle) with
    plausible geometry, for tests and smoke runs without the 41k-sample
    dataset.

    Draws the same numpy random sequence as the JAX package's
    ``write_synthetic_rhd`` and writes lossless PNGs, so both give the
    same decoded samples for one seed.
    """
    rng = np.random.default_rng(seed)
    d = os.path.join(root_dir, set_type)
    os.makedirs(os.path.join(d, "color"), exist_ok=True)
    os.makedirs(os.path.join(d, "mask"), exist_ok=True)
    S = image_size
    annos = {}
    for i in range(n):
        img = rng.integers(0, 255, (S, S, 3), dtype=np.uint8)
        mask = np.zeros((S, S), np.uint8)
        # one blob of "left hand" parts (2..17), one of "right" (18..33)
        ly, lx = rng.integers(60, 200, 2)
        ry, rx = rng.integers(60, 200, 2)
        sz_l = int(rng.integers(10, 50))
        sz_r = int(rng.integers(10, 50))
        mask[ly:ly + sz_l, lx:lx + sz_l] = rng.integers(2, 18)
        mask[ry:ry + sz_r, rx:rx + sz_r] = rng.integers(18, 34)
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
        imageio.write_png(os.path.join(d, "color", f"{i:05d}.png"), img)
        imageio.write_png(os.path.join(d, "mask", f"{i:05d}.png"), mask)
    with open(os.path.join(d, f"anno_{set_type}.pickle"), "wb") as f:
        pickle.dump(annos, f)
