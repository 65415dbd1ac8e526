"""Keypoint, skeleton, scoremap and mesh visualisation, on the host.

Port of ``handpose_tpu/utils/vis.py`` (reference utils/plot_anno.py:9-83,
utils/vis.py:77-130).  The JAX module draws with cv2; the port depends
on neither cv2 nor matplotlib, so it rasterises itself and equals cv2's
drawing pixel for pixel:

* :func:`draw_line` is ``cv2.line(img, p1, p2, color, 1, LINE_8)``:
  the integer endpoints clipped to the image as cv2's ``clipLine`` clips
  them (truncating divisions in double precision), then Bresenham's
  8-connected walk from the left end, cv2's ``LineIterator``;
* :func:`draw_filled_circle` is ``cv2.circle(img, c, r, color, -1)``:
  cv2's midpoint ``Circle`` spans, clipped to the image.

Images are written with the port's own codecs (``data/imageio.py``), by
the path's extension.  :func:`plot_3d_keypoints` and :func:`plot_mesh`
need matplotlib, imported when they are called.
"""

from __future__ import annotations

import os

import numpy as np

from ..data import imageio

# RHD-order skeleton edges (root -> finger chains), matching the bone
# structure in reference utils/vis.py:77-130
_EDGES_RHD = [(0, 4), (4, 3), (3, 2), (2, 1),
              (0, 8), (8, 7), (7, 6), (6, 5),
              (0, 12), (12, 11), (11, 10), (10, 9),
              (0, 16), (16, 15), (15, 14), (14, 13),
              (0, 20), (20, 19), (19, 18), (18, 17)]

# MANO order (after the joint switch): chains run root-side -> tip
_EDGES_MANO = [(0, 1), (1, 2), (2, 3), (3, 4),
               (0, 5), (5, 6), (6, 7), (7, 8),
               (0, 9), (9, 10), (10, 11), (11, 12),
               (0, 13), (13, 14), (14, 15), (15, 16),
               (0, 17), (17, 18), (18, 19), (19, 20)]


def to_uint8_image(img: np.ndarray) -> np.ndarray:
    """float image in [-0.5, 0.5] (the pipeline's convention) -> uint8."""
    return np.clip((np.asarray(img) + 0.5) * 255.0, 0, 255).astype(np.uint8)


def _put(img: np.ndarray, y: int, x0: int, x1: int, color) -> None:
    """Pixels x0..x1 (inclusive) of row y set to ``color``."""
    img[y, x0:x1 + 1] = color if img.ndim == 3 else color[0]


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """cv2's ``clipLine`` on an image of w x h: the clipped endpoints,
    or None when the segment misses the image."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return x1, y1, x2, y2


def draw_line(img: np.ndarray, p1, p2, color) -> None:
    """``cv2.line(img, p1, p2, color, 1, cv2.LINE_8)`` in place."""
    h, w = img.shape[:2]
    x1, y1 = (int(v) for v in p1)
    x2, y2 = (int(v) for v in p2)
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        clipped = _clip_line(w, h, x1, y1, x2, y2)
        if clipped is None:
            return
        x1, y1, x2, y2 = clipped
    if x2 < x1:                        # walk left to right
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    err = major - 2 * minor
    x, y = x1, y1
    for _ in range(major + 1):
        _put(img, y, x, x, color)
        minor_step = err < 0
        err += -2 * minor + (2 * major if minor_step else 0)
        if vert:
            y += sy
            x += 1 if minor_step else 0
        else:
            x += 1
            y += sy if minor_step else 0


def draw_filled_circle(img: np.ndarray, center, radius: int, color) -> None:
    """``cv2.circle(img, center, radius, color, -1)`` in place."""
    h, w = img.shape[:2]
    cx, cy = (int(v) for v in center)
    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    while dx >= dy:
        for y, xl, xr in ((cy - dy, cx - dx, cx + dx),
                          (cy + dy, cx - dx, cx + dx),
                          (cy - dx, cx - dy, cx + dy),
                          (cy + dx, cx - dy, cx + dy)):
            if 0 <= y < h and xl < w and xr >= 0:
                _put(img, y, max(xl, 0), min(xr, w - 1), color)
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2


def _pixel(p):
    """A keypoint's pixel: ``np.round`` (half to even), then int."""
    return tuple(np.round(p).astype(int))


def draw_keypoints(image: np.ndarray, uv: np.ndarray,
                   vis: np.ndarray | None = None,
                   color=(0, 255, 0), joint_order: str = "mano",
                   radius: int = 2) -> np.ndarray:
    """Draw 21 keypoints and the skeleton: each edge whose ends are both
    visible as a line, then each visible keypoint as a filled circle;
    returns a copy."""
    out = np.ascontiguousarray(image.copy())
    edges = _EDGES_MANO if joint_order == "mano" else _EDGES_RHD
    uv = np.asarray(uv)
    v = (np.ones(len(uv), bool) if vis is None
         else np.asarray(vis).reshape(-1).astype(bool))
    color = np.asarray(color, out.dtype)
    for a, b in edges:
        if v[a] and v[b]:
            draw_line(out, _pixel(uv[a]), _pixel(uv[b]), color)
    for i, p in enumerate(uv):
        if v[i]:
            draw_filled_circle(out, _pixel(p), radius, color)
    return out


def plot_pred_vs_gt(image: np.ndarray, pred_uv: np.ndarray,
                    gt_uv: np.ndarray, vis: np.ndarray | None = None,
                    joint_order: str = "mano") -> np.ndarray:
    """GT in green, the prediction in red over it (reference
    inference.py:217-225)."""
    out = draw_keypoints(image, gt_uv, vis, (0, 255, 0), joint_order)
    return draw_keypoints(out, pred_uv, vis, (255, 0, 0), joint_order)


def _write(path: str, img: np.ndarray) -> None:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        imageio.write_png(path, img)
    elif ext in (".jpg", ".jpeg"):
        imageio.write_jpeg(path, img)
    else:
        raise ValueError(f"cannot write {path!r}: use .png, .jpg or .jpeg")


def save_image(path: str, image_rgb: np.ndarray) -> None:
    """Write an RGB uint8 image (PNG or JPEG by the extension)."""
    _write(path, image_rgb)


def load_skeleton(path: str, joint_num: int):
    """Parse an InterHand-style skeleton.txt into per-joint parent/children
    (reference utils/preprocessing.py:15-31)."""
    skeleton = [{} for _ in range(joint_num)]
    with open(path) as fp:
        for line in fp:
            if line.startswith("#"):
                continue
            name, jid, pid = line.split(" ")
            jid, pid = int(jid), int(pid)
            skeleton[jid]["name"] = name
            skeleton[jid]["parent_id"] = pid
    for i in range(joint_num):
        skeleton[i]["child_id"] = [j for j in range(joint_num)
                                   if skeleton[j].get("parent_id") == i]
    return skeleton


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("3-D plots need matplotlib, which is not "
                          "installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_3d_keypoints(xyz: np.ndarray, save_path: str,
                      vis: np.ndarray | None = None,
                      joint_order: str = "mano") -> None:
    """Save a 3-D skeleton plot (matplotlib)."""
    plt = _pyplot()
    xyz = np.asarray(xyz)
    v = (np.ones(len(xyz), bool) if vis is None
         else np.asarray(vis).reshape(-1).astype(bool))
    edges = _EDGES_MANO if joint_order == "mano" else _EDGES_RHD
    fig = plt.figure(figsize=(5, 5))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(xyz[v, 0], xyz[v, 1], xyz[v, 2], c="g", s=12)
    for a, b in edges:
        if v[a] and v[b]:
            ax.plot([xyz[a, 0], xyz[b, 0]], [xyz[a, 1], xyz[b, 1]],
                    [xyz[a, 2], xyz[b, 2]], "b-", linewidth=1)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    fig.savefig(save_path, dpi=80, bbox_inches="tight")
    plt.close(fig)


def save_scoremap_grid(scoremap: np.ndarray, save_path: str,
                       cols: int = 7) -> None:
    """Tile one sample's (K, H, W) scoremaps into a gray grid image (the
    reference dataloader's scoremap plots, dataloaderRHD.py:707+)."""
    sm = np.asarray(scoremap)
    K, H, W = sm.shape
    rows = (K + cols - 1) // cols
    grid = np.zeros((rows * H, cols * W), np.float32)
    for k in range(K):
        r, c = divmod(k, cols)
        grid[r * H:(r + 1) * H, c * W:(c + 1) * W] = sm[k]
    _write(save_path, np.clip(grid * 255.0, 0, 255).astype(np.uint8))


def save_mesh_obj(vertices: np.ndarray, faces: np.ndarray,
                  path: str) -> None:
    """Write a hand mesh as Wavefront OBJ."""
    v = np.asarray(vertices, np.float32).reshape(-1, 3)
    f = np.asarray(faces, np.int64).reshape(-1, 3)
    with open(path, "w") as fh:
        for p in v:
            fh.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        for tri in f + 1:   # OBJ is 1-indexed
            fh.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")


def plot_mesh(vertices: np.ndarray, faces: np.ndarray, save_path: str,
              joints: np.ndarray | None = None) -> None:
    """3-D trisurf render of a hand mesh and optional joints
    (matplotlib)."""
    plt = _pyplot()
    v = np.asarray(vertices).reshape(-1, 3)
    f = np.asarray(faces).reshape(-1, 3)
    fig = plt.figure(figsize=(5, 5))
    ax = fig.add_subplot(111, projection="3d")
    ax.plot_trisurf(v[:, 0], v[:, 1], v[:, 2], triangles=f,
                    color=(0.96, 0.75, 0.69), edgecolor="none", alpha=0.9)
    if joints is not None:
        j = np.asarray(joints).reshape(-1, 3)
        ax.scatter(j[:, 0], j[:, 1], j[:, 2], c="g", s=14)
    ax.set_box_aspect((1, 1, 1))
    fig.savefig(save_path, dpi=80, bbox_inches="tight")
    plt.close(fig)
