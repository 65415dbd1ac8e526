"""Host-side InterHand2.6M dataset: COCO-json parse + batched JPEG decode.

Port of ``handpose_tpu/data/interhand.py:42-375`` (reference
dataloader/InterHand2M6/dataloaderInterHand2M6.py:32-178), with the
per-sample geometry on the device
(:func:`handpose_tpu_torch.data.preprocess.preprocess_interhand_batch`).
The parse is the JAX package's:

* world -> camera -> pixel per annotation (transforms.py:11-27);
* the InterHand -> RHD joint order (dataloaderInterHand2M6.py:163-178);
* the rootnet-or-ground-truth bbox switch (``trans_test``), the ground
  truth bbox through ``process_bbox``;
* joint validity gated by each hand's root joint;
* ``interacting`` annotations skipped first, ``fast_trainval`` caps
  (8000 train / 1000 val / 1000 test).

Images decode in one call of the port's decoder per batch
(``data/imageio.py``).  Captures differ in size: with ``pad_to`` each
decodes into the top-left of one zero-padded (Ht, Wt) frame, its size
checked against the annotation's.  ``cache_decoded`` writes the JAX
package's ``decoded_<mode>_<Ht>x<Wt>.u8`` at the dataset root.
"""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import Iterator, Sequence

import numpy as np

from ..ops.patch import process_bbox
from . import imageio
from .preprocess import InterHandRawBatch
from .rhd import _memmap_take, _removed_on_error

# InterHand -> RHD joint order (reference dataloaderInterHand2M6.py:163-178)
IH_TO_RHD = np.array(
    [41] + list(range(21, 41)) + [20] + list(range(0, 20)), np.int32)

_FAST_CAPS = {"train": 8000, "val": 1000, "test": 1000}
CACHE_CHUNK = 128


def world2cam_np(world, R, t):
    return (R @ world.T).T + t.reshape(1, 3)


def cam2pixel_np(cam, focal, princpt):
    # +1e-8 depth guard matches reference transforms.py:11-16
    x = cam[:, 0] / (cam[:, 2] + 1e-8) * focal[0] + princpt[0]
    y = cam[:, 1] / (cam[:, 2] + 1e-8) * focal[1] + princpt[1]
    return np.stack([x, y], axis=1)


class InterHandDataset:
    def __init__(self, root_dir: str, set_type: str = "train",
                 fast_trainval: bool = False, trans_test: str = "gt",
                 input_img_shape=(256, 256), num_decode_threads: int = 8,
                 pad_to=None, cache_decoded: bool = False):
        """``pad_to``: the (H, W) every decoded image is zero-padded to,
        ``"auto"`` for the largest annotated (height, width), or None for
        single-resolution data (a batch of mixed sizes then raises).  An
        image larger than ``pad_to`` raises.  ``cache_decoded`` (needs
        ``pad_to``): decode every image once into a uint8 memmap at the
        dataset root; later epochs read it at memory bandwidth."""
        if set_type not in ("train", "test", "val"):
            raise ValueError(f"set_type {set_type!r} not in "
                             "('train', 'test', 'val')")
        self.root_dir = root_dir
        self.mode = set_type
        self.pad_to = None if pad_to == "auto" else pad_to
        self.num_decode_threads = num_decode_threads
        self.img_path = osp.join(root_dir, "images")
        annot_path = osp.join(root_dir, "annotations")
        self.joint_num = 21
        self.root_joint_idx = {"right": 20, "left": 41}

        def load(what):
            with open(osp.join(annot_path, set_type,
                               f"InterHand2.6M_{set_type}_{what}.json")) as f:
                return json.load(f)

        db, cameras, joints = load("data"), load("camera"), load("joint_3d")
        images = {img["id"]: img for img in db["images"]}

        rootnet = None
        if set_type in ("val", "test") and trans_test == "rootnet":
            p = osp.join(root_dir, "rootnet_output",
                         f"rootnet_interhand2.6m_output_{set_type}.json")
            if not osp.exists(p):
                # a silent ground-truth fallback would report a rootnet
                # evaluation as a ground-truth-bbox one
                raise FileNotFoundError(
                    f"trans_test='rootnet' but {p} does not exist; "
                    "provide the rootnet output json or use "
                    "trans_test='gt'")
            with open(p) as f:
                rootnet = {str(a["annot_id"]): a for a in json.load(f)}

        self.datalist = []
        cap = _FAST_CAPS[set_type] if fast_trainval else None
        for ann in db["annotations"]:
            if cap is not None and len(self.datalist) >= cap:
                break
            # interacting hands are skipped before the camera math
            # (dataloaderInterHand2M6.py:112-113)
            if ann["hand_type"] == "interacting":
                continue
            img = images[ann["image_id"]]
            capture_id, cam = img["capture"], img["camera"]
            frame_idx = img["frame_idx"]
            c = cameras[str(capture_id)]
            campos = np.array(c["campos"][str(cam)], np.float32)
            camrot = np.array(c["camrot"][str(cam)], np.float32)
            focal = np.array(c["focal"][str(cam)], np.float32)
            princpt = np.array(c["princpt"][str(cam)], np.float32)
            joint_world = np.array(
                joints[str(capture_id)][str(frame_idx)]["world_coord"],
                np.float32)
            # cam = R @ (world - campos)
            joint_cam = world2cam_np(joint_world, camrot,
                                     -(camrot @ campos.reshape(3, 1)).ravel())
            joint_img = cam2pixel_np(joint_cam, focal, princpt)
            joint_valid = np.array(ann["joint_valid"], np.float32).reshape(42)
            joint_valid[:21] *= joint_valid[self.root_joint_idx["right"]]
            joint_valid[21:] *= joint_valid[self.root_joint_idx["left"]]
            if rootnet is not None:
                # rootnet bboxes arrive expanded and aspect-corrected
                # (dataloaderInterHand2M6.py:123-125); abs_depth is
                # [right, left] in mm
                bbox = np.array(rootnet[str(ann["id"])]["bbox"], np.float32)
                abs_depth = np.array(rootnet[str(ann["id"])]["abs_depth"],
                                     np.float32)
            else:
                bbox = process_bbox(np.array(ann["bbox"], np.float32),
                                    (img["height"], img["width"]),
                                    input_img_shape)
                abs_depth = np.array(
                    [joint_cam[self.root_joint_idx["right"], 2],
                     joint_cam[self.root_joint_idx["left"], 2]], np.float32)
            self.datalist.append({
                "img_path": osp.join(self.img_path, set_type,
                                     img["file_name"]),
                "focal": focal, "princpt": princpt,
                "joint_cam": joint_cam, "joint_img": joint_img,
                "joint_valid": joint_valid, "hand_type": ann["hand_type"],
                "bbox": bbox, "abs_depth": abs_depth,
                "width": img["width"], "height": img["height"],
            })
        if pad_to == "auto" and self.datalist:
            self.pad_to = (max(d["height"] for d in self.datalist),
                           max(d["width"] for d in self.datalist))
        self._color_mm = None
        if cache_decoded:
            if self.pad_to is None:
                raise ValueError("cache_decoded requires pad_to")
            self._build_cache()

    def __len__(self):
        return len(self.datalist)

    def _decode(self, indices: Sequence[int], out=None) -> np.ndarray:
        """(B, Ht, Wt, 3) uint8, each image in the top-left of its slot."""
        ds = [self.datalist[int(i)] for i in indices]
        hw = [(d["height"], d["width"]) for d in ds]
        pad = self.pad_to
        if pad is None:
            if len(set(hw)) > 1:
                raise ValueError(
                    f"images of sizes {sorted(set(hw))} in one batch; pass "
                    "pad_to (or 'auto') for mixed resolutions")
            pad = hw[0] if hw else (0, 0)
        return imageio.decode_padded([d["img_path"] for d in ds], hw, pad,
                                     self.num_decode_threads, out=out)

    def _build_cache(self):
        Ht, Wt = self.pad_to
        n = len(self)
        cpath = os.path.join(self.root_dir,
                             f"decoded_{self.mode}_{Ht}x{Wt}.u8")
        if not (os.path.exists(cpath)
                and os.path.getsize(cpath) >= n * Ht * Wt * 3):
            # per-process tmp name, moved into place when whole
            tag = f".tmp.{os.getpid()}.npy"
            with _removed_on_error(cpath + tag):
                mm = np.lib.format.open_memmap(cpath + tag, mode="w+",
                                               dtype=np.uint8,
                                               shape=(n, Ht, Wt, 3))
                for s in range(0, n, CACHE_CHUNK):
                    e = min(s + CACHE_CHUNK, n)
                    self._decode(range(s, e), out=mm[s:e])
                mm.flush()
                del mm
                os.replace(cpath + tag, cpath)
        self._color_mm = np.load(cpath, mmap_mode="r")
        if self._color_mm.shape != (n, Ht, Wt, 3):
            raise ValueError(f"cache shape {self._color_mm.shape} does not "
                             f"match {n} samples at {Ht}x{Wt}")

    def raw_batch(self, indices: Sequence[int]) -> InterHandRawBatch:
        """Decode (or read from the cache) and collate a batch of raw
        samples as numpy arrays."""
        if self._color_mm is not None:
            imgs = _memmap_take(self._color_mm, np.asarray(indices))
        else:
            imgs = self._decode(indices)
        uv, vis, xyz, Ks, left, bboxes, owh = [], [], [], [], [], [], []
        for i in indices:
            d = self.datalist[int(i)]
            # RHD joint order; mm -> m (dataloaderInterHand2M6.py:216-218)
            xyz.append(d["joint_cam"][IH_TO_RHD] / 1000.0)
            uv.append(d["joint_img"][IH_TO_RHD])
            vis.append(d["joint_valid"][IH_TO_RHD])
            f, c = d["focal"], d["princpt"]
            Ks.append(np.array([[f[0], 0, c[0]], [0, f[1], c[1]], [0, 0, 1]],
                               np.float32))
            left.append(d["hand_type"] == "left")
            # int bbox with the reference's clamp quirk
            # (dataloaderInterHand2M6.py:208-213: an overflow sets w =
            # width), against the ORIGINAL size, never the padded one
            ow, oh = d["width"], d["height"]
            b = np.array(d["bbox"], np.int32)
            b[0] = max(b[0], 0)
            b[1] = max(b[1], 0)
            if b[0] + b[2] > ow:
                b[2] = ow
            if b[1] + b[3] > oh:
                b[3] = oh
            bboxes.append(b)
            owh.append([ow, oh])
        return InterHandRawBatch(
            image=imgs, keypoint_uv=np.stack(uv).astype(np.float32),
            keypoint_vis=np.stack(vis).astype(np.float32),
            keypoint_xyz=np.stack(xyz).astype(np.float32),
            camera_K=np.stack(Ks), hand_left=np.array(left),
            bbox=np.stack(bboxes), orig_wh=np.array(owh, np.int32))

    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0,
                drop_remainder: bool = True) -> Iterator[InterHandRawBatch]:
        from .pipeline import epoch_index_chunks
        for idx in epoch_index_chunks(len(self), batch_size, shuffle, seed,
                                      drop_remainder):
            yield self.raw_batch(idx)


def write_synthetic_interhand(root_dir: str, set_type: str = "val",
                              n: int = 6, seed: int = 0,
                              image_size: int = 320,
                              image_sizes=None) -> None:
    """Write a miniature InterHand2.6M tree (COCO jsons + JPEGs).

    ``image_sizes``: an optional list of (H, W), used in turn -- real
    captures vary in size.  Draws the JAX package's random sequence and
    writes the same json bytes; the images are JPEGs at quality 95 from
    the port's encoder."""
    rng = np.random.default_rng(seed)
    ann_dir = osp.join(root_dir, "annotations", set_type)
    img_dir = osp.join(root_dir, "images", set_type)
    os.makedirs(ann_dir, exist_ok=True)
    os.makedirs(img_dir, exist_ok=True)

    images, annotations = [], []
    cameras = {"0": {"campos": {}, "camrot": {}, "focal": {}, "princpt": {}}}
    joints = {"0": {}}
    for i in range(n):
        if image_sizes is not None:
            ih, iw = image_sizes[i % len(image_sizes)]
        else:
            ih = iw = image_size
        fname = f"img_{i:05d}.jpg"
        img = rng.integers(0, 255, (ih, iw, 3), dtype=np.uint8)
        imageio.write_jpeg(osp.join(img_dir, fname), img)
        images.append({"id": i, "file_name": fname, "capture": 0,
                       "camera": str(i), "frame_idx": i,
                       "seq_name": "synthetic", "width": iw,
                       "height": ih})
        campos = rng.normal(scale=50, size=3)
        camrot = np.eye(3)
        focal = [300.0 + rng.uniform(-10, 10), 300.0 + rng.uniform(-10, 10)]
        princpt = [iw / 2.0, ih / 2.0]
        cameras["0"]["campos"][str(i)] = campos.tolist()
        cameras["0"]["camrot"][str(i)] = camrot.tolist()
        cameras["0"]["focal"][str(i)] = focal
        cameras["0"]["princpt"][str(i)] = princpt
        world = campos + rng.normal(scale=40, size=(42, 3)) \
            + np.array([0, 0, 600.0])
        joints["0"][str(i)] = {"world_coord": world.tolist()}
        cam = world - campos
        u = cam[:, 0] / cam[:, 2] * focal[0] + princpt[0]
        v = cam[:, 1] / cam[:, 2] * focal[1] + princpt[1]
        hand_type = "right" if i % 2 == 0 else "left"
        side = slice(0, 21) if hand_type == "right" else slice(21, 42)
        us, vs = u[side], v[side]
        bbox = [float(us.min() - 5), float(vs.min() - 5),
                float(us.max() - us.min() + 10),
                float(vs.max() - vs.min() + 10)]
        annotations.append({
            "id": i, "image_id": i, "bbox": bbox,
            "joint_valid": (rng.uniform(size=42) > 0.2).astype(
                float).tolist(),
            "hand_type": hand_type, "hand_type_valid": 1.0,
        })
    for what, obj in (("data", {"images": images,
                                "annotations": annotations}),
                      ("camera", cameras), ("joint_3d", joints)):
        with open(osp.join(ann_dir, f"InterHand2.6M_{set_type}_{what}.json"),
                  "w") as f:
            json.dump(obj, f)
    # skeleton.txt, as the reference loader's tree has one
    with open(osp.join(root_dir, "annotations", "skeleton.txt"), "w") as f:
        f.write("# joint_name joint_id parent_id\n")
        for j in range(42):
            f.write(f"j{j} {j} {max(j - 1, -1)}\n")


def write_synthetic_rootnet(root_dir: str, set_type: str = "val",
                            seed: int = 0) -> str:
    """Write a rootnet-output json for an existing synthetic tree: a list
    of ``{annot_id, bbox, abs_depth=[right, left]}``
    (dataloaderInterHand2M6.py:76-85,123-125), with bboxes unlike the
    ground-truth ones so a test can tell which the loader took.  Returns
    the json's path."""
    ann_path = osp.join(root_dir, "annotations", set_type,
                        f"InterHand2.6M_{set_type}_data.json")
    with open(ann_path) as f:
        anns = json.load(f)["annotations"]
    rng = np.random.default_rng(seed)
    out = [{"annot_id": a["id"],
            "bbox": [7.0 + a["id"], 11.0 + a["id"], 96.0, 128.0],
            "abs_depth": [float(rng.uniform(400, 800)),
                          float(rng.uniform(400, 800))]}
           for a in anns]
    out_dir = osp.join(root_dir, "rootnet_output")
    os.makedirs(out_dir, exist_ok=True)
    p = osp.join(out_dir, f"rootnet_interhand2.6m_output_{set_type}.json")
    with open(p, "w") as f:
        json.dump(out, f)
    return p
