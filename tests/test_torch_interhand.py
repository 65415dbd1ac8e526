"""Port parity: the InterHand2.6M dataset and its device preprocessing.

On a tree written by the JAX package's ``write_synthetic_interhand``
(mixed 64x40 and 40x64 frames, so ``pad_to="auto"`` pads every frame to
64x64):

* ``InterHandDataset`` equals the JAX one: the parsed datalist, every
  field of ``raw_batch`` exactly (the port's JPEG decoder equals cv2's),
  the bbox clamp quirk, the ``fast_trainval`` caps with interacting
  hands skipped first, the rootnet switch and the missing-rootnet error;
  each package reads the other's decoded cache, and both write the same
  bytes;
* the port's writers write the JAX writers' json bytes;
* ``preprocess_interhand_batch`` equals the JAX function on
  ``tests/fixtures/interhand_raw.npz`` at ``tests/test_interhand_parity.py``'s
  tolerances (and the reference's ``__getitem__`` fixture likewise), and
  on the synthetic batches: plain, without the wrist coordinate, without
  the crop, and with both augmentations on the JAX function's own draws
  recomputed from its key, including a bbox that hits the clamp quirk
  and frames whose crop reads the padding.  Integers, booleans and
  ``right_hand_mask`` are exact; floats to 1e-5 (float32 geometry).
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest

from handpose_tpu.data import interhand as jih
from handpose_tpu.data.preprocess import \
    preprocess_interhand_batch as jpreprocess
from handpose_tpu_torch.data import interhand as tih
from handpose_tpu_torch.data.preprocess import preprocess_interhand_batch

from _torch_port import interhand_raws, jax_interhand_draws
from _torch_port import port_worker_niced  # noqa: F401

SIZES = [(64, 40), (40, 64)]
N_TRAIN, N_VAL, CROP = 8, 6, 32
EXACT = ("hand_side", "keypoint_vis21", "right_hand_mask")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    pytest.importorskip("cv2")
    root = str(tmp_path_factory.mktemp("ih"))
    jih.write_synthetic_interhand(root, "train", n=N_TRAIN, seed=1,
                                  image_sizes=SIZES)
    jih.write_synthetic_interhand(root, "val", n=N_VAL, seed=2,
                                  image_sizes=SIZES)
    return root


def _pair(root, split="val", **kw):
    args = dict(fast_trainval=False, trans_test="gt",
                input_img_shape=(CROP, CROP), num_decode_threads=2,
                pad_to="auto")
    args.update(kw)
    return (jih.InterHandDataset(root, split, **args),
            tih.InterHandDataset(root, split, **args))


def _assert_datalists_equal(a, b):
    assert len(a) == len(b)
    for da, db in zip(a, b):
        assert sorted(da) == sorted(db)
        for k in da:
            if isinstance(da[k], np.ndarray):
                assert da[k].dtype == db[k].dtype, k
                np.testing.assert_array_equal(da[k], db[k], err_msg=k)
            else:
                assert da[k] == db[k], k


def _assert_raw_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def test_dataset_equals_jax_on_a_jax_tree(tree):
    for split in ("train", "val"):
        theirs, ours = _pair(tree, split)
        assert ours.pad_to == theirs.pad_to == (64, 64)
        _assert_datalists_equal(theirs.datalist, ours.datalist)
        idx = list(range(len(ours)))[::-1]
        _assert_raw_equal(theirs.raw_batch(idx), ours.raw_batch(idx))
    # pad_to=None: one resolution per batch, as JAX's np.stack needs
    theirs, ours = _pair(tree, pad_to=None)
    _assert_raw_equal(theirs.raw_batch([0, 2]), ours.raw_batch([0, 2]))
    with pytest.raises(ValueError, match="pad_to"):
        ours.raw_batch([0, 1])


def test_bbox_clamp_quirk_against_the_original_size(tree):
    theirs, ours = _pair(tree)
    for ds in (theirs, ours):
        d = ds.datalist[1]                      # a 40x64 frame, left hand
        d["bbox"] = np.array([d["width"] - 10.5, -3.0, 30.0, 12.0],
                             np.float32)
        d = ds.datalist[0]                      # 64x40: pad on the right
        d["bbox"] = np.array([4.0, d["height"] - 20.0, 8.0, 50.0],
                             np.float32)
    a, b = theirs.raw_batch([0, 1]), ours.raw_batch([0, 1])
    _assert_raw_equal(a, b)
    np.testing.assert_array_equal(b.bbox[1], [53, 0, 64, 12])
    np.testing.assert_array_equal(b.bbox[0], [4, 44, 8, 64])


def test_fast_trainval_caps_skip_interacting_hands(tree, tmp_path,
                                                   monkeypatch):
    root = str(tmp_path / "ih")
    shutil.copytree(tree, root)
    path = os.path.join(root, "annotations", "train",
                        "InterHand2.6M_train_data.json")
    with open(path) as f:
        db = json.load(f)
    for i in (0, 3):
        db["annotations"][i]["hand_type"] = "interacting"
    with open(path, "w") as f:
        json.dump(db, f)
    caps = {"train": 4, "val": 2, "test": 2}
    monkeypatch.setattr(jih, "_FAST_CAPS", caps)
    monkeypatch.setattr(tih, "_FAST_CAPS", caps)
    theirs, ours = _pair(root, "train", fast_trainval=True)
    assert len(ours) == 4
    assert [os.path.basename(d["img_path"]) for d in ours.datalist] == \
        [f"img_{i:05d}.jpg" for i in (1, 2, 4, 5)]
    _assert_datalists_equal(theirs.datalist, ours.datalist)
    full = tih.InterHandDataset(root, "train", pad_to="auto")
    assert len(full) == N_TRAIN - 2


def test_rootnet_switch_and_missing_rootnet(tree, tmp_path):
    root = str(tmp_path / "ih")
    shutil.copytree(tree, root)
    with pytest.raises(FileNotFoundError, match="rootnet"):
        tih.InterHandDataset(root, "val", trans_test="rootnet")
    want = jih.write_synthetic_rootnet(root, "val", seed=3)
    with open(want, "rb") as f:
        jax_bytes = f.read()
    os.remove(want)
    assert tih.write_synthetic_rootnet(root, "val", seed=3) == want
    with open(want, "rb") as f:
        assert f.read() == jax_bytes
    theirs, ours = _pair(root, trans_test="rootnet")
    _assert_datalists_equal(theirs.datalist, ours.datalist)
    gt = tih.InterHandDataset(root, "val", input_img_shape=(CROP, CROP))
    assert not np.array_equal(ours.datalist[0]["bbox"],
                              gt.datalist[0]["bbox"])
    np.testing.assert_array_equal(ours.datalist[2]["bbox"],
                                  [9.0, 13.0, 96.0, 128.0])


def test_bbox_helpers_equal_jax_bit_for_bit():
    """``process_bbox`` through each aspect branch and ``get_bbox`` over
    random joints, against the JAX package's, exactly."""
    from handpose_tpu.ops import patch as jpatch
    from handpose_tpu_torch.ops import patch as tpatch
    rng = np.random.default_rng(11)
    for _ in range(200):
        bbox = rng.uniform([-50, -50, 1, 1], [400, 400, 300, 300])
        shape = tuple(int(v) for v in rng.choice([192, 256, 320], 2))
        np.testing.assert_array_equal(
            tpatch.process_bbox(bbox, (480, 640), shape),
            jpatch.process_bbox(bbox, (480, 640), shape))
        joints = rng.uniform(0, 500, (21, 2)).astype(np.float32)
        valid = (rng.uniform(size=21) > 0.3).astype(np.float32)
        valid[0] = 1
        np.testing.assert_array_equal(tpatch.get_bbox(joints, valid),
                                      jpatch.get_bbox(joints, valid))
    for bbox in ([0, 0, 10, 10], [0, 0, 20, 10], [0, 0, 10, 20]):
        np.testing.assert_array_equal(
            tpatch.process_bbox(np.array(bbox, np.float32), (1, 1)),
            jpatch.process_bbox(np.array(bbox, np.float32), (1, 1)))


def test_each_package_reads_the_others_cache(tree, tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    shutil.copytree(tree, a)
    shutil.copytree(tree, b)
    name = "decoded_val_64x64.u8"
    jih.InterHandDataset(a, "val", pad_to="auto", cache_decoded=True)
    tih.InterHandDataset(b, "val", pad_to="auto", cache_decoded=True)
    with open(os.path.join(a, name), "rb") as f, \
            open(os.path.join(b, name), "rb") as g:
        assert f.read() == g.read()
    # each reads the other's file (removed images prove no decode runs)
    shutil.rmtree(os.path.join(a, "images"))
    shutil.rmtree(os.path.join(b, "images"))
    ours = tih.InterHandDataset(a, "val", pad_to="auto", cache_decoded=True)
    theirs = jih.InterHandDataset(b, "val", pad_to="auto",
                                  cache_decoded=True)
    ref = _pair(tree)[0]
    idx = [5, 0, 3]
    _assert_raw_equal(ref.raw_batch(idx), ours.raw_batch(idx))
    _assert_raw_equal(ref.raw_batch(idx), theirs.raw_batch(idx))
    with pytest.raises(ValueError, match="requires pad_to"):
        tih.InterHandDataset(a, "val", cache_decoded=True)


def test_writers_write_the_jax_json_bytes(tree, tmp_path):
    root = str(tmp_path / "ours")
    tih.write_synthetic_interhand(root, "val", n=N_VAL, seed=2,
                                  image_sizes=SIZES)
    ann = os.path.join("annotations", "val")
    for name in sorted(os.listdir(os.path.join(tree, ann))) + \
            [os.path.join("..", "skeleton.txt")]:
        with open(os.path.join(tree, ann, name), "rb") as f, \
                open(os.path.join(root, ann, name), "rb") as g:
            assert f.read() == g.read(), name
    ours, theirs = (tih.InterHandDataset(r, "val", pad_to="auto")
                    for r in (root, tree))
    a, b = ours.raw_batch(range(N_VAL)), theirs.raw_batch(range(N_VAL))
    for name in a._fields:
        if name != "image":
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    # the same random frames through two JPEG encoders at quality 95
    assert a.image.shape == b.image.shape
    err = np.abs(a.image.astype(np.int64) - b.image).mean()
    assert err < 8.0, err


def _assert_samples_close(want, got, atol=1e-5):
    assert sorted(want) == sorted(got)
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert w.shape == g.shape, k
        if k in EXACT or w.dtype == bool:
            np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=k)


def _fixture_raws(fixtures):
    raw = dict(fixtures("interhand_raw"))
    B = raw["image"].shape[0]
    raw["hand_left"] = raw["hand_left"].astype(bool)
    raw["orig_wh"] = np.full((B, 2), raw["image"].shape[2], np.int32)
    return interhand_raws(raw)


def test_preprocess_matches_jax_and_the_reference_fixture(fixtures):
    jraw, raw = _fixture_raws(fixtures)
    want = jpreprocess(jraw)
    got = preprocess_interhand_batch(raw)
    ref = fixtures("interhand_getitem")
    np.testing.assert_array_equal(got["hand_side"], want["hand_side"])
    np.testing.assert_array_equal(got["hand_side"], ref["hand_side"])
    tols = {"keypoint_xyz21": dict(atol=1e-6),
            "keypoint_scale": dict(rtol=1e-5),
            "keypoint_xyz21_rel_normed": dict(atol=1e-5),
            "keypoint_xyz21_local": dict(atol=1e-4),
            "kp_coord_xyz21_rel_can": dict(atol=1e-4),
            "rot_mat": dict(atol=1e-4),
            "keypoint_uv21": dict(rtol=1e-4, atol=2e-3),
            "camera_intrinsic_matrix": dict(rtol=1e-5, atol=1e-3),
            "scoremap": dict(atol=1e-5)}
    for k, tol in tols.items():
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **tol)
    crop = got["image_crop"].permute(0, 3, 1, 2)
    np.testing.assert_allclose(crop, np.transpose(want["image_crop"],
                                                  (0, 3, 1, 2)), atol=1e-5)
    np.testing.assert_allclose(crop, ref["image_crop"], atol=1e-5)
    for key in ("right_hand_mask", "keypoint_vis21"):
        np.testing.assert_array_equal(
            np.asarray(got[key], np.float32), np.asarray(want[key],
                                                         np.float32))
    np.testing.assert_array_equal(got["right_hand_mask"],
                                  ref["right_hand_mask"])
    np.testing.assert_array_equal(
        np.asarray(got["keypoint_vis21"], np.float32), ref["keypoint_vis21"])


@pytest.mark.parametrize("kw", [
    {}, {"use_wrist_coord": False}, {"hand_crop": False},
    {"switch_joint_order": False, "calculate_scoremap": False}],
    ids=["plain", "palm", "no_crop", "no_switch_no_map"])
def test_preprocess_matches_jax_on_fixture_options(fixtures, kw):
    jraw, raw = _fixture_raws(fixtures)
    _assert_samples_close(jpreprocess(jraw, **kw),
                          preprocess_interhand_batch(raw, **kw))


def _synthetic_raw(tree):
    """All 6 val frames, one bbox pushed past the right edge (clamp
    quirk: its width becomes the frame's) so the crop reads the padding
    and past the padded frame."""
    ds = tih.InterHandDataset(tree, "val", pad_to="auto")
    d = ds.datalist[3]
    d["bbox"] = np.array([d["width"] - 12.0, 2.0, 20.0, 30.0], np.float32)
    raw = ds.raw_batch(range(N_VAL))
    assert raw.bbox[3, 0] + raw.bbox[3, 2] > raw.orig_wh[3, 0]
    assert (raw.orig_wh < 64).any(axis=1).all()     # every frame padded
    assert raw.hand_left.any() and (~raw.hand_left).any()
    return raw


@pytest.mark.parametrize("kw", [
    {}, {"use_wrist_coord": False}, {"hand_crop": False}],
    ids=["plain", "palm", "no_crop"])
def test_preprocess_matches_jax_on_padded_frames(tree, kw):
    jraw, raw = interhand_raws(_synthetic_raw(tree))
    _assert_samples_close(jpreprocess(jraw, crop_size=CROP, **kw),
                          preprocess_interhand_batch(raw, crop_size=CROP,
                                                     **kw))


@pytest.mark.parametrize("use_wrist_coord", [True, False])
def test_augmentations_on_the_jax_draws(tree, use_wrist_coord):
    """Both augmentations on the JAX function's own draws: the uv noise
    turns integer uv into float before the side selection and the
    mirror, and the dropout keeps JAX's order of operations."""
    jraw, raw = interhand_raws(_synthetic_raw(tree))
    key = jax.random.PRNGKey(5)
    kw = dict(crop_size=CROP, use_wrist_coord=use_wrist_coord,
              coord_uv_noise=True, scoremap_dropout=True)
    want = jpreprocess(jraw, rng=key, **kw)
    draws = jax_interhand_draws(key, N_VAL, (CROP, CROP))
    got = preprocess_interhand_batch(raw, draws=draws, **kw)
    _assert_samples_close(want, got)
    assert 0 < float((got["scoremap"] == 0).float().mean()) < 1
    with pytest.raises(ValueError, match="need draws or a generator"):
        preprocess_interhand_batch(raw, coord_uv_noise=True)
    import torch
    g = torch.Generator().manual_seed(0)
    drawn = preprocess_interhand_batch(raw, generator=g, **kw)
    assert drawn["scoremap"].shape == got["scoremap"].shape
