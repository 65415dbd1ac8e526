"""Port parity: device preprocessing of raw RHD batches.

``handpose_tpu_torch.data.preprocess.preprocess_batch`` against the jitted
JAX ``preprocess_batch`` on the same raw batch, every key of the sample
dict, at tests/test_preprocess_parity.py's tolerances (integer and
boolean keys exactly).  The train-time augmentations take the JAX
function's own draws (``_torch_port.jax_draws``, made from its key as it
makes them), injected as ``AugmentDraws``; ``full_contract`` and the
terminal transforms are held to it too.
"""

import jax
import numpy as np
import pytest
import torch

from handpose_tpu.data.preprocess import model_input as jmodel_input
from handpose_tpu.data.preprocess import preprocess_batch as jpreprocess
from handpose_tpu.data.preprocess import scale_to_size as jscale_to_size
from handpose_tpu.data.preprocess import yiq_hue_rotate as jhue
from handpose_tpu_torch.data.preprocess import (AugmentDraws,
                                                draw_augmentations,
                                                model_input, preprocess_batch,
                                                scale_to_size, yiq_hue_rotate)

from _torch_port import (AUG_FLAGS, RAW_FIELDS, jax_draws, jax_raw,
                         seeded_raw, torch_raw)
from _torch_port import port_worker_niced  # noqa: F401

# key -> (rtol, atol); None = exact
TOL = {
    "image": (0, 1e-6),
    "image_crop": (0, 1e-5),
    "hand_side": None,
    "right_hand_mask": None,
    "keypoint_vis21": None,
    "keypoint_xyz21": (0, 1e-6),
    "keypoint_xyz_root": (0, 1e-6),
    "keypoint_scale": (1e-6, 0),
    "keypoint_xyz21_rel_normed": (0, 1e-5),
    "keypoint_xyz21_local": (0, 1e-4),
    "kp_coord_xyz21_rel_can": (0, 1e-4),
    "rot_mat": (0, 1e-4),
    "keypoint_uv21": (1e-4, 2e-3),
    "camera_intrinsic_matrix": (1e-5, 1e-3),
    "scoremap": (0, 1e-5),
    "hand_parts": None,
    "hand_map_l": None,
    "hand_map_r": None,
    "hand_mask": None,
}
# hue: the YIQ transform and its float32 inverse are two 3x3 products
# per pixel, which the packages sum in different orders, and the two
# inverses differ in the last bits: a few ulps of values in [0, 1]
# (measured 3e-7)
HUE_TOL = (0, 1e-6)
# scale_to_size: the same triangle-kernel weights, computed in another
# way and summed in another order (measured 9e-8 downsampling the
# height, 1.8e-6 upsampling, values in [-0.5, 0.5])
RESIZE_TOL = (0, 4e-6)


def _compare(ref: dict, out: dict, tol: dict = TOL):
    assert set(out) == set(ref)
    for key, ref_v in ref.items():
        a = np.asarray(ref_v)
        b = out[key].numpy()
        assert b.shape == a.shape and b.dtype == a.dtype, key
        if tol[key] is None:
            np.testing.assert_array_equal(b, a, err_msg=key)
        else:
            rtol, atol = tol[key]
            np.testing.assert_allclose(b, a, rtol=rtol, atol=atol,
                                       err_msg=key)


def _fixture_raw(fixtures):
    raw = fixtures("rhd_raw")
    return {k: raw[k] for k in RAW_FIELDS}


def test_preprocess_fixture_batch(fixtures):
    raw = _fixture_raw(fixtures)
    _compare(jax.jit(jpreprocess)(jax_raw(raw)),
             preprocess_batch(torch_raw(raw)))


def test_preprocess_seeded_batch_crop64():
    raw = seeded_raw(4, 80, seed=21)
    kw = dict(crop_size=64, sigma=25.0)
    ref = jax.jit(lambda r: jpreprocess(r, **kw))(jax_raw(raw))
    out = preprocess_batch(torch_raw(raw), **kw)
    _compare(ref, out)
    # the batch exercises both hands and a visible scoremap
    assert set(out["hand_side"].argmax(-1).tolist()) == {0, 1}
    assert out["scoremap"].amax() > 0.9


def test_preprocess_no_crop_renders_at_image_size():
    raw = seeded_raw(2, 48, seed=4)
    kw = dict(hand_crop=False, sigma=10.0)
    ref = jax.jit(lambda r: jpreprocess(r, **kw))(jax_raw(raw))
    out = preprocess_batch(torch_raw(raw), **kw)
    _compare(ref, out)
    assert out["scoremap"].shape == (2, 21, 48, 48)


def test_preprocess_palm_coord_mode(fixtures):
    raw = _fixture_raw(fixtures)
    ref = jax.jit(lambda r: jpreprocess(r, use_wrist_coord=False))(
        jax_raw(raw))
    _compare(ref, preprocess_batch(torch_raw(raw), use_wrist_coord=False))


def test_preprocess_keeps_joint_order_when_asked(fixtures):
    raw = _fixture_raw(fixtures)
    ref = jax.jit(lambda r: jpreprocess(r, switch_joint_order=False))(
        jax_raw(raw))
    _compare(ref, preprocess_batch(torch_raw(raw), switch_joint_order=False))


@pytest.fixture(scope="module")
def crop32():
    """A seeded raw batch and its JAX preprocessing at crop 32, compiled
    once for the three layouts."""
    raw = seeded_raw(2, 80, seed=2)
    return raw, jax.jit(lambda r: jpreprocess(r, crop_size=32))(jax_raw(raw))


@pytest.mark.parametrize("channels", [3, 21, 24])
def test_model_input_layout(crop32, channels):
    raw, sample = crop32
    ref = jmodel_input(sample, channels)
    out = model_input(preprocess_batch(torch_raw(raw), crop_size=32),
                      channels)
    assert tuple(out.shape) == (2, 32, 32, channels)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_model_input_21_is_a_view_of_the_scoremap():
    sample = {"scoremap": torch.zeros(2, 21, 8, 8)}
    inp = model_input(sample, 21)
    assert inp.data_ptr() == sample["scoremap"].data_ptr()
    assert inp.permute(0, 3, 1, 2).is_contiguous()


AUG_CROP, AUG_SIDE, AUG_B = 64, 64, 4
AUG_MOVES = {"coord_uv_noise": "keypoint_uv21", "hue_aug": "image",
             "crop_center_noise": "image_crop",
             "crop_scale_noise": "image_crop",
             "crop_offset_noise": "image_crop",
             "scoremap_dropout": "scoremap"}


@pytest.fixture(scope="module")
def aug_inputs():
    """A raw batch of 4 at 64x64 and JAX's draws for its key."""
    raw = seeded_raw(AUG_B, AUG_SIDE, seed=31)
    key = jax.random.PRNGKey(5)
    draws = jax_draws(key, AUG_B, (AUG_SIDE, AUG_SIDE), (AUG_CROP, AUG_CROP),
                      random_crop_size=48)
    return raw, key, draws


@pytest.mark.parametrize("flags", [(f,) for f in AUG_FLAGS] + [AUG_FLAGS],
                         ids=list(AUG_FLAGS) + ["all_six"])
def test_augmentations_match_jax_on_its_draws(aug_inputs, flags):
    """Each augmentation alone and all six together, the port on the
    JAX function's own draws: every key at TOL, except that the
    hue-rotated image and its crop are held to HUE_TOL and the dropped-out
    scoremap to 1e-6."""
    raw, key, draws = aug_inputs
    kw = dict(crop_size=AUG_CROP, **{f: True for f in flags})
    ref = jax.jit(lambda r, k: jpreprocess(r, rng=k, **kw))(jax_raw(raw), key)
    out = preprocess_batch(torch_raw(raw), draws=draws, **kw)
    tol = dict(TOL)
    if "hue_aug" in flags:
        tol.update(image=HUE_TOL, image_crop=HUE_TOL)
    if "scoremap_dropout" in flags:
        tol["scoremap"] = (0, 1e-6)
        kept = out["scoremap"][draws.dropout_keep]
        assert float(out["scoremap"][~draws.dropout_keep].abs().max()) == 0
        assert float(kept.max()) > 1.0          # survivors scaled by 4
    _compare(ref, out, tol)
    # and each augmentation changed what it acts on
    plain = preprocess_batch(torch_raw(raw), crop_size=AUG_CROP)
    for flag in flags:
        key_ = AUG_MOVES[flag]
        assert not torch.equal(out[key_], plain[key_]), (flag, key_)


def test_augmentations_need_draws_or_a_generator(aug_inputs):
    raw = torch_raw(aug_inputs[0])
    with pytest.raises(ValueError, match="need draws or a generator"):
        preprocess_batch(raw, crop_size=AUG_CROP, coord_uv_noise=True)
    with pytest.raises(ValueError, match="do not hold theirs"):
        preprocess_batch(raw, crop_size=AUG_CROP, hue_aug=True,
                         draws=AugmentDraws())
    # a generator draws every augmentation in the raw batch's device,
    # one set of draws per generator state
    kw = dict(crop_size=AUG_CROP, **{f: True for f in AUG_FLAGS})
    a, b = (preprocess_batch(raw, generator=torch.Generator().manual_seed(3),
                             **kw) for _ in range(2))
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_draw_augmentations_distributions():
    """The generator's draws follow the JAX package's distributions."""
    g = torch.Generator().manual_seed(0)
    d = draw_augmentations(set(AUG_FLAGS) | {"random_crop_to_size"},
                           (4096, (64, 80), (16, 16), 48), g)
    assert abs(float(d.uv_noise.std()) - 2.5) < 0.05
    assert abs(float(d.center_noise.std()) - 20.0) < 0.5
    assert abs(float(d.offset_noise.std()) - 10.0) < 0.25
    assert -0.1 <= float(d.hue_turns.min()) < float(d.hue_turns.max()) <= 0.1
    assert 1.0 <= float(d.scale_noise.min()) < float(d.scale_noise.max()) \
        <= 1.2
    assert abs(float(d.dropout_keep.float().mean()) - 0.2) < 0.002
    assert d.dropout_keep.dtype == torch.bool
    assert d.crop_yx.dtype == torch.int64
    assert int(d.crop_yx[:, 0].max()) == 64 - 48
    assert int(d.crop_yx[:, 1].max()) == 80 - 48
    assert int(d.crop_yx.min()) == 0


def test_full_contract_matches_jax(aug_inputs):
    raw = aug_inputs[0]
    kw = dict(crop_size=AUG_CROP, full_contract=True)
    ref = jax.jit(lambda r: jpreprocess(r, **kw))(jax_raw(raw))
    out = preprocess_batch(torch_raw(raw), **kw)
    assert {"hand_parts", "hand_map_l", "hand_map_r", "hand_mask"} \
        <= set(out)
    _compare(ref, out)


@pytest.mark.parametrize("target", [(48, 64), (96, 80)],
                         ids=["downsample_h", "upsample"])
def test_scale_to_size_matches_jax(aug_inputs, target):
    """The scale_to_size branch and the standalone function: the image
    to RESIZE_TOL (torch's antialiased bilinear has jax.image.resize's
    weights; the two compute them and sum in another order), uv and vis
    at TOL."""
    raw = aug_inputs[0]
    kw = dict(crop_size=AUG_CROP, scale_to_size=True,
              scale_target_size=target)
    ref = jax.jit(lambda r: jpreprocess(r, **kw))(jax_raw(raw))
    out = preprocess_batch(torch_raw(raw), **kw)
    assert out["image"].shape == (AUG_B,) + target + (3,)
    _compare(ref, out, dict(TOL, image=RESIZE_TOL))
    sample = preprocess_batch(torch_raw(raw), crop_size=AUG_CROP)
    jsample = {k: np.asarray(v) for k, v in
               jax.jit(lambda r: jpreprocess(r, crop_size=AUG_CROP))(
                   jax_raw(raw)).items()}
    _compare(jscale_to_size(jsample, target), scale_to_size(sample, target),
             dict(TOL, image=RESIZE_TOL))


def test_random_crop_to_size_matches_jax(aug_inputs):
    raw, key, draws = aug_inputs
    kw = dict(crop_size=AUG_CROP, random_crop_to_size=True,
              random_crop_size=48)
    ref = jax.jit(lambda r, k: jpreprocess(r, rng=k, **kw))(jax_raw(raw), key)
    out = preprocess_batch(torch_raw(raw), draws=draws, **kw)
    assert set(out) == {"image", "hand_parts", "hand_mask"}
    _compare(ref, out)
    with pytest.raises(ValueError, match="exceeds the image extent"):
        jpreprocess(jax_raw(raw), rng=key, random_crop_to_size=True,
                    random_crop_size=AUG_SIDE + 1)
    with pytest.raises(ValueError, match="exceeds the image extent"):
        preprocess_batch(torch_raw(raw), random_crop_to_size=True,
                         random_crop_size=AUG_SIDE + 1,
                         generator=torch.Generator())


def test_yiq_hue_rotate_matches_jax():
    rng = np.random.default_rng(8)
    img = rng.uniform(-0.5, 0.5, (3, 9, 7, 3)).astype(np.float32)
    turns = np.asarray([-0.1, 0.03, 0.1], np.float32)
    ref = jax.jit(jhue)(img, turns)
    out = yiq_hue_rotate(torch.from_numpy(img), torch.from_numpy(turns))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=HUE_TOL[1])
    same = yiq_hue_rotate(torch.from_numpy(img), torch.zeros(3))
    np.testing.assert_allclose(same.numpy(), img, atol=HUE_TOL[1])
