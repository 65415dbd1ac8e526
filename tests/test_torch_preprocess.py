"""Port parity: device preprocessing of raw RHD batches.

``handpose_tpu_torch.data.preprocess.preprocess_batch`` against the jitted
JAX ``preprocess_batch`` on the same raw batch, every key of the sample
dict, at tests/test_preprocess_parity.py's tolerances (integer and
boolean keys exactly).
"""

import jax
import numpy as np
import pytest
import torch

from handpose_tpu.data.preprocess import model_input as jmodel_input
from handpose_tpu.data.preprocess import preprocess_batch as jpreprocess
from handpose_tpu_torch.data.preprocess import model_input, preprocess_batch

from _torch_port import RAW_FIELDS, jax_raw, seeded_raw, torch_raw

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
}


def _compare(ref: dict, out: dict):
    assert set(out) == set(ref)
    for key, ref_v in ref.items():
        a = np.asarray(ref_v)
        b = out[key].numpy()
        assert b.shape == a.shape and b.dtype == a.dtype, key
        if TOL[key] is None:
            np.testing.assert_array_equal(b, a, err_msg=key)
        else:
            rtol, atol = TOL[key]
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


@pytest.mark.parametrize("channels", [3, 21, 24])
def test_model_input_layout(channels):
    raw = seeded_raw(2, 80, seed=2)
    ref = jmodel_input(jax.jit(lambda r: jpreprocess(r, crop_size=32))(
        jax_raw(raw)), channels)
    out = model_input(preprocess_batch(torch_raw(raw), crop_size=32),
                      channels)
    assert tuple(out.shape) == (2, 32, 32, channels)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_model_input_21_is_a_view_of_the_scoremap():
    sample = {"scoremap": torch.zeros(2, 21, 8, 8)}
    inp = model_input(sample, 21)
    assert inp.data_ptr() == sample["scoremap"].data_ptr()
    assert inp.permute(0, 3, 1, 2).is_contiguous()


@pytest.mark.parametrize("flag", ["coord_uv_noise", "scoremap_dropout",
                                  "full_contract", "scale_to_size"])
def test_training_flags_wait_for_the_training_slice(flag):
    raw = torch_raw(seeded_raw(1, 48, seed=0))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        preprocess_batch(raw, **{flag: True})
