"""Port parity: the rest of the ops library, which no ported path calls.

``ops/camera.py``, ``camera_xyz_to_uv`` and ``absolute_to_rel_normed``,
``flip_right_hand``, ``bone_rel_trafo_inv``, ``render_gaussian_heatmap_3d``
and ``ops/patch.py``'s augmentation draws, affine transforms, warp and
heatmap-space transform.  The same numpy inputs go through the JAX op and
its port.  Tolerances: float32 results to 1e-6 of their range (the same
operations in the same order; the sums of a few products round alike);
``affine_warp_bilinear`` to 1e-5 (JAX chains the 2x2 inverse and the
sampling positions in float32, the port in float64 rounded once, so the
positions differ by a few float32 ulps, which the bilinear weights carry
into the output); flips, masks and the host numpy helpers exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handpose_tpu import ops as jops
from handpose_tpu_torch import ops

from _torch_port import max_rel_err
from _torch_port import port_worker_niced  # noqa: F401

RTOL = 1e-6
RTOL_WARP = 1e-5


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _hands(B, seed):
    """(B, 21, 3) plausible hands: a root near z = 0.6 and joints a few
    centimetres around it."""
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.04, (B, 21, 3)) + [0.0, 0.0, 0.6]
            ).astype(np.float32)


def test_the_port_exports_every_name_of_the_jax_ops_library():
    missing = [n for n in jops.__all__ if n not in ops.__all__
               or not hasattr(ops, n)]
    assert missing == []
    assert {"render_gaussian_maps_cuda", "stem_max_pool"} <= set(ops.__all__)


def test_camera_conversions():
    rng = np.random.default_rng(0)
    world = rng.normal(0, 0.2, (3, 21, 3)).astype(np.float32)
    R = np.stack([np.asarray(jops.axis_angle_rot_mat(
        rng.normal(0, 1, (1, 3)).astype(np.float32)))[0] for _ in range(3)])
    t = (rng.normal(0, 0.1, (3, 3)) + [0, 0, 0.7]).astype(np.float32)
    f = rng.uniform(400, 600, (3, 2)).astype(np.float32)
    c = rng.uniform(100, 200, (3, 2)).astype(np.float32)
    cam = np.array(jops.world2cam(world, R, t))
    cam[0, 0] = [0.01, -0.02, 0.0]            # the +1e-8 depth guard
    for name, args in (("world2cam", (world, R, t)),
                       ("cam2pixel", (cam, f, c)),
                       ("pixel2cam", (np.asarray(jops.cam2pixel(cam, f, c)),
                                      f, c))):
        want = np.asarray(getattr(jops, name)(*args))
        got = getattr(ops, name)(*map(T, args)).numpy()
        assert max_rel_err(want, got) <= RTOL, name


def test_camera_xyz_to_uv_and_absolute_to_rel_normed():
    xyz = _hands(4, 1)
    K = np.asarray([[480.0, 0, 160], [0, 470.0, 150], [0, 0, 1]], np.float32)
    for i in range(4):
        assert max_rel_err(jops.camera_xyz_to_uv(xyz[i], K),
                           ops.camera_xyz_to_uv(T(xyz[i]), T(K))) <= RTOL
    want = jops.absolute_to_rel_normed(jnp.asarray(xyz))
    got = ops.absolute_to_rel_normed(T(xyz))
    for w, g in zip(want, got):
        assert g.shape == w.shape
        assert max_rel_err(w, g) <= RTOL


def test_absolute_and_rel_normed_round_trip():
    xyz = _hands(6, 2)
    rel, scale, root = ops.absolute_to_rel_normed(T(xyz))
    back = ops.rel_normed_to_absolute(rel, scale, root).numpy()
    np.testing.assert_allclose(back, xyz, atol=1e-6)
    again = ops.absolute_to_rel_normed(T(back))
    np.testing.assert_allclose(again[0].numpy(), rel.numpy(), atol=1e-5)


@pytest.mark.parametrize("case", ["per_keypoint", "per_sample",
                                  "unbatched_per_keypoint",
                                  "unbatched_scalar"])
def test_flip_right_hand_on_each_cond_shape(case):
    rng = np.random.default_rng(3)
    coords = rng.normal(0, 1, (4, 21, 3)).astype(np.float32)
    conds = {"per_keypoint": (coords, rng.uniform(size=(4, 21)) > 0.5),
             "per_sample": (coords, rng.uniform(size=(4, 1)) > 0.5),
             "unbatched_per_keypoint": (coords[0],
                                        rng.uniform(size=(21,)) > 0.5),
             "unbatched_scalar": (coords[0], np.asarray(True))}
    c, cond = conds[case]
    want = np.asarray(jops.flip_right_hand(jnp.asarray(c), jnp.asarray(cond)))
    got = ops.flip_right_hand(T(c), T(cond)).numpy()
    assert got.shape == want.shape == c.shape
    np.testing.assert_array_equal(got, want)
    assert (got != c).any() and (got == c).any()


def test_flip_right_hand_scalar_cond_on_a_batch_and_python_bools():
    c = np.random.default_rng(4).normal(0, 1, (2, 21, 3)).astype(np.float32)
    for cond in (True, False):
        np.testing.assert_array_equal(
            ops.flip_right_hand(T(c), cond).numpy(),
            np.asarray(jops.flip_right_hand(jnp.asarray(c), cond)))


def test_bone_rel_trafo_inv_as_jax(fixtures):
    rel = np.asarray(jops.bone_rel_trafo(jnp.asarray(_hands(5, 5))))
    want = np.asarray(jops.bone_rel_trafo_inv(jnp.asarray(rel)))
    got = ops.bone_rel_trafo_inv(T(rel)).numpy()
    assert max_rel_err(want, got) <= RTOL
    # the golden fixture of the JAX test, and a (21, 3) input promoted
    f = fixtures("bone_rel")
    np.testing.assert_allclose(ops.bone_rel_trafo_inv(T(f["rel"])).numpy(),
                               f["back"], atol=3e-5)
    one = ops.bone_rel_trafo_inv(T(rel[0]))
    assert one.shape == (1, 21, 3)
    np.testing.assert_array_equal(one[0].numpy(), got[0])


def test_bone_rel_round_trip():
    xyz = _hands(8, 6)
    xyz = xyz - xyz[:, :1]                    # root-relative, as on the path
    back = ops.bone_rel_trafo_inv(ops.bone_rel_trafo(T(xyz))).numpy()
    np.testing.assert_allclose(back, xyz, atol=2e-6)


def test_render_gaussian_heatmap_3d_as_jax():
    rng = np.random.default_rng(7)
    joints = rng.uniform(-4, 20, (2, 42, 3)).astype(np.float32)
    joints[0, 0] = [3.5, 7.25, 0.0]           # not truncated to the grid
    want = np.asarray(jops.render_gaussian_heatmap_3d(joints, (16, 12, 20),
                                                      sigma=2.5))
    got = ops.render_gaussian_heatmap_3d(T(joints), (16, 12, 20), sigma=2.5)
    assert got.shape == (2, 42, 16, 12, 20) and got.dtype == torch.float32
    assert max_rel_err(want, got) <= RTOL
    assert float(got.max()) <= 255.0 and float(got.max()) > 200.0


def test_get_aug_config_bit_equal_over_seeds():
    rots = []
    for seed in range(200):
        want = jops.get_aug_config(np.random.default_rng(seed))
        got = ops.get_aug_config(np.random.default_rng(seed))
        assert got[0] == want[0] and got[1] == want[1]
        assert got[2] == want[2] and got[3] == want[3]
        np.testing.assert_array_equal(got[4], want[4])
        rots.append(got[2])
    # both branches of the rotation's gate occur
    assert 0.0 in rots and any(r != 0.0 for r in rots)


def test_gen_trans_from_patch_and_trans_point2d_bit_equal():
    rng = np.random.default_rng(8)
    for i in range(12):
        args = (float(rng.uniform(0, 300)), float(rng.uniform(0, 300)),
                float(rng.uniform(20, 200)), float(rng.uniform(20, 200)),
                256, 256, float(rng.uniform(0.75, 1.25)),
                float(rng.uniform(-90, 90)) if i % 3 else 0.0)
        for inv in (False, True):
            want = jops.gen_trans_from_patch(*args, inv=inv)
            got = ops.gen_trans_from_patch(*args, inv=inv)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)
            pt = rng.uniform(-50, 350, 2).astype(np.float32)
            np.testing.assert_array_equal(ops.trans_point2d(pt, got),
                                          jops.trans_point2d(pt, want))


def test_affine_warp_bilinear_as_jax():
    rng = np.random.default_rng(9)
    img = rng.uniform(0, 1, (3, 48, 64, 3)).astype(np.float32)
    trans = np.stack([ops.gen_trans_from_patch(
        30.0 + 7 * i, 22.0 - 3 * i, 40 + 9 * i, 30, 32, 24, 1.1,
        15.0 * (i + 1) - 20) for i in range(3)])
    # one patch that reaches far outside the source (zero border)
    trans[2] = ops.gen_trans_from_patch(60.0, 5.0, 90, 90, 32, 24, 1.3, 40)
    want = np.asarray(jops.affine_warp_bilinear(jnp.asarray(img),
                                                jnp.asarray(trans), (24, 32)))
    got = ops.affine_warp_bilinear(T(img), T(trans), (24, 32))
    assert got.shape == (3, 24, 32, 3)
    assert max_rel_err(want, got) <= RTOL_WARP
    assert (want[2] == 0).any()


def test_transform_input_to_output_space_as_jax():
    rng = np.random.default_rng(10)
    jc = rng.uniform(0, 256, (2, 42, 3)).astype(np.float32)
    jc[..., 2] = rng.uniform(-300, 300, (2, 42))
    valid = (rng.uniform(size=(2, 42)) > 0.2).astype(np.float32)
    rd = np.asarray([-250.0, 120.0], np.float32)
    rv = np.ones(2, np.float32)
    kw = dict(root_joint_idx={"right": 20, "left": 41},
              joint_type={"right": np.arange(21), "left": np.arange(21, 42)})
    want = jops.transform_input_to_output_space(
        jnp.asarray(jc), jnp.asarray(valid), jnp.asarray(rd),
        jnp.asarray(rv), **kw)
    got = ops.transform_input_to_output_space(T(jc), T(valid), T(rd), T(rv),
                                              **kw)
    assert max_rel_err(want[0], got[0]) <= RTOL
    assert max_rel_err(want[2], got[2]) <= RTOL
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert 0 < float(got[1].sum()) < float(T(valid).sum())


def test_patch_bbox_helpers_unchanged():
    rng = np.random.default_rng(11)
    img = rng.uniform(0, 300, (21, 2)).astype(np.float32)
    valid = (rng.uniform(size=21) > 0.3).astype(np.float32)
    bbox = ops.get_bbox(img, valid)
    np.testing.assert_array_equal(bbox, jops.get_bbox(img, valid))
    np.testing.assert_array_equal(ops.process_bbox(bbox, (334, 512)),
                                  jops.process_bbox(bbox, (334, 512)))
