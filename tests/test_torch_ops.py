"""Port parity: geometry ops and the plain scoremap render.

The same numpy inputs go through the JAX op and its PyTorch port; the
fixtures are the torch reference's recorded outputs.  Tolerances are the
JAX tests' own (tests/test_ops_geometry.py) unless stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handpose_tpu import ops as jops
from handpose_tpu.ops.pallas_kernels import render_gaussian_maps_pallas
from handpose_tpu_torch import ops
from handpose_tpu_torch.ops import scoremap_cuda

from _torch_port import port_worker_niced  # noqa: F401  (one torch thread, niced)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_axis_angle_rot_mat(fixtures):
    f = fixtures("rotations")
    R = ops.axis_angle_rot_mat(T(f["u"])).numpy()
    np.testing.assert_allclose(R, f["R_aa"], atol=2e-6)
    np.testing.assert_allclose(
        R, np.asarray(jax.jit(jops.axis_angle_rot_mat)(f["u"])), atol=2e-6)


def test_rot_mats_and_atan2_safe():
    rng = np.random.default_rng(0)
    a = rng.uniform(-4, 4, (64,)).astype(np.float32)
    for jf, tf in ((jops.rot_mat_x, ops.rot_mat_x),
                   (jops.rot_mat_y, ops.rot_mat_y),
                   (jops.rot_mat_z, ops.rot_mat_z)):
        np.testing.assert_allclose(tf(T(a)).numpy(), np.asarray(jf(a)),
                                   atol=1e-6)
    y = rng.normal(size=(256,)).astype(np.float32)
    x = rng.normal(size=(256,)).astype(np.float32)
    x[:8] = 0.0                                   # the 1e-8 guard
    np.testing.assert_allclose(ops.atan2_safe(T(y), T(x)).numpy(),
                               np.asarray(jops.atan2_safe(y, x)), atol=2e-6)


def test_batch_projection(fixtures):
    f = fixtures("projection")
    uv = ops.batch_project_xyz_to_uv(T(f["xyz"]), T(f["K"])).numpy()
    np.testing.assert_allclose(uv, f["uv"], rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(
        uv, np.asarray(jax.jit(jops.batch_project_xyz_to_uv)(f["xyz"], f["K"])),
        rtol=1e-5, atol=1e-3)


def test_rel_normed_to_absolute():
    rng = np.random.default_rng(1)
    rel = rng.normal(size=(4, 21, 3)).astype(np.float32)
    s = rng.uniform(0.05, 0.1, (4, 1)).astype(np.float32)
    root = rng.normal(size=(4, 3)).astype(np.float32)
    np.testing.assert_allclose(
        ops.rel_normed_to_absolute(T(rel), T(s), T(root)).numpy(),
        np.asarray(jops.rel_normed_to_absolute(rel, s, root)), atol=1e-6)


def test_canonical_trafo(fixtures):
    f = fixtures("canonical")
    normed, rot = ops.canonical_trafo(T(f["coords"]))
    np.testing.assert_allclose(normed.numpy(), f["normed"], atol=2e-5)
    np.testing.assert_allclose(rot.numpy(), f["rot"], atol=2e-5)
    jn, jr = jax.jit(jops.canonical_trafo)(f["coords"])
    np.testing.assert_allclose(normed.numpy(), np.asarray(jn), atol=2e-5)
    np.testing.assert_allclose(rot.numpy(), np.asarray(jr), atol=2e-5)


def test_bone_rel_trafo(fixtures):
    f = fixtures("bone_rel")
    rel = ops.bone_rel_trafo(T(f["coords"])).numpy()
    np.testing.assert_allclose(rel, f["rel"], atol=3e-5)
    np.testing.assert_allclose(
        rel, np.asarray(jax.jit(jops.bone_rel_trafo)(f["coords"])), atol=3e-5)


def test_crop_params_and_resize(fixtures):
    f = fixtures("crop")
    uv, vis = T(f["kp_uv"]), T(f["kp_vis"])
    params = ops.compute_crop_params(uv, vis, (320, 320), 256)
    np.testing.assert_array_equal(
        torch.stack([params.y1, params.x1], 1).numpy(), f["y1x1"])
    np.testing.assert_array_equal(
        torch.stack([params.len_y, params.len_x], 1).numpy(), f["lens"])
    crops = ops.crop_resize_bilinear(T(f["img"]), params, 256).numpy()
    np.testing.assert_allclose(crops, f["crops"], atol=1e-5)
    np.testing.assert_allclose(ops.crop_uv(uv, params).numpy(), f["uvs"],
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(ops.crop_intrinsics(T(f["K"]), params).numpy(),
                               f["K_new"], rtol=1e-5, atol=1e-3)


def _random_crop_inputs(B, seed):
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-40, 360, (B, 21, 2)).astype(np.float32)
    c = rng.uniform(40, 280, (B, 1, 2))
    spread = rng.uniform(3, 60, (B // 2, 1, 1))
    uv[:B // 2] = (c[:B // 2] + rng.normal(0, 1, (B // 2, 21, 2)) * spread
                   ).astype(np.float32)
    vis = rng.uniform(size=(B, 21)) > 0.3
    vis[0] = False                                  # nothing visible
    return uv, vis


def test_crop_params_exact_vs_jitted_jax():
    """Every CropParams field equal to the jitted JAX function's on 4096
    random hands: the window truncates to whole pixels, so the port must
    round exactly as XLA does."""
    uv, vis = _random_crop_inputs(4096, seed=7)
    jp = jax.jit(lambda u, v: jops.compute_crop_params(u, v, (320, 320), 256)
                 )(uv, vis)
    tp = ops.compute_crop_params(T(uv), T(vis), (320, 320), 256)
    for name, a, b in zip(tp._fields, jp, tp):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


@pytest.mark.parametrize("noises", ["center", "scale", "offset", "all"])
def test_crop_params_under_noise_exact_vs_jitted_jax(noises):
    """CropParams equal to the jitted JAX function's on 1,024 random
    hands under the crop centre, scale and offset noise of the
    augmentations (N(0, 20^2), U(0, 1) * 0.2 + 1, N(0, 10^2)), alone
    and together: noisy centres past the border exercise the start and
    length clamps, scales up to 12 the truncation."""
    uv, vis = _random_crop_inputs(1024, seed=11)
    rng = np.random.default_rng(12)
    noise = {"center": (20 * rng.normal(size=(1024, 2))).astype(np.float32),
             "scale": (rng.uniform(size=1024) * 0.2 + 1).astype(np.float32),
             "offset": (10 * rng.normal(size=(1024, 2))).astype(np.float32)}
    on = list(noise) if noises == "all" else [noises]
    args = [noise[k] if k in on else None for k in noise]
    jp = jax.jit(lambda u, v, c, s, o: jops.compute_crop_params(
        u, v, (320, 320), 256, c, s, o))(uv, vis, *args)
    tp = ops.compute_crop_params(T(uv), T(vis), (320, 320), 256,
                                 *[None if a is None else T(a) for a in args])
    for name, a, b in zip(tp._fields, jp, tp):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    if noises == "all":
        y1 = tp.y1.numpy()
        assert (y1 == 0).any() and (tp.len_y.numpy() < 256).any()


def test_crop_resize_and_geometry_vs_jax():
    rng = np.random.default_rng(3)
    uv, vis = _random_crop_inputs(6, seed=3)
    img = rng.uniform(-0.5, 0.5, (6, 80, 96, 3)).astype(np.float32)
    mask = (rng.uniform(size=(6, 80, 96)) > 0.5).astype(np.float32)
    K = rng.uniform(50, 300, (6, 3, 3)).astype(np.float32)
    uv = uv * np.float32(0.25)
    jp = jax.jit(lambda u, v: jops.compute_crop_params(u, v, (80, 96), 64)
                 )(uv, vis)
    tp = ops.compute_crop_params(T(uv), T(vis), (80, 96), 64)
    for name, a, b in zip(tp._fields, jp, tp):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    np.testing.assert_allclose(
        ops.crop_resize_bilinear(T(img), tp, 64).numpy(),
        np.asarray(jax.jit(jops.crop_resize_bilinear, static_argnums=2)(
            img, jp, 64)), atol=1e-5)
    np.testing.assert_array_equal(
        ops.crop_resize_nearest(T(mask), tp, 64).numpy(),
        np.asarray(jops.crop_resize_nearest(mask, jp, 64)))
    np.testing.assert_allclose(ops.crop_uv(T(uv), tp).numpy(),
                               np.asarray(jops.crop_uv(uv, jp)),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(ops.crop_intrinsics(T(K), tp).numpy(),
                               np.asarray(jops.crop_intrinsics(K, jp)),
                               rtol=1e-5, atol=1e-3)


# ---- scoremap: the plain version the CUDA kernel is held to ----------------
# tolerance atol 1e-6: maps lie in [0, 1]; the forms agree to a few f32 ulps

def _scoremap_cases():
    rng = np.random.default_rng(5)
    coords = rng.uniform(-20, 84, (3, 21, 2)).astype(np.float32)
    coords[0, 0] = (0.0, 30.0)          # on the lower edge: gated off
    coords[0, 1] = (63.0, 30.0)         # H-1: gated off
    coords[0, 2] = (62.9, 1.2)          # truncates inside
    coords[0, 3] = (-0.7, 10.0)         # truncates to 0: gated off
    coords[0, 4] = (-5.0, -3.0)         # negative
    coords[0, 5] = (1.0, 47.0)          # W-1 of the 64x48 case
    vis = rng.uniform(size=(3, 21)) > 0.25
    vis[0, 2] = False                   # inside but invisible
    return coords, vis


@pytest.mark.parametrize("size", [(64, 64), (64, 48), (37, 53)])
def test_scoremap_plain_vs_jax(size):
    coords, vis = _scoremap_cases()
    ref = np.asarray(jax.jit(lambda c, v: jops.render_gaussian_maps(
        c, size, 25.0, v))(coords, vis))
    out = ops.render_gaussian_maps(T(coords), size, 25.0, T(vis)).numpy()
    assert out.shape == (3, 21) + size and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-6)
    # the cases really gate: some maps are zero, some are not
    peak = out.reshape(3, 21, -1).max(-1)
    assert (peak == 0).any() and (peak > 0.9).any()


def test_scoremap_plain_takes_non_finite_and_huge_coords_as_jax():
    """NaN, +-inf and coordinates past int32 on either axis: the host's
    int32 cast differs from JAX's (INT_MIN against 0 or the saturated
    edge), but every such coordinate lands outside ``0 < c < H - 1``
    under both, so the maps are equal (all zero) to JAX's."""
    coords, vis = _scoremap_cases()
    bad = [np.nan, np.inf, -np.inf, 3e9, -3e9, 1e10]
    for i, v in enumerate(bad):
        coords[1, 2 * i] = (v, 30.0)
        coords[1, 2 * i + 1] = (20.0, v)
    vis[1] = True
    ref = np.asarray(jax.jit(lambda c, v: jops.render_gaussian_maps(
        c, (64, 48), 25.0, v))(coords, vis))
    out = ops.render_gaussian_maps(T(coords), (64, 48), 25.0, T(vis)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)
    assert not out[1, :2 * len(bad)].any()


@pytest.mark.parametrize("size", [(64, 64), (64, 48)])
def test_scoremap_plain_vs_pallas_interpret(size):
    coords, vis = _scoremap_cases()
    ref = np.asarray(render_gaussian_maps_pallas(
        jnp.asarray(coords), size, 25.0, jnp.asarray(vis), interpret=True))
    out = ops.render_gaussian_maps(T(coords), size, 25.0, T(vis)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_scoremap_plain_vs_fixture(fixtures):
    f = fixtures("scoremap")
    out = ops.render_gaussian_maps(T(f["coords_hw"]), (256, 256), 25.0,
                                   T(f["vis"])).numpy()
    np.testing.assert_allclose(out, f["maps"], atol=1e-6)


def test_scoremap_wrapper_on_host_uses_plain_and_counts_nothing():
    coords, vis = _scoremap_cases()
    before = scoremap_cuda.KERNEL.launches
    out = ops.render_gaussian_maps_cuda(T(coords), (64, 48), 25.0, T(vis))
    ref = ops.render_gaussian_maps(T(coords), (64, 48), 25.0, T(vis))
    assert torch.equal(out, ref)
    assert scoremap_cuda.KERNEL.launches == before


def test_stem_max_pool_matches_flax():
    import flax.linen as fnn
    x = np.random.default_rng(2).normal(size=(2, 9, 12, 4)).astype(np.float32)
    ref = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                                  padding=((1, 1), (1, 1))))
    out = ops.stem_max_pool(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(out.numpy(), ref)
