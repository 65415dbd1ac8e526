"""Port parity: the rotation functions, forward kinematics and the MANO
layer against the JAX package, float32 on the host.

* ``euler_xyz_rot_mat`` on ``tests/fixtures/rotations.npz`` and against
  JAX, ``rodrigues`` against JAX at |r| ~ 1, 1e-3, 1e-20 and 0, values
  and gradients to 1e-6 (which branch each side takes at 1e-20 differs:
  XLA on the CPU flushes the denormal |r|^2 to zero and takes the Taylor
  branch, torch takes the closed form; the two agree there to float32
  rounding), the gradient at a zero rotation finite;
* FK on ``tests/fixtures/fk.npz`` (the torch reference's outputs) at the
  JAX test's tolerances (xyz atol 2e-5; uv rtol 1e-4, atol 5e-2) and
  against ``handpose_tpu.nn.fk`` at 1e-6 of range, both joint orders,
  with its gradient in every input to 1e-5 of range;
* ``synthetic_mano`` equal to the JAX stand-in bit for bit, and the MANO
  layer on it against JAX's for pose_num 6, 10 and 45 (vertices and
  joints 1e-5 of range, gradients in rots, poses and betas 1e-5 of
  range), one JAX program per pose_num;
* ``load_mano`` of a pickle written here (MANO's keys, a chumpy-pickled
  template, a scipy-sparse ``J_regressor``) equal to JAX's, through the
  explicit path (a missing one refused) and ``$MANO_RIGHT_PKL``, and the
  layer's constants
  outside ``state_dict()``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handpose_tpu.nn import fk as jfk
from handpose_tpu.nn import mano as jmano
from handpose_tpu.ops import rotations as jrot
from handpose_tpu_torch.nn import fk, mano
from handpose_tpu_torch.ops import rotations

from _torch_port import max_rel_err, write_mano_pickle
from _torch_port import port_worker_niced  # noqa: F401

T = torch.from_numpy
B = 3


def test_euler_xyz_rot_mat_matches_fixture_and_jax(fixtures):
    f = fixtures("rotations")
    got = rotations.euler_xyz_rot_mat(T(f["angles"])).numpy()
    np.testing.assert_allclose(got, f["R_euler"], atol=1e-6)
    np.testing.assert_allclose(
        got, np.asarray(jrot.euler_xyz_rot_mat(jnp.asarray(f["angles"]))),
        atol=1e-6)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e-20, 0.0])
def test_rodrigues_and_its_gradient_match_jax(scale):
    rng = np.random.default_rng(7)
    r = rng.normal(size=(8, 3)).astype(np.float32)
    r = (r / np.linalg.norm(r, axis=1, keepdims=True) * scale).astype(
        np.float32)
    w = rng.normal(size=(8, 3, 3)).astype(np.float32)
    want = np.asarray(jrot.rodrigues(jnp.asarray(r)))
    jgrad = np.asarray(jax.grad(lambda v: jnp.sum(
        jrot.rodrigues(v) * w))(jnp.asarray(r)))
    rt = T(r).requires_grad_(True)
    got = rotations.rodrigues(rt)
    (got * T(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6)
    assert torch.isfinite(rt.grad).all()
    np.testing.assert_allclose(rt.grad.numpy(), jgrad, atol=1e-6)
    if scale == 0.0:
        np.testing.assert_array_equal(want, np.broadcast_to(np.eye(3),
                                                            want.shape))


def _fk_inputs(f):
    return [f[k] for k in ("root_angles", "other_angles", "bone_lengths",
                           "K", "scale", "root")]


@pytest.mark.parametrize("switched", [True, False])
def test_fk_matches_the_fixture(fixtures, switched):
    f = fixtures("fk")
    xyz, uv = fk.forward_kinematics(*map(T, _fk_inputs(f)),
                                    joint_order_switched=switched)
    key = "noswitch" if switched else "switch"       # the fixture's names
    np.testing.assert_allclose(xyz.numpy(), f[f"xyz_{key}"], atol=2e-5)
    np.testing.assert_allclose(uv.numpy(), f[f"uv_{key}"], rtol=1e-4,
                               atol=5e-2)


@pytest.mark.parametrize("switched", [True, False])
def test_fk_and_its_gradient_match_jax(fixtures, switched):
    f = fixtures("fk")
    args = _fk_inputs(f)
    rng = np.random.default_rng(int(switched))
    wx = rng.normal(size=f["xyz_switch"].shape).astype(np.float32)
    wu = rng.normal(size=f["uv_switch"].shape).astype(np.float32) * 1e-3

    def jloss(*a):
        xyz, uv = jfk.forward_kinematics(*a, joint_order_switched=switched)
        return jnp.sum(xyz * wx) + jnp.sum(uv * wu), (xyz, uv)

    (_, (jxyz, juv)), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(6)), has_aux=True))(
            *map(jnp.asarray, args))
    ts = [T(a).requires_grad_(True) for a in args]
    xyz, uv = fk.forward_kinematics(*ts, joint_order_switched=switched)
    ((xyz * T(wx)).sum() + (uv * T(wu)).sum()).backward()
    assert max_rel_err(jxyz, xyz.detach()) <= 1e-6
    assert max_rel_err(juv, uv.detach()) <= 1e-6
    for t, g in zip(ts, jgrads):
        assert max_rel_err(g, t.grad) <= 1e-5


def test_synthetic_mano_equals_the_jax_stand_in():
    mine, theirs = mano.synthetic_mano(), jmano.synthetic_mano()
    for name in mano.ManoModel._fields:
        a, b = getattr(mine, name), getattr(theirs, name)
        if name == "parents":
            assert a == b
        else:
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def _mano_inputs(pose_num, seed):
    rng = np.random.default_rng(seed)
    rots = rng.normal(size=(B, 3)).astype(np.float32)
    rots[0] = 0.0                        # a zero rotation: Taylor branch
    return (rots, rng.normal(size=(B, pose_num)).astype(np.float32),
            rng.normal(size=(B, 10)).astype(np.float32) * 0.5,
            rng.normal(size=(B, 778, 3)).astype(np.float32),
            rng.normal(size=(B, 21, 3)).astype(np.float32))


@pytest.mark.parametrize("pose_num", [6, 10, 45])
def test_mano_layer_and_its_gradients_match_jax(pose_num):
    rots, poses, betas, wv, wj = _mano_inputs(pose_num, pose_num)
    jlayer = jmano.ManoLayer(model=jmano.synthetic_mano(), pose_num=pose_num)

    def jloss(r, p, b):
        v, j = jlayer(r, p, b)
        return jnp.sum(v * wv) + jnp.sum(j * wj), (v, j)

    (_, (jv, jj)), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(
            *map(jnp.asarray, (rots, poses, betas)))
    layer = mano.ManoLayer(mano.synthetic_mano(), pose_num=pose_num)
    ts = [T(a).requires_grad_(True) for a in (rots, poses, betas)]
    v, j = layer(*ts)
    assert v.shape == (B, 778, 3) and j.shape == (B, 21, 3)
    assert v.dtype == j.dtype == torch.float32
    ((v * T(wv)).sum() + (j * T(wj)).sum()).backward()
    assert max_rel_err(jv, v.detach()) <= 1e-5
    assert max_rel_err(jj, j.detach()) <= 1e-5
    for t, g in zip(ts, jgrads):
        assert torch.isfinite(t.grad).all()
        assert max_rel_err(g, t.grad) <= 1e-5


def test_load_mano_of_a_pickle_matches_jax(tmp_path, monkeypatch):
    src = mano.synthetic_mano(seed=3)
    path = str(tmp_path / "MANO_RIGHT.pkl")
    write_mano_pickle(path, src)
    # the port's own chumpy stub, then JAX's
    for k in ("chumpy", "chumpy.ch", "chumpy.reordering"):
        monkeypatch.delitem(sys.modules, k, raising=False)
    mine = mano.load_mano(path)
    for k in ("chumpy", "chumpy.ch", "chumpy.reordering"):
        monkeypatch.delitem(sys.modules, k, raising=False)
    theirs = jmano.load_mano(path)
    for name in mano.ManoModel._fields:
        a, b = getattr(mine, name), getattr(theirs, name)
        if name == "parents":
            assert a == b == src.parents
        else:
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(mine.v_template, src.v_template)
    np.testing.assert_array_equal(mine.J_regressor, src.J_regressor)
    monkeypatch.setenv("MANO_RIGHT_PKL", path)
    assert mano.find_mano_pkl() == path
    assert mano.mano_source() == os.path.abspath(path)
    # an explicit path is taken or refused, never passed over
    with pytest.raises(FileNotFoundError):
        mano.find_mano_pkl(str(tmp_path / "absent.pkl"))
    monkeypatch.delenv("MANO_RIGHT_PKL")
    monkeypatch.chdir(tmp_path)
    assert mano.find_mano_pkl() is None
    assert mano.mano_source() == mano.SYNTHETIC
    np.testing.assert_array_equal(mano.load_mano().v_template,
                                  mano.synthetic_mano().v_template)


def test_mano_constants_stay_out_of_state_dict():
    layer = mano.ManoLayer(mano.synthetic_mano(), pose_num=6)
    assert layer.state_dict() == {} and not list(layer.parameters())
    bufs = dict(layer.named_buffers())
    assert tuple(bufs["hands_components"].shape) == (6, 45)
    assert tuple(bufs["shape_basis"].shape) == (10, 778 * 3)
    assert all(b.dtype == torch.float32 for b in bufs.values())
    assert layer.to(torch.device("cpu")).v_template.device.type == "cpu"
