"""Port parity: Hand3DPosePriorNetwork in float32, both branches.

The JAX model's variables are carried across with
``handpose_tpu_torch.convert.load_flax_variables``.  Tolerance: max
|torch - jax| <= 1e-4 of the output's range (float32 convolutions and
matmuls sum in another order; up to 2e-6 is observed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handpose_tpu.config import Config as JConfig
from handpose_tpu.models import build_model as jbuild
from handpose_tpu_torch.config import Config
from handpose_tpu_torch.convert import load_flax_variables
from handpose_tpu_torch.models import build_model

from _torch_port import MODEL, flax_weights, max_rel_err, unflatten

CROP, CH, B = 64, 21, 2
RTOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    inputs = (rng.uniform(0, 1, (B, CROP, CROP, CH)).astype(np.float32),
              np.tile(np.asarray([[200., 0, 32], [0, 200., 32], [0, 0, 1]],
                                 np.float32), (B, 1, 1)),
              rng.uniform(0.01, 0.02, (B, 1)).astype(np.float32),
              (rng.normal(0, 0.1, (B, 3)) + [0, 0, 0.6]).astype(np.float32))
    return flax_weights(CROP, CH), inputs


def _outputs(flat, inputs, is_inference, dtype):
    jcfg = JConfig(model_name=MODEL, input_channels=CH,
                   input_img_shape=(CROP, CROP), compute_dtype=dtype)
    jm = jbuild(jcfg, is_inference=is_inference)
    ref = jax.jit(jm.apply)(unflatten(flat), *map(jnp.asarray, inputs))
    cfg = Config(model_name=MODEL, input_channels=CH,
                 input_img_shape=(CROP, CROP), compute_dtype=dtype)
    model = load_flax_variables(build_model(cfg, is_inference), flat)
    with torch.no_grad():
        out = model(*(torch.from_numpy(a) for a in inputs))
    return ref, out


@pytest.fixture(scope="module")
def train_branch(setup):
    return _outputs(*setup, False, "float32")


@pytest.fixture(scope="module")
def inference_branch(setup):
    return _outputs(*setup, True, "float32")


@pytest.mark.parametrize("key", ["can_xyz", "rot_mat", "coord_xyz_rel_normed"])
def test_train_branch_outputs(train_branch, key):
    ref, out = train_branch
    assert getattr(out, key).dtype == torch.float32
    assert max_rel_err(getattr(ref, key), getattr(out, key)) <= RTOL


@pytest.mark.parametrize("key", ["xyz", "uv"])
def test_inference_branch_outputs(inference_branch, key):
    ref, out = inference_branch
    assert out.can_xyz is None
    assert max_rel_err(getattr(ref, key), getattr(out, key)) <= RTOL


def test_convert_fills_every_tensor_exactly(setup):
    flat, _ = setup
    cfg = Config(model_name=MODEL, input_channels=CH,
                 input_img_shape=(CROP, CROP))
    model = load_flax_variables(build_model(cfg), flat)
    sd = model.state_dict()
    assert len(sd) == len(flat)
    k = "params/PosePrior_net/backbone/trunk/BasicBlock_2/Conv_0/kernel"
    np.testing.assert_array_equal(
        sd["PosePrior_net.backbone.trunk.BasicBlock_2.Conv_0.weight"].numpy(),
        flat[k].transpose(3, 2, 0, 1))
    k = "params/ViewPoint_net/mlp/Dense_1/kernel"
    np.testing.assert_array_equal(
        sd["ViewPoint_net.mlp.Dense_1.weight"].numpy(), flat[k].T)
    k = "batch_stats/ViewPoint_net/backbone/trunk/BasicBlock_4/norm_proj/var"
    np.testing.assert_array_equal(
        sd["ViewPoint_net.backbone.trunk.BasicBlock_4.norm_proj.running_var"]
        .numpy(), flat[k])


def test_convert_rejects_missing_unused_and_misshapen(setup):
    flat, _ = setup
    cfg = Config(model_name=MODEL, input_channels=CH,
                 input_img_shape=(CROP, CROP))
    model = build_model(cfg)
    key = "params/PosePrior_net/backbone/trunk/bn_init/scale"
    with pytest.raises(KeyError, match="no flax variable"):
        load_flax_variables(model, {k: v for k, v in flat.items()
                                    if k != key})
    with pytest.raises(KeyError, match="has no"):
        load_flax_variables(model, {**flat,
                                    "params/PosePrior_net/extra/kernel":
                                    np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="does not fit"):
        load_flax_variables(model, {**flat, key: np.ones(3, np.float32)})


def test_seeded_init_is_deterministic_and_he_scaled():
    cfg = Config(model_name=MODEL, input_channels=CH,
                 input_img_shape=(CROP, CROP))
    a = build_model(cfg.replace(seed=3)).state_dict()
    b = build_model(cfg.replace(seed=3)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["PosePrior_net.backbone.trunk.conv_init.weight"]
    assert abs(float(w.std()) - (2.0 / (9 * CH)) ** 0.5) < 0.02


def test_train_mode_and_other_models_wait_for_later_slices():
    """Train mode runs now (batch statistics; the running statistics
    move); the other models and stems still wait for later slices."""
    cfg = Config(model_name=MODEL, input_channels=CH,
                 input_img_shape=(32, 32))
    model = build_model(cfg)
    bn = model.PosePrior_net.backbone.trunk.bn_init
    before = bn.running_mean.clone()
    x = torch.rand(2, 32, 32, CH)
    with torch.no_grad():
        out = model.train()(x)
    assert torch.isfinite(out.can_xyz).all()
    assert not torch.equal(bn.running_mean, before)
    with pytest.raises(ValueError, match="pool_grad"):
        build_model(cfg.replace(pool_grad="scatter"))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_model(cfg.replace(model_name="OnlyThreeDimHandPose"))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_model(cfg.replace(resnet_stem="k3s2_s2d"))
