"""Port parity: Hand3DPosePriorNetwork in float32 and in bfloat16 (the
serving dtype), both branches.

The JAX model's variables are carried across with
``handpose_tpu_torch.convert.load_flax_variables``.  Float32 tolerance:
max |torch - jax| <= 1e-4 of the output's range (float32 convolutions
and matmuls sum in another order; up to 2e-6 is observed).

bfloat16: bf16 convolutions with float32 parameters, BatchNorm
normalising in float32 and casting back, the trunk's fc in bf16 on the
float32 spatial mean, and float32 heads, as in the JAX package.  bf16
keeps 8 bits of mantissa (2^-8 = 0.4%).  The two frameworks round single
outputs of a convolution differently (one bf16 ulp), the 18 layers of
each trunk carry those flips to the heads, and the viewpoint's
axis-angle map amplifies them.  So each output is held two ways, as a
share of its range:
* |torch_bf16 - jax_bf16| <= 5e-2;
* |torch_bf16 - jax_f32| <= 3 x |jax_bf16 - jax_f32| + 1e-3: the port's
  bf16 result is about as close to the exact one as JAX's own is.

Each JAX forward (dtype x branch) is compiled once for the file.
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
from _torch_port import port_worker_niced  # noqa: F401

CROP, CH, B = 64, 21, 2
RTOL = 1e-4
RTOL_BF16 = 5e-2


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (B, CROP, CROP, CH)).astype(np.float32),
            np.tile(np.asarray([[200., 0, 32], [0, 200., 32], [0, 0, 1]],
                               np.float32), (B, 1, 1)),
            rng.uniform(0.01, 0.02, (B, 1)).astype(np.float32),
            (rng.normal(0, 0.1, (B, 3)) + [0, 0, 0.6]).astype(np.float32))


@pytest.fixture(scope="module")
def setup():
    return flax_weights(CROP, CH), _inputs(0)


@pytest.fixture(scope="module")
def jax_out():
    """``jax_out(flat, inputs, is_inference, dtype)``: the JAX model's
    output, its forward jitted once per (dtype, branch) for the file."""
    fns = {}

    def run(flat, inputs, is_inference, dtype):
        key = (dtype, is_inference)
        if key not in fns:
            jcfg = JConfig(model_name=MODEL, input_channels=CH,
                           input_img_shape=(CROP, CROP), compute_dtype=dtype)
            fns[key] = jax.jit(jbuild(jcfg, is_inference=is_inference).apply)
        return fns[key](unflatten(flat), *map(jnp.asarray, inputs))

    return run


def _port_out(flat, inputs, is_inference, dtype):
    cfg = Config(model_name=MODEL, input_channels=CH,
                 input_img_shape=(CROP, CROP), compute_dtype=dtype)
    model = load_flax_variables(build_model(cfg, is_inference), flat)
    with torch.no_grad():
        return model(*(torch.from_numpy(a) for a in inputs))


@pytest.fixture(scope="module")
def train_branch(setup, jax_out):
    return (jax_out(*setup, False, "float32"),
            _port_out(*setup, False, "float32"))


@pytest.fixture(scope="module")
def inference_branch(setup, jax_out):
    return (jax_out(*setup, True, "float32"),
            _port_out(*setup, True, "float32"))


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
    move); a model name outside the zoo and a stem outside the three are
    refused."""
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
    with pytest.raises(ValueError, match="not supported"):
        build_model(cfg.replace(model_name="DiffusionHandPoseV2"))
    with pytest.raises(ValueError, match="resnet_stem"):
        build_model(cfg.replace(resnet_stem="k5s2"))


# ---- bfloat16 ----


@pytest.fixture(scope="module")
def setup_bf16():
    return flax_weights(CROP, CH, seed=1), _inputs(1)


def _outputs_bf16(jax_out, flat, inputs, is_inference):
    """(jax bf16, jax f32, torch bf16) outputs."""
    return (jax_out(flat, inputs, is_inference, "bfloat16"),
            jax_out(flat, inputs, is_inference, "float32"),
            _port_out(flat, inputs, is_inference, "bfloat16"))


def _check(outputs, key):
    ref, exact, out = (getattr(o, key) for o in outputs)
    assert out.dtype == torch.float32
    assert max_rel_err(ref, out) <= RTOL_BF16
    assert max_rel_err(exact, out) <= 3 * max_rel_err(exact, ref) + 1e-3


@pytest.fixture(scope="module")
def train_branch_bf16(setup_bf16, jax_out):
    return _outputs_bf16(jax_out, *setup_bf16, False)


@pytest.fixture(scope="module")
def inference_branch_bf16(setup_bf16, jax_out):
    return _outputs_bf16(jax_out, *setup_bf16, True)


@pytest.mark.parametrize("key", ["can_xyz", "rot_mat", "coord_xyz_rel_normed"])
def test_train_branch_outputs_bf16(train_branch_bf16, key):
    _check(train_branch_bf16, key)


@pytest.mark.parametrize("key", ["xyz", "uv"])
def test_inference_branch_outputs_bf16(inference_branch_bf16, key):
    _check(inference_branch_bf16, key)


def test_bf16_trunk_activations_and_f32_features():
    """The trunk computes in bf16 and hands the heads float32."""
    cfg = Config(model_name=MODEL, input_channels=CH,
                 input_img_shape=(32, 32), compute_dtype="bfloat16")
    trunk = build_model(cfg).PosePrior_net.backbone.trunk
    seen = []
    hook = trunk.BasicBlock_0.register_forward_hook(
        lambda m, i, o: seen.append(o.dtype))
    x = torch.rand(1, CH, 32, 32).to(torch.bfloat16)
    with torch.no_grad():
        feat = trunk(x)
    hook.remove()
    assert seen == [torch.bfloat16]
    assert feat.dtype == torch.float32 and feat.shape == (1, 1000)
