"""Port parity: Hand3DPosePriorNetwork in bfloat16 (the serving dtype).

bf16 convolutions with float32 parameters, BatchNorm normalising in
float32 and casting back, the trunk's fc in bf16 on the float32 spatial
mean, and float32 heads, as in the JAX package.

bf16 keeps 8 bits of mantissa (2^-8 = 0.4%).  The two frameworks round
single outputs of a convolution differently (one bf16 ulp), the 18 layers
of each trunk carry those flips to the heads, and the viewpoint's
axis-angle map amplifies them.  So each output is held two ways, as a
share of its range:
* |torch_bf16 - jax_bf16| <= 5e-2;
* |torch_bf16 - jax_f32| <= 3 x |jax_bf16 - jax_f32| + 1e-3: the port's
  bf16 result is about as close to the exact one as JAX's own is.
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
RTOL = 5e-2


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(1)
    inputs = (rng.uniform(0, 1, (B, CROP, CROP, CH)).astype(np.float32),
              np.tile(np.asarray([[200., 0, 32], [0, 200., 32], [0, 0, 1]],
                                 np.float32), (B, 1, 1)),
              rng.uniform(0.01, 0.02, (B, 1)).astype(np.float32),
              (rng.normal(0, 0.1, (B, 3)) + [0, 0, 0.6]).astype(np.float32))
    return flax_weights(CROP, CH, seed=1), inputs


def _outputs(flat, inputs, is_inference):
    """(jax bf16, jax f32, torch bf16) outputs."""
    refs = []
    for dt in ("bfloat16", "float32"):
        jcfg = JConfig(model_name=MODEL, input_channels=CH,
                       input_img_shape=(CROP, CROP), compute_dtype=dt)
        jm = jbuild(jcfg, is_inference=is_inference)
        refs.append(jax.jit(jm.apply)(unflatten(flat),
                                      *map(jnp.asarray, inputs)))
    cfg = Config(model_name=MODEL, input_channels=CH,
                 input_img_shape=(CROP, CROP), compute_dtype="bfloat16")
    model = load_flax_variables(build_model(cfg, is_inference), flat)
    with torch.no_grad():
        out = model(*(torch.from_numpy(a) for a in inputs))
    return (*refs, out)


def _check(outputs, key):
    ref, exact, out = (getattr(o, key) for o in outputs)
    assert out.dtype == torch.float32
    assert max_rel_err(ref, out) <= RTOL
    assert max_rel_err(exact, out) <= 3 * max_rel_err(exact, ref) + 1e-3


@pytest.fixture(scope="module")
def train_branch(setup):
    return _outputs(*setup, False)


@pytest.fixture(scope="module")
def inference_branch(setup):
    return _outputs(*setup, True)


@pytest.mark.parametrize("key", ["can_xyz", "rot_mat", "coord_xyz_rel_normed"])
def test_train_branch_outputs_bf16(train_branch, key):
    _check(train_branch, key)


@pytest.mark.parametrize("key", ["xyz", "uv"])
def test_inference_branch_outputs_bf16(inference_branch, key):
    _check(inference_branch, key)


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
