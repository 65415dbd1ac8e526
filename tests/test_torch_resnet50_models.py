"""Port parity: the ResNet-50 models at full depth and width, float32.

``TwoDimHandPose``, ``OnlyThreeDimHandPose`` and ``Hand3DPoseNet`` (both
branches) at crop 64, 3 input channels, ``resnet_out_feature_dim``
1024, batch 2, eval mode.  The JAX model's variables (its traced
``init``, refilled from a seed) are carried across with
``convert.load_flax_variables``; one jitted JAX program per model
(``Hand3DPoseNet``'s computes both branches).  Tolerance: max
|torch - jax| <= 1e-4 of the output's range, as
``test_torch_model_f32.py``.  The converter's round trip is the identity
on each model, and each model builds with each of the three stems.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handpose_tpu.config import Config as JConfig
from handpose_tpu.models import build_model as jbuild
from handpose_tpu_torch.config import Config
from handpose_tpu_torch.convert import (export_flax_variables,
                                        load_flax_variables)
from handpose_tpu_torch.models import build_model

from _torch_port import flax_weights, max_rel_err, unflatten
from _torch_port import port_worker_niced  # noqa: F401

CROP, CH, B = 64, 3, 2
RTOL = 1e-4
MODELS = ("TwoDimHandPose", "OnlyThreeDimHandPose", "Hand3DPoseNet")
# (model, is_inference, output key) of every output held to JAX
OUTPUTS = [("TwoDimHandPose", False, "uv"),
           ("OnlyThreeDimHandPose", False, "xyz"),
           ("OnlyThreeDimHandPose", False, "uv"),
           ("Hand3DPoseNet", False, "can_xyz"),
           ("Hand3DPoseNet", False, "rot_mat"),
           ("Hand3DPoseNet", False, "coord_xyz_rel_normed"),
           ("Hand3DPoseNet", True, "xyz"),
           ("Hand3DPoseNet", True, "uv")]


def _cfgs(model):
    kw = dict(model_name=model, input_channels=CH,
              input_img_shape=(CROP, CROP), compute_dtype="float32")
    return JConfig(**kw), Config(**kw)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return (rng.uniform(0, 1, (B, CROP, CROP, CH)).astype(np.float32),
            np.tile(np.asarray([[200., 0, 32], [0, 200., 32], [0, 0, 1]],
                               np.float32), (B, 1, 1)),
            rng.uniform(0.01, 0.02, (B, 1)).astype(np.float32),
            (rng.normal(0, 0.1, (B, 3)) + [0, 0, 0.6]).astype(np.float32))


@pytest.fixture(scope="module")
def weights():
    return {m: flax_weights(CROP, CH, seed=i, model=m)
            for i, m in enumerate(MODELS)}


@pytest.fixture(scope="module")
def outputs(inputs, weights):
    """{(model, is_inference): (JAX output, port output)}."""
    res = {}
    for model in MODELS:
        jcfg, cfg = _cfgs(model)
        branches = (False, True) if model == "Hand3DPoseNet" else (False,)
        jms = [jbuild(jcfg, is_inference=b) for b in branches]

        @jax.jit
        def run(variables, *args, jms=jms):
            return [m.apply(variables, *args) for m in jms]

        refs = run(unflatten(weights[model]), *map(jnp.asarray, inputs))
        for branch, ref in zip(branches, refs):
            port = load_flax_variables(build_model(cfg, branch),
                                       weights[model])
            with torch.no_grad():
                out = port(*(torch.from_numpy(a) for a in inputs))
            res[(model, branch)] = (ref, out)
    return res


@pytest.mark.parametrize("model,branch,key", OUTPUTS)
def test_eval_outputs_match_jax(outputs, model, branch, key):
    ref, out = outputs[(model, branch)]
    got = getattr(out, key)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == tuple(getattr(ref, key).shape)
    assert max_rel_err(getattr(ref, key), got) <= RTOL


def test_outputs_the_jax_models_leave_empty(outputs):
    """The fields each model sets and leaves None, as in the JAX zoo;
    ``TwoDimHandPose`` and ``Hand3DPoseNet``'s inference branch return
    a zero ``diffusion_loss``."""
    for (model, branch), (ref, out) in outputs.items():
        for field in ("xyz", "uv", "diffusion_loss", "can_xyz", "rot_mat",
                      "coord_xyz_rel_normed"):
            assert (getattr(out, field) is None) \
                == (getattr(ref, field) is None), (model, branch, field)
        if out.diffusion_loss is not None:
            assert float(out.diffusion_loss) == 0.0


@pytest.mark.parametrize("model", MODELS)
def test_convert_round_trip_is_the_identity(weights, model):
    _, cfg = _cfgs(model)
    flat = weights[model]
    port = load_flax_variables(build_model(cfg), flat)
    assert len(port.state_dict()) == len(flat)
    back = export_flax_variables(port)
    assert sorted(back) == sorted(flat)
    for path, v in flat.items():
        np.testing.assert_array_equal(back[path], v)
    with pytest.raises(KeyError, match="no flax variable"):
        load_flax_variables(port, {k: v for k, v in flat.items()
                                   if not k.endswith("fc_proj/kernel")})


@pytest.mark.parametrize("stem", ["k3s2", "k3s2_s2d", "k7s2"])
def test_every_model_builds_with_every_stem(stem):
    """The three ResNet-50 models and the flagship's two ResNet-18 trunks
    take each stem; the stem's kernel is (F, C, 7, 7) for k7s2 and the
    k3s2 kernel's (F, C, 3, 3) for both others."""
    k = 7 if stem == "k7s2" else 3
    for model in MODELS + ("Hand3DPosePriorNetwork",):
        channels = 21 if model == "Hand3DPosePriorNetwork" else CH
        cfg = Config(model_name=model, input_channels=channels,
                     input_img_shape=(32, 32), resnet_stem=stem)
        sd = build_model(cfg).state_dict()
        stems = [v for name, v in sd.items()
                 if name.endswith("conv_init.weight")]
        assert stems and all(tuple(w.shape) == (64, channels, k, k)
                             for w in stems), model
