"""Port parity: the Bottleneck ResNet trunk and its three stems, float32.

The JAX trunk is built directly from its classes at reduced depth and
width, ``ResNet(stage_sizes=[1, 1, 1, 1], block_cls=BottleneckBlock,
num_filters=8)`` (every block kind of ResNet-50: the stage-1 block that
projects 8 -> 32 channels at stride 1, and three stride-2 blocks), on a
crop-64 batch of 2, so stage 4 is 2x2 and its train-mode BatchNorms see
8 rows.  One jitted JAX program per stem computes the eval output, the
train output, the updated BatchNorm statistics and the parameter
gradient of ``sum(out * cot)``; the port holds:

* outputs (eval and train mode) to 1e-4 of the output's range (the
  tolerance of ``test_torch_model_f32.py``: float32 convolutions sum in
  another order);
* the BatchNorm statistics after the train-mode forward, leaf by leaf,
  to 1e-5 of the leaf's range;
* every gradient leaf to 1e-4 of the largest gradient magnitude in the
  tree (``test_torch_train_step.py``'s tolerance).

``k3s2_s2d`` is the same function as ``k3s2`` (``tests/test_resnet_convert.py``
holds JAX to that), so the port builds both as the one k3 s2 p1 conv:
its ``k3s2_s2d`` trunk is held above against JAX's real space-to-depth
stem, and the port's two stems with the same weights agree to 1e-5 of
range.  The full-size ResNet-50 variable tree (traced, not compiled)
names exactly the port's tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handpose_tpu.nn import resnet as jresnet
from handpose_tpu_torch.convert import (export_flax_variables,
                                        flatten_variables,
                                        load_flax_variables)
from handpose_tpu_torch.nn import resnet

from _torch_port import max_rel_err, seeded_variables, unflatten
from _torch_port import port_worker_niced  # noqa: F401

CROP, CH, B, FILTERS, CLASSES = 64, 3, 2, 8, 10
STEMS = ("k3s2", "k3s2_s2d", "k7s2")
RTOL = 1e-4


def _jax_trunk(stem):
    return jresnet.ResNet(stage_sizes=[1, 1, 1, 1],
                          block_cls=jresnet.BottleneckBlock,
                          num_classes=CLASSES, num_filters=FILTERS,
                          stem=stem, bn_variance="fast")


def _port_trunk(stem, flat):
    model = resnet.ResNet(CH, [1, 1, 1, 1], resnet.BottleneckBlock,
                          num_classes=CLASSES, num_filters=FILTERS,
                          stem=stem, bn_variance="fast")
    return load_flax_variables(model, flat)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (B, CROP, CROP, CH)).astype(np.float32)
    cot = rng.normal(size=(B, CLASSES)).astype(np.float32)
    return x, cot


@pytest.fixture(scope="module")
def jax_runs(inputs):
    """Per stem: (flat variables, eval out, train out, batch_stats after
    the train forward, gradient tree), one JAX program each."""
    x, cot = inputs
    runs = {}
    for i, stem in enumerate(STEMS):
        m = _jax_trunk(stem)
        flat = seeded_variables(jax.eval_shape(
            m.init, jax.random.PRNGKey(0), jnp.zeros((1, CROP, CROP, CH))),
            seed=10 + i)

        @jax.jit
        def run(variables, x, cot, m=m):
            eval_out = m.apply(variables, x, train=False)

            def loss(params):
                out, upd = m.apply({"params": params,
                                    "batch_stats": variables["batch_stats"]},
                                   x, train=True, mutable=["batch_stats"])
                return (out * cot).sum(), (out, upd["batch_stats"])

            (_, (out, bs)), grads = jax.value_and_grad(
                loss, has_aux=True)(variables["params"])
            return eval_out, out, bs, grads

        eval_out, out, bs, grads = run(unflatten(flat), jnp.asarray(x),
                                       jnp.asarray(cot))
        runs[stem] = (flat, np.asarray(eval_out), np.asarray(out),
                      flatten_variables({"batch_stats": bs}),
                      flatten_variables({"params": grads}))
    return runs


@pytest.fixture(scope="module")
def port_runs(inputs, jax_runs):
    """Per stem: (eval out, train out, exported variables, gradients)."""
    x, cot = inputs
    runs = {}
    for stem in STEMS:
        model = _port_trunk(stem, jax_runs[stem][0])
        with torch.no_grad():
            eval_out = model.eval()(_nchw(x))
        out = model.train()(_nchw(x))
        (out * torch.from_numpy(cot)).sum().backward()
        runs[stem] = (eval_out.numpy(), out.detach().numpy(),
                      export_flax_variables(model),
                      export_flax_variables(model, grads=True))
    return runs


@pytest.mark.parametrize("stem", STEMS)
def test_trunk_outputs_match_jax(jax_runs, port_runs, stem):
    _, j_eval, j_train, _, _ = jax_runs[stem]
    p_eval, p_train, _, _ = port_runs[stem]
    assert p_eval.shape == (B, CLASSES) and p_eval.dtype == np.float32
    assert max_rel_err(j_eval, p_eval) <= RTOL
    assert max_rel_err(j_train, p_train) <= RTOL


@pytest.mark.parametrize("stem", STEMS)
def test_trunk_train_batch_stats_match_jax(jax_runs, port_runs, stem):
    jbs = jax_runs[stem][3]
    variables = port_runs[stem][2]
    # 17 BatchNorms: the stem's, three a block and each block's projection
    assert len(jbs) == 2 * 17
    for path, want in jbs.items():
        assert max_rel_err(want, variables[path]) <= 1e-5, path


@pytest.mark.parametrize("stem", STEMS)
def test_trunk_train_gradients_match_jax(jax_runs, port_runs, stem):
    jgrads = jax_runs[stem][4]
    grads = port_runs[stem][3]
    assert sorted(grads) == sorted(jgrads)
    scale = max(np.abs(v).max() for v in jgrads.values())
    for path, want in jgrads.items():
        err = np.abs(grads[path] - want).max() / scale
        assert err <= 1e-4, (path, err)


def test_s2d_stem_equals_k3s2_stem(inputs, jax_runs):
    """The same weights through the port's two stems: eval and train
    outputs and every gradient to 1e-5 of range."""
    x, cot = inputs
    flat = jax_runs["k3s2"][0]
    res = []
    for stem in ("k3s2", "k3s2_s2d"):
        model = _port_trunk(stem, flat)
        with torch.no_grad():
            eval_out = model.eval()(_nchw(x))
        out = model.train()(_nchw(x))
        (out * torch.from_numpy(cot)).sum().backward()
        res.append((eval_out, out.detach(),
                    export_flax_variables(model, grads=True)))
    (e0, t0, g0), (e1, t1, g1) = res
    assert max_rel_err(e0, e1) <= 1e-5
    assert max_rel_err(t0, t1) <= 1e-5
    scale = max(np.abs(v).max() for v in g0.values())
    for path, want in g0.items():
        assert np.abs(g1[path] - want).max() / scale <= 1e-5, path


def test_make_stem_builds_each_stem():
    """``conv_init`` of each stem: ``k3s2`` and ``k3s2_s2d`` one 3x3
    stride-2 conv with padding 1 and an (F, C, 3, 3) weight, ``k7s2`` a
    7x7 stride-2 conv with padding 3; any other name is refused."""
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, CH, 10, 12)).astype(np.float32))
    shapes = {}
    for stem, k, pad in (("k3s2", 3, 1), ("k3s2_s2d", 3, 1), ("k7s2", 7, 3)):
        conv = resnet.make_stem(stem, CH, FILTERS, torch.float32)
        assert conv.weight.shape == (FILTERS, CH, k, k)
        want = torch.nn.functional.conv2d(x, conv.weight, stride=2,
                                          padding=pad)
        got = conv(x)
        shapes[stem] = tuple(got.shape)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert set(shapes.values()) == {(2, FILTERS, 5, 6)}
    with pytest.raises(ValueError, match="resnet_stem"):
        resnet.make_stem("k5s2", 3, 8, torch.float32)


def test_resnet50_tree_names_the_port_tensors():
    """The full ResNet-50 trunk (stages [3, 4, 6, 3] of BottleneckBlocks)
    and ``ExtendedResNet50``: the JAX variable tree (traced) names exactly
    the port's tensors, with the same shapes in flax layout; the first
    block projects 64 -> 256 channels at stride 1, the second does not."""
    m = jresnet.ExtendedResNet50(stem="k3s2_s2d")
    shapes = jax.eval_shape(m.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, CH)))
    flat = seeded_variables(shapes, seed=3)
    model = load_flax_variables(
        resnet.ExtendedResNet50(CH, stem="k3s2_s2d"), flat)
    back = export_flax_variables(model)
    assert sorted(back) == sorted(flat)
    assert all(np.array_equal(back[k], flat[k]) for k in flat)
    blocks = [k for k in flat if k.startswith("params/trunk/Bottleneck")
              and k.endswith("Conv_2/kernel")]
    assert len(blocks) == 16
    assert flat["params/trunk/conv_init/kernel"].shape == (3, 3, CH, 64)
    assert flat["params/trunk/BottleneckBlock_0/conv_proj/kernel"].shape \
        == (1, 1, 64, 256)
    assert "params/trunk/BottleneckBlock_1/conv_proj/kernel" not in flat
    assert flat["params/trunk/fc/kernel"].shape == (2048, 1000)


def test_feature_extractor_projects_in_float32():
    """In bf16 the trunk (and its 1000-d fc) runs in bf16; ``fc_proj``
    is a flax Dense without a dtype, so it runs in float32 on the
    trunk's float32 output."""
    torch.manual_seed(0)
    ext = resnet.ResNetFeatureExtractor(CH, 32, dtype=torch.bfloat16)
    assert ext.trunk.fc.dtype == torch.bfloat16
    assert ext.fc_proj.dtype == torch.float32
    x = _nchw(np.random.default_rng(2).uniform(
        0, 1, (2, 32, 32, CH)).astype(np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        feat = ext(x)
        trunk = ext.trunk(x)
    assert trunk.dtype == torch.float32 and feat.dtype == torch.float32
    want = torch.nn.functional.linear(trunk, ext.fc_proj.weight) \
        + ext.fc_proj.bias
    torch.testing.assert_close(feat, want, rtol=0, atol=0)
