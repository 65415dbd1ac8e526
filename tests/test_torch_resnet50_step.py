"""Port parity: one fused train step of OnlyThreeDimHandPose, float32.

Both packages start from the same flax variables (``flax_weights`` of
the JAX model, moved into the port by ``convert.load_flax_variables``)
at full depth and width (ResNet-50, ``resnet_out_feature_dim`` 1024),
crop 64, 3 input channels (the image crop), on a raw 80x80 batch of 4
from a numpy seed, float32 compute, ``bn_variance='fast'``.  Against the
JAX package's ``_make_fused_grad_one`` (compiled once): preprocessing,
the trainer-A xyz loss under the model's gates, and its gradient.

Sixteen Bottleneck blocks of train-mode BatchNorm over 16-row stage-4
batches make this float32 gradient ill-conditioned: JAX's own gradient
of the same batch in reverse sample order (which changes only the order
of float32 sums) moves by ~7e-2 of its largest element, mostly in the
stem and the first block, and its loss by ~2e-5 relative; the port sits
inside that (~1e-2 and ~2e-5).  So, as ``test_torch_interhand_step.py``
does, each check is ``test_torch_train_step.py``'s tolerance plus twice
that reversal's own movement, measured in the same run by the same
compiled program:

* losses: rtol 1e-5 + 2 x the reversal's relative loss change;
* the gradient tree as one vector: relative L2 distance <= 2 x the
  reversal's + 1e-4; each leaf on its own scale, its largest difference
  over its largest JAX element <= 2 x the reversal's, so measured, +
  1e-4 (a leaf with small gradients is not held to the stem's scale);
* the batch statistics the train-mode forward leaves behind: each leaf
  to 1e-5 of its range + 2 x the reversal's change of that leaf.

Then the port's Adam step from the same gradient moves every parameter.
"""

import jax
import numpy as np
import pytest

from handpose_tpu.data.preprocess import preprocess_batch as jpreprocess
from handpose_tpu.train.steps import _make_fused_grad_one as jgrad_one
from handpose_tpu_torch.convert import export_flax_variables, flatten_variables
from handpose_tpu_torch.data.preprocess import preprocess_batch
from handpose_tpu_torch.train.steps import (_make_fused_grad_one,
                                            make_fused_train_step)

from _torch_port import (flax_weights, jax_raw, jax_train_state, max_rel_err,
                         pp_kwargs, seeded_raw, torch_raw, torch_train_state,
                         train_cfgs)
from _torch_port import port_worker_niced  # noqa: F401

MODEL = "OnlyThreeDimHandPose"
CROP, RAW, B, SPE = 64, 80, 4, 2
KW = dict(model_name=MODEL, input_channels=3, compute_dtype="float32",
          max_epoch=3)


@pytest.fixture(scope="module")
def setup():
    return flax_weights(CROP, 3, seed=5, model=MODEL), seeded_raw(B, RAW, 30)


@pytest.fixture(scope="module")
def jax_grads(setup):
    """(gradients, batch statistics, losses) of JAX's step on the batch
    and, from the same program, on the batch in reverse sample order."""
    flat, raw = setup
    jcfg, _ = train_cfgs(CROP, **KW)
    model, state = jax_train_state(flat, jcfg, SPE)
    fn = jax.jit(jgrad_one(model, jcfg, jpreprocess, pp_kwargs(CROP)))
    runs = []
    for r in (raw, {k: v[::-1].copy() for k, v in raw.items()}):
        grads, new_bs, losses = fn(state.params, state.batch_stats,
                                   jax_raw(r), jax.random.PRNGKey(0))
        runs.append((flatten_variables({"params": grads}),
                     flatten_variables({"batch_stats": new_bs}),
                     {k: float(v) for k, v in losses.items()}))
    return runs


@pytest.fixture(scope="module")
def port_grads(setup):
    flat, raw = setup
    _, cfg = train_cfgs(CROP, **KW)
    model, _ = torch_train_state(flat, cfg, SPE)
    losses = _make_fused_grad_one(model, cfg, preprocess_batch,
                                  pp_kwargs(CROP))(torch_raw(raw))
    variables = export_flax_variables(model)
    return (export_flax_variables(model, grads=True),
            {k: v for k, v in variables.items()
             if k.startswith("batch_stats/")},
            {k: float(v) for k, v in losses.items()})


def test_fused_step_losses(jax_grads, port_grads):
    (_, _, want), (_, _, rev) = jax_grads
    got = port_grads[2]
    assert sorted(got) == sorted(want) == ["loss", "loss_xyz"]
    for k in want:
        drift = abs(rev[k] - want[k]) / abs(want[k])
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5 + 2 * drift)
    assert got["loss"] == got["loss_xyz"]


def test_fused_step_gradient_tree(jax_grads, port_grads):
    (jgrads, _, _), (jrev, _, _) = jax_grads
    grads = port_grads[0]
    assert sorted(grads) == sorted(jgrads)
    assert any("BottleneckBlock_15/Conv_2" in k for k in grads)
    paths = sorted(jgrads)
    want, got, rev = (np.concatenate([np.ravel(t[p]) for p in paths])
                      for t in (jgrads, grads, jrev))
    # the whole tree as one vector: |port - JAX| against |JAX reversed -
    # JAX|, both over |JAX|
    err, drift = (float(np.linalg.norm(x - want) / np.linalg.norm(want))
                  for x in (got, rev))
    assert err <= 2 * drift + 1e-4, (err, drift)
    # each leaf on its own scale, against its own reversal drift:
    # |port - JAX|_leaf <= (2 x |JAX reversed - JAX|_leaf + 1e-4) x
    # max |JAX_leaf|
    leaf = {}
    for path in paths:
        scale = np.abs(jgrads[path]).max()
        assert scale > 0, path
        e, d = (np.abs(t[path] - jgrads[path]).max() / scale
                for t in (grads, jrev))
        assert e <= 2 * d + 1e-4, (path, e, d)
        leaf[path] = (e, d)
    e, d = np.array(list(leaf.values())).T
    worst = max(leaf, key=lambda p: leaf[p][0] / (2 * leaf[p][1] + 1e-4))
    print(f"tree: port {err:.3e}, reversal {drift:.3e}; leaves: port "
          f"{e.min():.2e}..{e.max():.2e} (median {np.median(e):.2e}), "
          f"reversal {d.min():.2e}..{d.max():.2e} (median "
          f"{np.median(d):.2e}); nearest its bound: {worst}, port "
          f"{leaf[worst][0]:.2e}, reversal {leaf[worst][1]:.2e}")


def test_fused_step_batch_stats(jax_grads, port_grads):
    (_, jbs, _), (_, jrev, _) = jax_grads
    stats = port_grads[1]
    assert sorted(stats) == sorted(jbs) and len(jbs) == 2 * 53
    for path, want in jbs.items():
        drift = max_rel_err(want, jrev[path])
        assert max_rel_err(want, stats[path]) <= 1e-5 + 2 * drift, \
            (path, drift)


def test_fused_train_step_updates_every_parameter(setup):
    """The whole step (gradient, Adam with the cosine LR): the schedule
    count moves, the loss is finite and every parameter moves."""
    flat, raw = setup
    _, cfg = train_cfgs(CROP, **KW)
    model, state = torch_train_state(flat, cfg, SPE)
    step = make_fused_train_step(model, cfg, preprocess_batch,
                                 pp_kwargs(CROP))
    state, losses = step(state, torch_raw(raw))
    assert state.step == 1 and np.isfinite(float(losses["loss"]))
    after = export_flax_variables(model)
    moved = [k for k in after if k.startswith("params/")
             and not np.array_equal(after[k], flat[k])]
    assert len(moved) == sum(k.startswith("params/") for k in flat)
