"""Port parity: the fused train step of Hand3DPosePriorNetwork, float32.

Both packages start from the same flax variables (``flax_weights``,
moved into the port by ``convert.load_flax_variables``) at crop 64 on
raw 80x80 batches of 4 from a numpy seed, float32 compute, the default
``bn_variance='fast'``, and the repo's Adam + per-epoch cosine LR with
two steps per epoch (so three steps cross an epoch boundary).  Against
the JAX package's ``_make_fused_grad_one`` and ``make_fused_train_step``
(each compiled once for the file):

* losses of one fused step: rtol 1e-5;
* the gradient tree, path by path (``export_flax_variables(grads=True)``):
  each leaf to 1e-4 of the largest gradient magnitude in the tree;
* a 3-step trajectory (three raw batches): losses rtol 1e-4 at every
  step; after the last step every ``params`` and ``batch_stats`` leaf
  to 1e-2 of its range, and 99% of all their elements to 1e-4 of their
  leaf's range (``_torch_port.assert_trajectory_close``: Adam divides
  each gradient element by its own magnitude, so an element whose
  gradient sits at float32 noise level steps by up to +-lr in either
  package whatever its sign; seen: up to 2.5 lr on 0.3% of a kernel's
  elements).
"""

import jax
import numpy as np
import pytest

from handpose_tpu.data.preprocess import preprocess_batch as jpreprocess
from handpose_tpu.train.steps import _make_fused_grad_one as jgrad_one
from handpose_tpu.train.steps import make_fused_train_step as jmake_step
from handpose_tpu_torch.convert import export_flax_variables, flatten_variables
from handpose_tpu_torch.data.preprocess import preprocess_batch
from handpose_tpu_torch.train.steps import (_make_fused_grad_one,
                                            make_fused_train_step)

from _torch_port import (assert_trajectory_close, flax_weights, jax_raw,
                         jax_train_state, jax_variables, max_rel_err,
                         pp_kwargs, seeded_raw, torch_raw, torch_train_state,
                         train_cfgs)

CROP, RAW, B, SPE, STEPS = 64, 80, 4, 2, 3
KW = dict(compute_dtype="float32", max_epoch=3)


@pytest.fixture(scope="module")
def setup():
    flat = flax_weights(CROP, seed=2)
    raws = [seeded_raw(B, RAW, seed=20 + i) for i in range(STEPS)]
    return flat, raws


@pytest.fixture(scope="module")
def jax_grads(setup):
    flat, raws = setup
    jcfg, _ = train_cfgs(CROP, **KW)
    model, state = jax_train_state(flat, jcfg, SPE)
    fn = jax.jit(jgrad_one(model, jcfg, jpreprocess, pp_kwargs(CROP)))
    grads, new_bs, losses = fn(state.params, state.batch_stats,
                               jax_raw(raws[0]), jax.random.PRNGKey(0))
    return (flatten_variables({"params": grads}),
            flatten_variables({"batch_stats": new_bs}), losses)


@pytest.fixture(scope="module")
def jax_trajectory(setup):
    flat, raws = setup
    jcfg, _ = train_cfgs(CROP, **KW)
    model, state = jax_train_state(flat, jcfg, SPE)
    step = jmake_step(model, jcfg, jpreprocess, pp_kwargs(CROP))
    losses = []
    for raw in raws:
        state, m = step(state, jax_raw(raw), jax.random.PRNGKey(0))
        losses.append({k: float(v) for k, v in m.items()})
    return losses, jax_variables(state)


def test_fused_step_losses_and_gradient_tree(setup, jax_grads):
    flat, raws = setup
    jgrads, jbs, jlosses = jax_grads
    _, cfg = train_cfgs(CROP, **KW)
    model, state = torch_train_state(flat, cfg, SPE)
    grad_one = _make_fused_grad_one(model, cfg, preprocess_batch,
                                    pp_kwargs(CROP))
    losses = grad_one(torch_raw(raws[0]))
    for k in ("loss", "loss_xyz", "loss_rot"):
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]),
                                   rtol=1e-5)
    grads = export_flax_variables(model, grads=True)
    assert sorted(grads) == sorted(jgrads)
    scale = max(np.abs(v).max() for v in jgrads.values())
    for path, want in jgrads.items():
        err = np.abs(grads[path] - want).max() / scale
        assert err <= 1e-4, (path, err)
    # the batch statistics that forward leaves behind
    stats = {k: v for k, v in export_flax_variables(model).items()
             if k.startswith("batch_stats/")}
    for path, want in jbs.items():
        assert max_rel_err(want, stats[path]) <= 1e-5, path


def test_fused_step_three_step_trajectory(setup, jax_trajectory):
    flat, raws = setup
    jlosses, jvars = jax_trajectory
    _, cfg = train_cfgs(CROP, **KW)
    model, state = torch_train_state(flat, cfg, SPE)
    step = make_fused_train_step(model, cfg, preprocess_batch,
                                 pp_kwargs(CROP))
    for raw, want in zip(raws, jlosses):
        state, losses = step(state, torch_raw(raw))
        for k, v in want.items():
            np.testing.assert_allclose(float(losses[k]), v, rtol=1e-4)
    assert state.step == STEPS
    assert state.schedule(state.step - 1) < cfg.lr    # epoch 1's rate
    assert_trajectory_close(jvars, export_flax_variables(model))


def test_remat_waits_for_queue_9():
    _, cfg = train_cfgs(CROP, remat=True)
    model, _ = torch_train_state(flax_weights(32), cfg.replace(
        input_img_shape=(32, 32)), SPE)
    with pytest.raises(NotImplementedError, match="queue 9"):
        make_fused_train_step(model, cfg, preprocess_batch, pp_kwargs(32))


def test_train_step_on_a_preprocessed_batch_equals_the_fused_one():
    """make_train_step on preprocess_batch's output == the fused step on
    the raw batch (the JAX repo's fused-vs-separate check): losses and
    every variable exactly, on the host."""
    from handpose_tpu_torch.train.steps import make_train_step
    flat = flax_weights(32, seed=4)
    _, cfg = train_cfgs(32, compute_dtype="float32")
    raw = torch_raw(seeded_raw(B, 40, seed=5))
    outs = []
    for fused in (True, False):
        model, state = torch_train_state(flat, cfg, SPE)
        if fused:
            step = make_fused_train_step(model, cfg, preprocess_batch,
                                         pp_kwargs(32))
            state, losses = step(state, raw)
        else:
            batch = preprocess_batch(raw, **pp_kwargs(32))
            state, losses = make_train_step(model, cfg)(state, batch)
        outs.append((losses, export_flax_variables(model)))
    (lf, vf), (ls, vs) = outs
    assert {k: float(v) for k, v in lf.items()} == \
        {k: float(v) for k, v in ls.items()}
    for path, v in vf.items():
        np.testing.assert_array_equal(vs[path], v)
