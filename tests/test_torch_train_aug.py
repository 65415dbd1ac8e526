"""Port parity: the fused train step with all six augmentations on.

Both packages start from the same flax variables at crop 64 on a raw
80x80 batch of 4 from a numpy seed, float32, ``grad_accum=1``.  The JAX
side is the gradient closure its ``make_fused_train_step`` runs,
``_make_fused_grad_one`` with ``aug_flags`` (compiled once for all the
new test files), on a step key; the port's ``make_fused_train_step``
takes the draws that closure makes from that key, recomputed as it makes
them (``aug_rng, _ = split(key)``, then ``_torch_port.jax_draws``) and
injected as ``AugmentDraws``:

* losses: rtol 1e-5;
* the gradient tree, path by path: each leaf to 1e-4 of the largest
  gradient magnitude in the tree (the limits of
  tests/test_torch_train_step.py).

Then, port only: under ``grad_accum=2`` each microbatch takes its own
draws, from the generator in order, or cut from the injected ones.
"""

import jax
import numpy as np
import pytest
import torch

from handpose_tpu.data.preprocess import preprocess_batch as jpreprocess
from handpose_tpu.train.steps import _make_fused_grad_one as jgrad_one
from handpose_tpu_torch.convert import export_flax_variables, flatten_variables
from handpose_tpu_torch.data.preprocess import preprocess_batch
from handpose_tpu_torch.train.state import create_train_state
from handpose_tpu_torch.train.steps import (_accum_grads,
                                            _make_fused_grad_one,
                                            make_fused_train_step)

from _torch_port import (AUG_FLAGS, flax_weights, jax_draws, jax_raw,
                         jax_train_state, pp_kwargs, seeded_raw, torch_raw,
                         torch_train_state, train_cfgs)
from _torch_port import port_worker_niced  # noqa: F401

CROP, RAW, B, SPE = 64, 80, 4, 2
KW = dict(compute_dtype="float32", max_epoch=3)
FLAGS = {f: True for f in AUG_FLAGS}


@pytest.fixture(scope="module")
def setup():
    flat = flax_weights(CROP, seed=6)
    raw = seeded_raw(B, RAW, seed=41)
    key = jax.random.PRNGKey(13)
    aug_key, _ = jax.random.split(key)
    draws = jax_draws(aug_key, B, (RAW, RAW), (CROP, CROP))
    return flat, raw, key, draws


def test_augmented_fused_step_matches_jax(setup):
    flat, raw, key, draws = setup
    jcfg, cfg = train_cfgs(CROP, **KW)
    jmodel, jstate = jax_train_state(flat, jcfg, SPE)
    fn = jax.jit(jgrad_one(jmodel, jcfg, jpreprocess, pp_kwargs(CROP),
                           FLAGS))
    jgrads, _, jlosses = fn(jstate.params, jstate.batch_stats, jax_raw(raw),
                            key)
    jgrads = flatten_variables({"params": jgrads})

    model, state = torch_train_state(flat, cfg, SPE)
    step = make_fused_train_step(model, cfg, preprocess_batch,
                                 pp_kwargs(CROP), FLAGS)
    state, losses = step(state, torch_raw(raw), draws=draws)
    assert state.step == 1
    for k in ("loss", "loss_xyz", "loss_rot"):
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]),
                                   rtol=1e-5)
    grads = export_flax_variables(model, grads=True)
    assert sorted(grads) == sorted(jgrads)
    scale = max(np.abs(v).max() for v in jgrads.values())
    for path, want in jgrads.items():
        err = np.abs(grads[path] - want).max() / scale
        assert err <= 1e-4, (path, err)

    # the augmentations moved the step: the same raw batch unaugmented
    # gives other losses
    model, state = torch_train_state(flat, cfg, SPE)
    plain = make_fused_train_step(model, cfg, preprocess_batch,
                                  pp_kwargs(CROP))
    _, plain_losses = plain(state, torch_raw(raw))
    assert float(plain_losses["loss"]) != float(losses["loss"])


def test_grad_accum_generator_draws_per_microbatch():
    """grad_accum=2 with a generator: each microbatch draws its own, in
    order; the step equals the two half batches' gradients through one
    generator, averaged."""
    flat = flax_weights(32, seed=7)
    _, cfg = train_cfgs(32, **KW)
    raw = seeded_raw(B, 40, seed=42)
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in raw.items()}
              for i in range(2)]

    model, state = torch_train_state(flat, cfg.replace(grad_accum=2), SPE)
    step = make_fused_train_step(model, cfg.replace(grad_accum=2),
                                 preprocess_batch, pp_kwargs(32), FLAGS)
    _, losses = step(state, torch_raw(raw),
                     generator=torch.Generator().manual_seed(4))
    got = export_flax_variables(model, grads=True)
    with pytest.raises(ValueError, match="need draws or a generator"):
        step(state, torch_raw(raw))

    model, _ = torch_train_state(flat, cfg, SPE)
    grad_one = _make_fused_grad_one(model, cfg, preprocess_batch,
                                    pp_kwargs(32), FLAGS)
    gen = torch.Generator().manual_seed(4)
    parts = [grad_one(torch_raw(h), None, gen) for h in halves]
    np.testing.assert_allclose(
        float(losses["loss"]), np.mean([float(p["loss"]) for p in parts]),
        rtol=1e-6)
    for path, g in export_flax_variables(model, grads=True).items():
        np.testing.assert_array_equal(got[path], g / 2, err_msg=path)


def test_grad_accum_cuts_injected_draws_with_the_batch():
    """Injected whole-batch draws are cut along the batch axis with the
    raw batch, one slice per microbatch."""
    seen = []

    def grad_one(data, draws, model_draws):
        assert model_draws is None
        seen.append((data, draws))
        return {"loss": torch.zeros(())}

    state = create_train_state(torch.nn.Linear(2, 2), train_cfgs(32)[1])
    raw = torch_raw(seeded_raw(B, 8, seed=1))
    draws = jax_draws(jax.random.PRNGKey(0), B, (8, 8), (4, 4))
    _accum_grads(grad_one, state, raw, 2, draws)
    assert len(seen) == 2
    for i, (data, dr) in enumerate(seen):
        assert torch.equal(data.image, raw.image[2 * i:2 * i + 2])
        for a, b in zip(dr, draws):
            assert torch.equal(a, b[2 * i:2 * i + 2])
