"""Port parity: the LR schedule, Adam, and the weight export.

* ``cosine_epoch_schedule`` against the JAX schedule at every step of
  three epochs (both in float32): rtol 1e-6.
* The port's Adam (``make_optimizer`` + ``TrainState.apply_gradients``)
  against ``optax.adam(cosine_epoch_schedule(...))`` over five updates
  that cross two epoch boundaries, with the same numpy gradients: the
  parameters after every update to 1e-6 of their range (the same
  bias-corrected update, rounded differently in float32).
* ``export_flax_variables(load_flax_variables(model, flat))`` gives back
  the flagship's whole flattened tree exactly.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from handpose_tpu.train.state import cosine_epoch_schedule as jschedule
from handpose_tpu_torch.config import Config
from handpose_tpu_torch.convert import (export_flax_variables,
                                        load_flax_variables)
from handpose_tpu_torch.models import build_model
from handpose_tpu_torch.train.state import (TrainState,
                                            cosine_epoch_schedule,
                                            make_optimizer)

from _torch_port import MODEL, flax_weights, max_rel_err
from _torch_port import port_worker_niced  # noqa: F401

LR, ETA_MIN, EPOCHS, SPE = 1e-3, 1e-5, 3, 2


def test_cosine_epoch_schedule_matches_jax():
    ours = cosine_epoch_schedule(LR, ETA_MIN, EPOCHS, SPE)
    theirs = jschedule(LR, ETA_MIN, EPOCHS, SPE)
    for step in range(EPOCHS * SPE + 3):
        np.testing.assert_allclose(ours(step), float(theirs(step)),
                                   rtol=1e-6)
    assert ours(0) == pytest.approx(LR) and ours(99) == pytest.approx(ETA_MIN)


def test_adam_with_schedule_matches_optax():
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,), (2, 3, 3)]
    init = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(5)]

    tx = optax.adam(jschedule(LR, ETA_MIN, EPOCHS, SPE))
    jp = [jnp.asarray(a) for a in init]
    opt_state = tx.init(jp)

    params = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    opt, schedule = make_optimizer(params, LR, ETA_MIN, EPOCHS, SPE)
    state = TrainState(torch.nn.ParameterList(params), opt, schedule)

    for g in grads:
        updates, opt_state = tx.update([jnp.asarray(a) for a in g],
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, a in zip(params, g):
            p.grad = torch.from_numpy(a)
        state = state.apply_gradients()
        for want, got in zip(jp, params):
            assert max_rel_err(want, got.detach().numpy()) <= 1e-6
    assert state.step == 5


def test_export_is_the_inverse_of_load_for_the_full_tree():
    flat = flax_weights(64)
    cfg = Config(model_name=MODEL, input_channels=21,
                 input_img_shape=(64, 64))
    model = load_flax_variables(build_model(cfg), flat)
    out = export_flax_variables(model)
    assert sorted(out) == sorted(flat)
    for k, v in flat.items():
        assert out[k].shape == v.shape and out[k].dtype == np.float32
        np.testing.assert_array_equal(out[k], v)
    with pytest.raises(ValueError, match="no gradient"):
        export_flax_variables(model, grads=True)
