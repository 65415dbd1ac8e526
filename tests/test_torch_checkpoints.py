"""Port parity: checkpoints, filtered resume and finetune, fake batches.

The same small Hand3DPosePriorNetwork (crop 32, 21 scoremap channels) in
both packages, its weights carried across (``flax_weights`` into the
port by ``convert.load_flax_variables``).  The JAX package writes its
checkpoint with its ``save_checkpoint`` (orbax), the port with its own
(``variables.npz`` and ``train_state.pt``).  Each resumes into (a) the
same architecture with other weights and (b) one whose stem differs
(24 input channels against 21).  The finetune flag, the epoch, the best
MPJPE and the set of params taken from the checkpoint are equal, and so
are the merged params and the batch statistics (restored only on the
exact match), exported to flax paths, bit for bit.  Then ``fake_sample_batch``
against the JAX function on one seed: every key exact but the rotation
(``axis_angle_rot_mat`` in float32 in each package, to 1e-6).
"""

import os
import shutil

import numpy as np
import pytest

from handpose_tpu.data.synthetic import fake_sample_batch as jfake
from handpose_tpu.train.checkpoints import filtered_resume as jresume
from handpose_tpu.train.checkpoints import save_checkpoint as jsave
from handpose_tpu_torch.convert import export_flax_variables
from handpose_tpu_torch.data.synthetic import fake_sample_batch
from handpose_tpu_torch.train.checkpoints import (filtered_resume,
                                                  save_checkpoint)

from _torch_port import (flax_weights, jax_train_state, jax_variables,
                         torch_train_state, train_cfgs)
from _torch_port import port_worker_niced  # noqa: F401

CROP, SPE = 32, 5


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """The same weights, checkpointed by each package (epoch 3, best
    12.5, model_best too)."""
    flat = flax_weights(CROP, 21, seed=1)
    jcfg, cfg = train_cfgs(CROP, compute_dtype="float32")
    jdir = str(tmp_path_factory.mktemp("jax_run"))
    pdir = str(tmp_path_factory.mktemp("port_run"))
    _, jstate = jax_train_state(flat, jcfg, SPE)
    jsave(jdir, jstate, epoch=3, best_mpjpe=12.5, is_best=True)
    _, state = torch_train_state(flat, cfg, SPE)
    save_checkpoint(pdir, state, 3, 12.5, is_best=True)
    yield flat, jdir, pdir
    for d in (jdir, pdir):         # ~0.5 GB of checkpoints
        shutil.rmtree(d, ignore_errors=True)


def _params(flat: dict) -> dict:
    return {k: v for k, v in flat.items() if k.startswith("params/")}


@pytest.mark.parametrize("channels", [21, 24],
                         ids=["same_architecture", "other_stem"])
def test_filtered_resume_matches_jax(written, channels):
    flat, jdir, pdir = written
    assert sorted(os.listdir(os.path.join(pdir, "model_best"))) == \
        ["train_state.pt", "variables.npz"]
    target = flax_weights(CROP, channels, seed=2)
    jcfg, cfg = train_cfgs(CROP, compute_dtype="float32")
    jcfg = jcfg.replace(input_channels=channels)
    cfg = cfg.replace(input_channels=channels)

    _, jstate = jax_train_state(target, jcfg, SPE)
    jstate, jepoch, jbest, jfinetune = jresume(
        jstate, os.path.join(jdir, "checkpoint"))
    model, state = torch_train_state(target, cfg, SPE)
    state, epoch, best, finetune = filtered_resume(
        state, os.path.join(pdir, "checkpoint"))

    assert (finetune, epoch, best) == (jfinetune, jepoch, jbest)
    assert finetune == (channels != 21)
    want = jax_variables(jstate)
    got = export_flax_variables(model)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        np.testing.assert_array_equal(got[path], w, err_msg=path)

    def loaded(merged):
        return {k for k, v in _params(merged).items()
                if k in flat and np.array_equal(v, flat[k])
                and not np.array_equal(v, target[k])}

    assert loaded(got) == loaded(want)
    # the other stem drops exactly the two stem convolutions
    assert len(_params(flat)) - len(loaded(got)) == (2 if finetune else 0)


def test_fake_sample_batch_matches_jax():
    ref = jfake(3, 16, 21, seed=9)
    out = fake_sample_batch(3, 16, 21, seed=9)
    assert set(out) == set(ref)
    for k, v in ref.items():
        a, b = np.asarray(v), out[k].numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if k == "rot_mat":
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)
