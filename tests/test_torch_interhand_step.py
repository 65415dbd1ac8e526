"""Port parity on the InterHand2.6M training path, float32, on the host.

A tree from the JAX package's ``write_synthetic_interhand`` (64x40 and
40x64 JPEG frames padded to 64x64), crop 64, batch 4:

* one fused train step's gradient closure on a raw InterHand batch,
  against the JAX package's ``_make_fused_grad_one`` with its
  ``preprocess_interhand_batch`` (compiled once for the file): losses
  rtol 1e-4.  The gradient is held to ``test_torch_train_step.py``'s
  1e-4 of the largest gradient magnitude plus twice a yardstick of
  float32 rounding: JAX's own gradient of the same batch in reverse
  sample order, which changes only the order of float32 sums.  On these
  crops, whose 84 scoremaps are mostly empty, the reversal alone moves
  JAX's gradient by ~1e-3 of its norm and ~2e-3 of its largest element,
  as far as the port is from it (measured: 1.1e-3 and 1.9e-3); on the
  RHD batches of ``test_torch_train_step.py`` the port stays within 1e-4.
  So: the whole tree's relative L2 distance <= 2 x the reversal's +
  1e-4, and each leaf's largest difference <= 2 x the reversal's
  largest + 1e-4 of the largest gradient.  The batch statistics forward
  leaves behind to 1e-5 of their range; the port's step picks the
  InterHand preprocessing from the raw batch's type;
* the port's ``Worker`` trains an InterHand epoch (both augmentations,
  then through the decoded cache), its validation MPJPE equal to the
  ``Evaluator``'s on ``model_best`` exactly, and the train CLI runs
  ``--dataset InterHand2.6M``.
"""

import os
import shutil
import signal

import jax
import numpy as np
import pytest

from handpose_tpu.data import interhand as jih
from handpose_tpu.data.preprocess import \
    preprocess_interhand_batch as jpreprocess
from handpose_tpu.train.steps import _make_fused_grad_one as jgrad_one
from handpose_tpu_torch.convert import export_flax_variables, flatten_variables
from handpose_tpu_torch.data.interhand import InterHandDataset
from handpose_tpu_torch.infer import Evaluator
from handpose_tpu_torch.train import Worker
from handpose_tpu_torch.train.steps import _make_fused_grad_one

from _torch_port import (MODEL, flax_weights, interhand_raws,
                         jax_train_state, max_rel_err, pp_kwargs,
                         torch_train_state, train_cfgs)
from _torch_port import port_worker_niced  # noqa: F401

SIZES = [(64, 40), (40, 64)]
CROP, B, N = 64, 4, 8


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    pytest.importorskip("cv2")
    root = str(tmp_path_factory.mktemp("ih"))
    jih.write_synthetic_interhand(root, "train", n=N, seed=1,
                                  image_sizes=SIZES)
    jih.write_synthetic_interhand(root, "val", n=6, seed=2,
                                  image_sizes=SIZES)
    return root


@pytest.fixture
def logs(tmp_path):
    """A log directory, removed after the test (each epoch's end writes a
    ~300 MB checkpoint)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_fused_interhand_step_matches_jax(tree):
    flat = flax_weights(CROP, seed=4)
    raw = InterHandDataset(tree, "train", pad_to="auto").raw_batch(
        [1, 2, 5, 6])
    jraw, traw = interhand_raws(raw)
    jcfg, cfg = train_cfgs(CROP, compute_dtype="float32")
    model, state = jax_train_state(flat, jcfg, 2)
    fn = jax.jit(jgrad_one(model, jcfg, jpreprocess, pp_kwargs(CROP)))
    jgrads, jbs, jlosses = fn(state.params, state.batch_stats, jraw,
                              jax.random.PRNGKey(0))
    jgrads = flatten_variables({"params": jgrads})
    jbs = flatten_variables({"batch_stats": jbs})
    reversed_raw = type(jraw)(*(a[::-1] for a in jraw))
    jdrift = flatten_variables({"params": fn(
        state.params, state.batch_stats, reversed_raw,
        jax.random.PRNGKey(0))[0]})

    tmodel, _ = torch_train_state(flat, cfg, 2)
    # preprocessing None: the step takes the InterHand one by type
    losses = _make_fused_grad_one(tmodel, cfg, None, pp_kwargs(CROP))(traw)
    for k in ("loss", "loss_xyz", "loss_rot"):
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]),
                                   rtol=1e-4)
    grads = export_flax_variables(tmodel, grads=True)
    assert sorted(grads) == sorted(jgrads)
    paths = sorted(jgrads)
    want = np.concatenate([np.ravel(jgrads[p]) for p in paths])
    got = np.concatenate([np.ravel(grads[p]) for p in paths])
    rev = np.concatenate([np.ravel(jdrift[p]) for p in paths])
    # the whole tree as one vector: |port - JAX| against |JAX reversed -
    # JAX|, both over |JAX|
    err, drift = (float(np.linalg.norm(x - want) / np.linalg.norm(want))
                  for x in (got, rev))
    assert err <= 2 * drift + 1e-4, (err, drift)
    # each leaf: 1e-4 of the largest gradient, plus twice the largest
    # element the reversal moved
    scale = np.abs(want).max()
    max_drift = np.abs(rev - want).max() / scale
    for path in paths:
        e = np.abs(grads[path] - jgrads[path]).max() / scale
        assert e <= 2 * max_drift + 1e-4, (path, e, max_drift)
    stats = {k: v for k, v in export_flax_variables(tmodel).items()
             if k.startswith("batch_stats/")}
    for path, want in jbs.items():
        assert max_rel_err(want, stats[path]) <= 1e-5, path


def _cfg(root, logs, **kw):
    from handpose_tpu_torch.config import Config
    args = dict(model_name=MODEL, input_channels=21,
                dataset_name="InterHand2.6M", dataset_root_dir=root,
                batch_size=B, infer_batch_size=B, max_epoch=1,
                input_img_shape=(32, 32), compute_dtype="float32",
                log_every_steps=0, num_workers=2, save_log_dir=str(logs))
    return Config(**{**args, **kw})


def test_worker_trains_an_interhand_epoch(tree, logs):
    cfg = _cfg(tree, logs, coord_uv_noise=True, scoremap_dropout=True,
               hue_aug=True)
    worker = Worker(cfg, device="cpu")
    # InterHand's two augmentations; hue and the crop noises are RHD's
    assert {f for f, on in worker.aug_flags.items() if on} == \
        {"coord_uv_noise", "scoremap_dropout"}
    assert worker.steps_per_epoch == N // B and len(worker.val_ds) == 6
    best = worker.run()
    assert worker.state.step == 2 and np.isfinite(best)
    log = open(worker.log_path).read()
    assert "InterHand2.6M train samples" in log
    ev = Evaluator(cfg, weights=os.path.join(worker.run_dir, "model_best"),
                   device="cpu")
    assert ev.evaluate() == best
    # the decoded caches: built on first use, read by the next run
    cached = Worker(cfg.replace(cache_decoded=True), device="cpu")
    assert os.path.exists(os.path.join(tree, "decoded_train_64x64.u8"))
    assert os.path.exists(os.path.join(tree, "decoded_val_64x64.u8"))
    assert np.isfinite(cached.run(fast_debug=True))


def test_train_cli_on_interhand(tree, logs, capsys):
    from handpose_tpu_torch.train.__main__ import main
    before = signal.getsignal(signal.SIGTERM)
    try:
        best = main(["--device", "cpu", "--dataset", "InterHand2.6M",
                     "--data_root", tree, "--batch_size", str(B),
                     "--max_epoch", "1", "--fast_debug", "--log_dir",
                     str(logs), "--set", "input_img_shape=32,32",
                     "--set", "compute_dtype=float32",
                     "--set", "scoremap_dropout=true"])
    finally:
        signal.signal(signal.SIGTERM, before)
    assert np.isfinite(best)
    assert "best val MPJPE" in capsys.readouterr().out
