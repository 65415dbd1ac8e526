"""The port's Worker and training CLI on the host.

A 12-sample RHD tree (both splits) from the port's
``write_synthetic_rhd``, batch 4, crop 64, float32, on the CPU:

* one epoch trains 3 steps with finite losses and writes its log lines;
* the validation MPJPE equals, exactly, the port ``Evaluator``'s
  whole-split MPJPE on the same weights and batch size (the JAX repo's
  invariant between ``trainval.py`` and ``inference.py``);
* a non-finite loss aborts with ``FloatingPointError``;
* ``python -m handpose_tpu_torch.train --device cpu --fast_debug ...``
  exits 0;
* the Worker and the CLI default to the card and raise without one, and
  what waits for later slices raises ``NotImplementedError``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from handpose_tpu_torch.config import Config
from handpose_tpu_torch.convert import export_flax_variables
from handpose_tpu_torch.data.rhd import write_synthetic_rhd
from handpose_tpu_torch.infer import Evaluator
from handpose_tpu_torch.train import Worker

import _torch_port  # noqa: F401  (one torch thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, BATCH, CROP = 12, 4, 64


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("rhd"))
    write_synthetic_rhd(root, "training", n=N, seed=3)
    write_synthetic_rhd(root, "evaluation", n=N, seed=4)
    return root


def _cfg(root, logs, **kw):
    return Config(model_name="Hand3DPosePriorNetwork", input_channels=21,
                  dataset_name="RHD", dataset_root_dir=root,
                  batch_size=BATCH, infer_batch_size=BATCH, max_epoch=1,
                  input_img_shape=(CROP, CROP), compute_dtype="float32",
                  save_log_dir=str(logs), **kw)


def test_worker_epoch_and_validation_equal_to_the_evaluator(tree, tmp_path):
    worker = Worker(_cfg(tree, tmp_path), device="cpu")
    assert worker.steps_per_epoch == N // BATCH
    best = worker.run()
    assert worker.state.step == 3 and len(worker.step_seconds) == 3
    log = open(worker.log_path).read()
    assert "Training Epoch: 000" in log and "Validation Epoch: 000" in log
    assert "one at a time" in log           # steps_per_dispatch=8
    line = next(t for t in log.splitlines()
                if t.startswith("Training Epoch: 000"))
    assert np.isfinite(float(line.rsplit("loss: ", 1)[1].split(",")[0]))
    ev = Evaluator(_cfg(tree, tmp_path),
                   weights=export_flax_variables(worker.model), device="cpu")
    assert np.isfinite(best) and best == ev.evaluate()


def test_worker_aborts_on_a_non_finite_loss(tree, tmp_path):
    worker = Worker(_cfg(tree, tmp_path), device="cpu")
    with torch.no_grad():
        worker.model.PosePrior_net.mlp.Dense_0.bias.fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="epoch 0 iter 0"):
        worker.run(fast_debug=True)
    assert "FATAL: non-finite loss" in open(worker.log_path).read()


def test_train_cli_fast_debug_exits_0(tree, tmp_path):
    weights = str(tmp_path / "w.npz")
    worker = Worker(_cfg(tree, tmp_path), device="cpu")
    np.savez(weights, **export_flax_variables(worker.model))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run(
        [sys.executable, "-m", "handpose_tpu_torch.train", "--device", "cpu",
         "--fast_debug", "--data_root", tree, "--batch_size", str(BATCH),
         "--max_epoch", "1", "--log_dir", str(tmp_path / "cli"),
         "--weights", weights, "--set", f"input_img_shape={CROP},{CROP}",
         "--set", "compute_dtype=float32"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "best val MPJPE" in res.stdout


def test_worker_defaults_to_the_card_and_waits_where_it_should(tree,
                                                               tmp_path):
    from handpose_tpu_torch.train.__main__ import main
    cfg = _cfg(tree, tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Worker(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--data_root", tree, "--set",
                  f"save_log_dir={tmp_path}"])
    for kw in (dict(hue_aug=True), dict(resume_weight_path="ckpt"),
               dict(use_fake_data=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue"):
            Worker(cfg.replace(**kw), device="cpu")
    with pytest.raises(NotImplementedError, match="queue 3"):
        Worker(cfg, device="cpu").enable_preemption_save()
    with pytest.raises(SystemExit):
        main(["--model", "MANO3DHandPose", "--device", "cpu"])
