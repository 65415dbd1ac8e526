"""The port's training harness on the host: checkpoints, resume,
preemption, augmented and fake-data training, logging and the train CLI.

An 8-sample RHD tree (both splits) from ``write_synthetic_rhd``, batch
4 (2 steps an epoch), crop 32, float32, on the CPU:

* a run resumed from its epoch-1 checkpoint ends bit-equal to the
  uninterrupted run (params, statistics, Adam's moments), and the
  Evaluator on ``model_best`` gives the run's best validation MPJPE;
* preemption: a signal inside a step stops the loop at the next step
  boundary and pins the checkpoint to the interrupted epoch, which the
  resumed Worker restarts; a request during validation leaves the best
  MPJPE alone and resumes at the next epoch;
* two augmented Workers with one seed end bit-equal;
* fake-data training lowers the validation loss and writes
  ``provenance.json``;
* the train CLI's ``main`` with ``--from_run ... --resume ...``, and
  with ``--fake_data``, returns a finite MPJPE (in this process, its
  SIGTERM handler restored after);
* ``reconcile_schedule_count``, the ``PreemptionGuard`` handler
  restore and the ``Config`` JSON round trip.
"""

import os
import shutil
import signal

import numpy as np
import pytest
import torch

from handpose_tpu_torch.config import Config
from handpose_tpu_torch.convert import export_flax_variables
from handpose_tpu_torch.data.rhd import write_synthetic_rhd
from handpose_tpu_torch.infer import Evaluator
from handpose_tpu_torch.train import (PreemptionGuard, Worker,
                                      reconcile_schedule_count)
from handpose_tpu_torch.train.checkpoints import TRAIN_STATE

from _torch_port import port_worker_niced  # noqa: F401  (one torch thread, niced)

N, BATCH, CROP = 8, 4, 32
AUG = dict(hue_aug=True, coord_uv_noise=True, crop_center_noise=True,
           crop_scale_noise=True, crop_offset_noise=True,
           scoremap_dropout=True)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("rhd"))
    write_synthetic_rhd(root, "training", n=N, seed=5)
    write_synthetic_rhd(root, "evaluation", n=N, seed=6)
    return root


@pytest.fixture
def logs(tmp_path):
    """A log directory, removed after the test: every epoch's end writes
    a checkpoint of ~300 MB (the trunks' variables and Adam's moments)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _cfg(root, logs, **kw):
    args = dict(model_name="Hand3DPosePriorNetwork", input_channels=21,
                dataset_name="RHD", dataset_root_dir=root,
                batch_size=BATCH, infer_batch_size=BATCH, max_epoch=2,
                input_img_shape=(CROP, CROP), compute_dtype="float32",
                log_every_steps=0, save_log_dir=str(logs))
    return Config(**{**args, **kw})


def _adam(worker) -> list:
    st = worker.state.optimizer.state
    return [st[p][k] for p in worker.model.parameters()
            for k in ("exp_avg", "exp_avg_sq", "step")]


def _assert_same_state(a, b, schedule=True):
    """Variables and Adam's moments and steps bit-equal; with
    ``schedule``, the schedule's count too."""
    va, vb = export_flax_variables(a.model), export_flax_variables(b.model)
    assert sorted(va) == sorted(vb)
    for path in va:
        np.testing.assert_array_equal(vb[path], va[path], err_msg=path)
    assert all(torch.equal(x, y) for x, y in zip(_adam(a), _adam(b)))
    assert a.state.step == b.state.step or not schedule


@pytest.fixture(scope="module")
def full_run(tree, tmp_path_factory):
    """Two epochs, uninterrupted."""
    logs = tmp_path_factory.mktemp("full")
    w = Worker(_cfg(tree, logs), device="cpu")
    w.run()
    yield w
    shutil.rmtree(logs, ignore_errors=True)


def test_resume_continues_exactly(tree, logs, full_run):
    cfg = _cfg(tree, logs)
    first = Worker(cfg, device="cpu")
    first.run(max_epoch=1)
    ckpt = os.path.join(first.run_dir, "checkpoint")
    saved = torch.load(os.path.join(ckpt, TRAIN_STATE), weights_only=True)
    assert saved["epoch"] == 1 and saved["step"] == 2
    resumed = Worker(cfg.replace(resume_weight_path=ckpt), device="cpu")
    assert resumed.start_epoch == 1 and resumed.state.step == 2
    assert resumed.best_mpjpe == np.float32(first.best_mpjpe)
    _assert_same_state(first, resumed)
    resumed.run()
    _assert_same_state(full_run, resumed)
    # (a best of epoch 0 comes back as the checkpoint's float32)
    assert resumed.best_mpjpe in (full_run.best_mpjpe,
                                  float(np.float32(full_run.best_mpjpe)))
    # the Evaluator on model_best reproduces the best validation MPJPE
    for name in ("config.json", "provenance.json", "log.txt",
                 "checkpoint", "model_best"):
        assert os.path.exists(os.path.join(full_run.run_dir, name)), name
    ev = Evaluator(full_run.cfg, device="cpu",
                   weights=os.path.join(full_run.run_dir, "model_best"))
    assert ev.evaluate() == full_run.best_mpjpe


def test_preemption_checkpoint_and_resume(tree, logs):
    # the single-step boundary: JAX's rule at steps_per_dispatch=1 (the
    # group rule is tests/test_torch_knobs.py's)
    cfg = _cfg(tree, logs, max_epoch=3, steps_per_dispatch=1)
    w = Worker(cfg, device="cpu")
    guard = w.enable_preemption_save(
        PreemptionGuard(signals=(signal.SIGUSR1,)))
    try:
        # the signal arrives inside step 3 (epoch 1, iter 0, at 2 steps
        # an epoch): the next step boundary notices it
        calls = {"n": 0}
        orig = w.train_step

        def counting_step(state, raw, **kw):
            calls["n"] += 1
            if calls["n"] == 3:
                os.kill(os.getpid(), signal.SIGUSR1)
            return orig(state, raw, **kw)

        w.train_step = counting_step
        w.run()
        assert guard.requested and calls["n"] == 3
        ckpt = os.path.join(w.run_dir, "checkpoint")
        # the preemption save overwrote epoch 0's end-of-epoch save
        w2 = Worker(cfg.replace(resume_weight_path=ckpt), device="cpu")
        assert w2.start_epoch == 1
        assert w2.state.step == 2      # the schedule at epoch 1's start
        _assert_same_state(w, w2, schedule=False)   # Adam: the 3 taken
    finally:
        guard.uninstall()

    # a request during validation: training of the epoch finished, the
    # partial validation is ignored and resume continues after the epoch
    g2 = w2.enable_preemption_save(PreemptionGuard(signals=()))
    best_before = w2.best_mpjpe
    assert np.isfinite(best_before)
    orig_eval = w2.eval_step

    def requesting_eval(raw):
        g2.request()
        return orig_eval(raw)

    w2.eval_step = requesting_eval
    assert w2.run() == best_before
    saved = torch.load(os.path.join(w2.run_dir, "checkpoint", TRAIN_STATE),
                       weights_only=True)
    assert saved["epoch"] == w2.start_epoch + 1 == 2
    assert float(saved["best_mpjpe"]) == np.float32(best_before)


def test_augmented_training_is_reproducible(tree, logs):
    runs = []
    for _ in range(2):
        w = Worker(_cfg(tree, logs, max_epoch=1, **AUG), device="cpu")
        assert w.aug_flags == AUG
        w.run_epoch(0, "training")
        runs.append(w)
    _assert_same_state(*runs)
    log = open(runs[0].log_path).read()
    assert "augmentations ['hue_aug'" in log and "input stall" in log


def test_fake_data_training_lowers_the_loss(logs):
    cfg = _cfg("unused", logs, use_fake_data=True, lr=1e-3)
    w = Worker(cfg, device="cpu")
    assert w.steps_per_epoch == 10 and not w.fused
    val0 = w.run_epoch(0, "validation", fast_debug=True)
    for e in range(2):
        w.run_epoch(e, "training", fast_debug=True)
    val = w.run_epoch(0, "validation", fast_debug=True)
    assert np.isfinite(val) and val < val0
    assert os.path.exists(os.path.join(w.run_dir, "provenance.json"))
    assert Config.from_json(open(os.path.join(
        w.run_dir, "config.json")).read()) == cfg


def _main(*args) -> float:
    """The train CLI's ``main`` in this process, with the SIGTERM handler
    it arms restored after."""
    from handpose_tpu_torch.train.__main__ import main
    before = signal.getsignal(signal.SIGTERM)
    try:
        return main(["--device", "cpu", *args])
    finally:
        signal.signal(signal.SIGTERM, before)


def test_train_cli_from_run_with_resume_and_fake_data(logs, full_run,
                                                      capsys):
    run = full_run.run_dir
    best = _main("--from_run", run, "--resume",
                 os.path.join(run, "checkpoint"), "--max_epoch", "3",
                 "--fast_debug", "--log_dir", str(logs / "again"))
    out = capsys.readouterr().out
    assert "as resume; start_epoch=2" in out
    assert "Training Epoch: 002" in out and "best val MPJPE" in out
    assert np.isfinite(best) and best <= full_run.best_mpjpe
    best = _main("--fake_data", "--fast_debug", "--max_epoch", "1",
                 "--batch_size", "2", "--log_dir", str(logs / "fake"),
                 "--set", f"input_img_shape={CROP},{CROP}",
                 "--set", "compute_dtype=float32")
    assert np.isfinite(best)
    assert "fake batches" in capsys.readouterr().out


def test_reconcile_schedule_count_keeps_adams_steps(full_run):
    state = full_run.state
    adam_steps = [s["step"].clone() for s in state.optimizer.state.values()]
    assert state.step == 4
    reconcile_schedule_count(state, start_epoch=7, steps_per_epoch=5)
    assert state.step == 35
    assert state.schedule(state.step) == state.schedule(7 * 5 + 4)
    assert all(torch.equal(a, s["step"]) for a, s in
               zip(adam_steps, state.optimizer.state.values()))


def test_preemption_guard_restores_a_non_python_handler():
    g = PreemptionGuard(signals=(signal.SIGUSR1,))
    with g:
        assert signal.getsignal(signal.SIGUSR1) == g._trap
        g._previous[signal.SIGUSR1] = None      # as if set from C
    assert signal.getsignal(signal.SIGUSR1) == signal.SIG_DFL
    assert not g.requested
    g.request()
    assert g.requested


def test_config_json_round_trip():
    import json
    cfg = Config(mesh_shape=(4, 2), mesh_axis_names=("data", "model"),
                 sigma=12.5, remat=True, scale_target_size=(120, 160),
                 resume_weight_path="ckpt")
    assert Config.from_json(cfg.to_json()) == cfg
    raw = json.loads(cfg.to_json())
    raw["some_future_field"] = 42
    assert Config.from_json(json.dumps(raw)) == cfg
