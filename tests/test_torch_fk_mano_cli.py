"""The port's CLIs on the FK and MANO models, on the host.

* ``python -m handpose_tpu_torch.train --model <model> --fake_data``
  trains each of ``TwoDimHandPoseWithFK``, ``ThreeDimHandPose``,
  ``MANO3DHandPose``, ``ThreeHandShapeAndPoseMANO`` and
  ``Resnet50MANO3DHandPose`` (crop 64, float32) with its trainer-A loss
  terms, and the infer CLI given only that run's ``model_best`` takes the
  model from the path, the input channels from the model (24 for the two
  MANO models with a scoremap stem, 3 otherwise) and reports the run's
  best validation MPJPE exactly;
* ``Resnet50MANO3DHandPose`` on a synthetic RHD tree with ``--set
  mano_right_hand_path=<pickle>``: the MANO it loads is that pickle's
  (named on stderr and in the run's ``provenance.json``), the hand-mask
  term reads the tree's right-hand mask, the Evaluator on ``model_best``
  gives the run's best exactly, and warns when it loads another MANO.
"""

import glob
import json
import os
import shutil

import numpy as np
import pytest

from handpose_tpu_torch import Config
from handpose_tpu_torch.infer import Evaluator
from handpose_tpu_torch.infer import __main__ as infer_cli
from handpose_tpu_torch.nn import mano
from handpose_tpu_torch.train import __main__ as train_cli

from _torch_port import write_mano_pickle
from _torch_port import port_worker_niced  # noqa: F401

SMALL = ["--device", "cpu", "--batch_size", "4",
         "--set", "input_img_shape=64,64", "--set", "compute_dtype=float32"]
# the loss terms each model's gates give (config.LOSS_GATES)
TERMS = {"TwoDimHandPoseWithFK": ("loss_xyz", "loss_uv"),
         "ThreeDimHandPose": ("loss_xyz",),
         "MANO3DHandPose": ("loss_xyz",),
         "ThreeHandShapeAndPoseMANO": ("loss_xyz",),
         "Resnet50MANO3DHandPose": ("loss_xyz", "loss_hand_mask",
                                    "loss_regularization")}
CHANNELS = {"ThreeHandShapeAndPoseMANO": 24, "Resnet50MANO3DHandPose": 24}


@pytest.fixture
def logs(tmp_path):
    """A log directory removed after the test (a ResNet-50 checkpoint is
    ~330 MB)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture
def seen_configs(monkeypatch):
    """The Configs the infer CLI hands its Evaluator."""
    seen = []
    real = infer_cli.Evaluator

    def spy(cfg, **kw):
        seen.append(cfg)
        return real(cfg, **kw)

    monkeypatch.setattr(infer_cli, "Evaluator", spy)
    return seen


def _only_run(logs, model, dataset):
    runs = glob.glob(os.path.join(str(logs), model, dataset, "run_*"))
    assert len(runs) == 1
    return runs[0]


@pytest.mark.parametrize("model", sorted(TERMS))
def test_train_then_evaluate_model_best(model, logs, seen_configs, capsys):
    best = train_cli.main(["--model", model, "--fake_data", "--fast_debug",
                           "--max_epoch", "1", "--log_dir", str(logs),
                           *SMALL])
    run = _only_run(logs, model, "synthetic")
    log = open(os.path.join(run, "log.txt")).read()
    assert f"training {model}" in log and np.isfinite(best)
    epoch = [t for t in log.splitlines() if t.startswith("Training Epoch")]
    assert len(epoch) == 1
    assert all(f"{term}: " in epoch[0] for term in TERMS[model]), epoch
    mpjpe = infer_cli.main(["--dataset", "synthetic", "--ckpt",
                            os.path.join(run, "model_best"), *SMALL])
    cfg, = seen_configs
    assert (cfg.model_name, cfg.input_channels) == (model,
                                                     CHANNELS.get(model, 3))
    assert mpjpe == best
    assert f"visible-joint MPJPE: {best:.5f} mm" in capsys.readouterr().out


def test_resnet50_mano_on_an_rhd_tree_with_a_mano_pickle(logs, capsys):
    from handpose_tpu_torch.data.rhd import write_synthetic_rhd
    tree = str(logs / "rhd")
    write_synthetic_rhd(tree, "evaluation", n=8, seed=3)
    pkl = str(logs / "MANO_RIGHT.pkl")
    write_mano_pickle(pkl, mano.synthetic_mano(seed=5))
    model = "Resnet50MANO3DHandPose"
    args = ["--data_root", tree, "--set", f"mano_right_hand_path={pkl}",
            *SMALL]
    best = train_cli.main(["--model", model, "--use_val_to_debug",
                           "--max_epoch", "1", "--log_dir", str(logs),
                           *args])
    assert f"MANO: {pkl}" in capsys.readouterr().err
    run = _only_run(logs, model, "RHD")
    log = open(os.path.join(run, "log.txt")).read()
    hand = [float(t.split("loss_hand_mask: ")[1].split(",")[0])
            for t in log.splitlines() if t.startswith("Training Epoch")]
    # 1 - (mask at the predicted uv) / (mask at the labels): the tree's
    # masks hold right hands, so the term is not the 1.0 of an empty mask
    assert len(hand) == 1 and np.isfinite(hand[0]) and hand[0] != 1.0
    with open(os.path.join(run, "provenance.json")) as f:
        assert json.load(f)["mano"] == os.path.abspath(pkl)
    mpjpe = infer_cli.main(["--ckpt", os.path.join(run, "model_best"),
                            *args])
    assert np.isfinite(best) and mpjpe == best
    # the checkpoint without the MANO it was trained with: a warning
    with pytest.warns(UserWarning, match="trained with MANO"):
        Evaluator(Config(model_name=model, input_channels=24,
                         input_img_shape=(64, 64), compute_dtype="float32",
                         dataset_root_dir=tree),
                  weights=os.path.join(run, "model_best"), device="cpu")
