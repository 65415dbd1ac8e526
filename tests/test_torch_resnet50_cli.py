"""The port's CLIs on the ResNet-50 models, on the host.

* ``python -m handpose_tpu_torch.train --model OnlyThreeDimHandPose
  --fake_data`` trains (trainer A, its xyz gate) and writes its run
  under ``logs/<model>/synthetic/run_<ts>/``; the infer CLI given only
  that run's ``model_best`` takes the model name from the path, the
  input channels from the model, and reports the run's best validation
  MPJPE exactly;
* ``--model`` picks the model and ``--input_channels`` its channels
  (defaults: 3 for the ResNet-50 models, 21 for the flagship);
* ``TwoDimHandPose`` has no 3-D output: ``--pck`` reports a zero PCK
  curve and AUC 0, as the JAX ``evaluate_full`` does;
* a model outside the zoo is refused by both CLIs.
"""

import glob
import os
import shutil

import numpy as np
import pytest

from handpose_tpu_torch.infer import __main__ as infer_cli
from handpose_tpu_torch.infer import model_name_from_path
from handpose_tpu_torch.train import __main__ as train_cli

from _torch_port import port_worker_niced  # noqa: F401  (one torch thread, niced)

SMALL = ["--device", "cpu", "--batch_size", "4",
         "--set", "input_img_shape=64,64", "--set", "compute_dtype=float32"]


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


def test_trained_run_evaluates_by_its_path(logs, seen_configs, capsys):
    best = train_cli.main(["--model", "OnlyThreeDimHandPose", "--fake_data",
                           "--fast_debug", "--max_epoch", "1",
                           "--log_dir", str(logs), *SMALL])
    runs = glob.glob(os.path.join(str(logs), "OnlyThreeDimHandPose",
                                  "synthetic", "run_*"))
    assert len(runs) == 1 and np.isfinite(best)
    log = open(os.path.join(runs[0], "log.txt")).read()
    assert "training OnlyThreeDimHandPose" in log and "loss_xyz" in log
    ckpt = os.path.join(runs[0], "model_best")
    assert model_name_from_path(ckpt) == "OnlyThreeDimHandPose"
    mpjpe = infer_cli.main(["--dataset", "synthetic", "--ckpt", ckpt,
                            *SMALL])
    cfg, = seen_configs
    assert cfg.model_name == "OnlyThreeDimHandPose"
    assert cfg.input_channels == 3
    assert mpjpe == best
    assert f"visible-joint MPJPE: {best:.5f} mm" in capsys.readouterr().out


def test_model_and_input_channels_flags(seen_configs):
    infer_cli.main(["--dataset", "synthetic", "--model",
                    "OnlyThreeDimHandPose", "--input_channels", "24",
                    "--max_batches", "1", *SMALL])
    infer_cli.main(["--dataset", "synthetic", "--max_batches", "1",
                    "--set", "input_img_shape=32,32", *SMALL[:4]])
    assert [(c.model_name, c.input_channels) for c in seen_configs] == [
        ("OnlyThreeDimHandPose", 24), ("Hand3DPosePriorNetwork", 21)]


def test_two_dim_model_reports_no_pck(seen_configs, capsys):
    res = infer_cli.main(["--dataset", "synthetic", "--model",
                          "TwoDimHandPose", "--pck", *SMALL])
    assert seen_configs[0].input_channels == 3
    assert np.isfinite(res["mpjpe"]) and res["mpjpe"] > 0
    assert res["auc_20_50mm"] == 0.0
    np.testing.assert_array_equal(res["pck"], np.zeros(31))
    assert "AUC (20-50mm): 0.0000" in capsys.readouterr().out


@pytest.mark.parametrize("cli", [infer_cli, train_cli])
def test_models_not_ported_yet_are_refused(cli, capsys):
    """Every zoo model is ported: a name outside the zoo is refused by
    argparse, which lists the ten choices."""
    with pytest.raises(SystemExit):
        cli.main(["--model", "DiffusionHandPoseV2", "--device", "cpu"])
    err = capsys.readouterr().err
    assert "invalid choice" in err and "DiffusionHandPose" in err
