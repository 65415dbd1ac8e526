"""A run's last line, the refusal to measure without a card, and a run
with the timed path broken underneath: each fault reads not correct.

These drive the whole harness on the host at a tiny size (crop 32,
batch 8, the trunks in float32), skipping only its look for a card."""

import json
import math

import pytest
import torch

from port_bench import run
from port_bench.manifest import Manifest

SMALL_TRAIN = {"samples": 24, "batch": 8, "eval_samples": 2}
SMALL_SERVE = {"batch": 8, "pool": 2, "warm_calls": 1, "traced_calls": 2}
F32 = {"crop": 32, "compute_dtype": "float32"}
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def small(cell, trace=False, seconds=0.5):
    traffic = SMALL_TRAIN if "train" in cell else SMALL_SERVE
    return run.run_cell(cell, 2 ** 33 + 7, seconds, trace, device="cpu",
                        config_overrides=F32, traffic_overrides=traffic)


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    rc = run.main(["--workload", "posepriornet-serve-b256", "--seed", "1",
                   "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


@pytest.mark.parametrize("cell,trace", [
    ("posepriornet-train-b256", False), ("posepriornet-train-b256", True),
    ("hand3dposenet-r50-serve-b256", False),
    ("hand3dposenet-r50-serve-b256", True)])
def test_last_line(cell, trace):
    r = small(cell, trace)
    keys = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(r) == keys
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    json.loads(json.dumps(r))
    names = {m["name"] for m in Manifest.load().data[
        "per_layer" if trace else "end_to_end"]}
    assert set(r["metrics"]) <= names and r["metrics"]
    assert all(math.isfinite(m["value"]) for m in r["metrics"].values())
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]
    if trace:
        assert set(r["device"]) >= {"busy_s", "window_s"}
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def _broken(monkeypatch, fault):
    """Break the measured package underneath the harness."""
    from handpose_tpu_torch.infer import serving
    from handpose_tpu_torch.train import state, steps
    if fault == "state unchanged":
        monkeypatch.setattr(state.TrainState, "apply_gradients",
                            lambda self: self)
    elif fault == "half the batch":
        losses = steps.compute_losses

        def half(out, batch, cfg):
            n = batch["keypoint_vis21"].shape[0] // 2
            cut = {f: getattr(out, f)[:n] for f in ("can_xyz", "rot_mat")}
            return losses(type(out)(**cut), {k: v[:n] for k, v in
                                             batch.items()}, cfg)
        monkeypatch.setattr(steps, "compute_losses", half)
    elif fault == "an answer altered":
        serve = serving.serve

        def altered(*a, **kw):
            xyz, uv = serve(*a, **kw)
            xyz = xyz.clone()
            xyz[0, 3, 1] += 0.05
            return xyz, uv
        monkeypatch.setattr(serving, "serve", altered)
    elif fault == "half the batch served":
        serve = serving.serve

        def half(model, raw, cfg, device=None):
            n = raw[0].shape[0] // 2
            return serve(model, type(raw)(*(a[:n] for a in raw)), cfg,
                         device)
        monkeypatch.setattr(serving, "serve", half)


@pytest.mark.parametrize("cell,fault", [
    ("posepriornet-train-b256", "state unchanged"),
    ("posepriornet-train-b256", "half the batch"),
    ("hand3dposenet-r50-serve-b256", "an answer altered"),
    ("hand3dposenet-r50-serve-b256", "half the batch served")])
def test_a_broken_path_is_not_correct(monkeypatch, cell, fault):
    _broken(monkeypatch, fault)
    r = small(cell)
    assert r["correct"] is False
    assert any(c["value"] == "inf" or c["value"] > c["limit"]
               for c in r["checks"].values())


@pytest.mark.parametrize("extra", [{"augmentations": ["flip_img"]},
                                   {"steps_per_dispatch": 8},
                                   {"cache_decoded": False}])
def test_a_train_mix_the_reference_cannot_check_is_refused(extra):
    with pytest.raises(ValueError, match="cannot be checked|no support"):
        run.run_cell("posepriornet-train-b256", 1, 0.5, False, device="cpu",
                     config_overrides=F32,
                     traffic_overrides={**SMALL_TRAIN, **extra})
