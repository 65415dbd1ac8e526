"""The frozen reference and data against handpose_tpu_torch's plain path
(float32, the host) at a tiny size: the same weights' leaves, the same
preprocessing, forwards, losses and first gradient."""

import json

import numpy as np
import pytest
import torch

from port_bench import weights
from port_bench.manifest import HERE
from port_bench.reference import preprocess, synth, trainer_b

from handpose_tpu_torch import Config
from handpose_tpu_torch.convert import export_flax_tensors, \
    load_flax_variables
from handpose_tpu_torch.data.preprocess import (RawBatch, model_input,
                                                preprocess_batch)
from handpose_tpu_torch.models import build_model
from handpose_tpu_torch.train import compute_losses

CROP, B = 48, 4


@pytest.fixture(scope="module", params=["posepriornet", "hand3dposenet-r50"])
def pair(request):
    cfg = {**json.load(open(HERE / "configs" / f"{request.param}.json")),
           "crop": CROP}
    port_cfg = Config(model_name=cfg["model_name"],
                      input_channels=cfg["input_channels"],
                      input_img_shape=(CROP, CROP), compute_dtype="float32")
    spec = trainer_b.spec(cfg)
    w = weights.make(spec, torch.Generator().manual_seed(3))
    host = {k: v.numpy().copy() for k, v in w.items()}
    raw = synth.raw_fields(synth.make_samples(B, torch.Generator()
                                              .manual_seed(4)))
    return cfg, port_cfg, spec, w, host, raw


def test_spec_is_the_ports_flax_tree(pair):
    cfg, port_cfg, spec, *_ = pair
    model = build_model(port_cfg)
    tree = export_flax_tensors(model, {**dict(model.named_parameters()),
                                       **dict(model.named_buffers())})
    assert {p: s for p, s, _ in spec} == {k: v.shape for k, v in tree.items()}


def test_preprocessing(pair):
    cfg, port_cfg, spec, w, host, raw = pair
    port = preprocess_batch(RawBatch(*raw), crop_size=CROP, sigma=25.0,
                            switch_joint_order=True)
    ref = preprocess.preprocess(raw, CROP, 25.0)
    for a, b in (("scoremap", "scoremap"), ("image_crop", "image_crop"),
                 ("kp_coord_xyz21_rel_can", "can"), ("rot_mat", "rot"),
                 ("camera_intrinsic_matrix", "K"), ("keypoint_scale", "scale"),
                 ("keypoint_xyz_root", "root"), ("keypoint_vis21", "vis21")):
        assert torch.equal(port[a], ref[b]), a


def test_serving_outputs(pair):
    cfg, port_cfg, spec, w, host, raw = pair
    model = load_flax_variables(build_model(port_cfg, is_inference=True),
                                host).eval()
    port = preprocess_batch(RawBatch(*raw), crop_size=CROP, sigma=25.0,
                            switch_joint_order=True)
    with torch.no_grad():
        out = model(model_input(port, cfg["input_channels"]),
                    port["camera_intrinsic_matrix"], port["keypoint_scale"],
                    port["keypoint_xyz_root"])
        pp = preprocess.preprocess(raw, CROP, 25.0)
        xyz, uv = trainer_b.served(trainer_b.forward(w, pp, cfg, False), pp)
    torch.testing.assert_close(out.xyz, xyz, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(out.uv, uv, rtol=1e-4, atol=1e-3)


def test_train_loss_and_gradient(pair):
    cfg, port_cfg, spec, w, host, raw = pair
    model = load_flax_variables(build_model(port_cfg), host).train()
    port = preprocess_batch(RawBatch(*raw), crop_size=CROP, sigma=25.0,
                            switch_joint_order=True)
    out = model(model_input(port, cfg["input_channels"]),
                port["camera_intrinsic_matrix"], port["keypoint_scale"],
                port["keypoint_xyz_root"])
    loss = compute_losses(out, port, port_cfg)["loss"]
    loss.backward()
    grads = export_flax_tensors(model, {n: p.grad for n, p in
                                        model.named_parameters()})
    params = {k: v.clone().requires_grad_(True) for k, v in w.items()
              if k.startswith("params/")}
    pp = preprocess.preprocess(raw, CROP, 25.0)
    ref = trainer_b.losses(trainer_b.forward({**w, **params}, pp, cfg, True),
                           pp)["loss"]
    ref_grads = torch.autograd.grad(ref, list(params.values()))
    assert float(loss) == pytest.approx(float(ref), rel=1e-5)
    scale = max(float(g.abs().max()) for g in ref_grads)
    for (k, _), g in zip(params.items(), ref_grads):
        np.testing.assert_allclose(grads[k], g.numpy(), rtol=0,
                                   atol=2e-5 * scale, err_msg=k)
