"""The FK and MANO families on the card, held to the host.

FK against ``tests/fixtures/fk.npz`` (the torch reference's outputs) and
the host; the MANO layer on the synthetic stand-in against the host for
pose_num 6, 10 and 45; the forward of each of the five models on the
card against the host; one fused train step of each MANO trunk routed
through K1, K2 and K3 against the same step with the plain versions.
float32, TF32 off.

Random heads drive FK and MANO where the geometry multiplies rounding
(angles of hundreds of radians, joints near the projection's pole), so
a model's forward is held in two parts, as on the host against JAX
(``tests/test_torch_fk_mano_models.py``): the geometry's inputs, and the
outputs computed on the card from the host's geometry inputs.

Marked ``gpu``; each test skips when no CUDA device is present.  This
file imports no JAX, so it also runs where JAX is not installed, without
the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py \\
        tests/test_torch_gpu_fk_mano.py
"""

import os

import numpy as np
import pytest
import torch

from handpose_tpu_torch import Config
from handpose_tpu_torch.config import default_input_channels
from handpose_tpu_torch.nn import fk, mano

from test_torch_gpu import _step_routes

pytestmark = pytest.mark.gpu

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
MODELS = ("TwoDimHandPoseWithFK", "ThreeDimHandPose", "MANO3DHandPose",
          "ThreeHandShapeAndPoseMANO", "Resnet50MANO3DHandPose")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(ref, out):
    ref, out = ref.double().cpu(), out.double().cpu()
    return float((out - ref).abs().max() / ref.abs().max().clamp(min=1e-12))


@pytest.mark.parametrize("switched", [True, False])
def test_fk_on_the_card_matches_the_fixture_and_the_host(cuda, switched):
    with np.load(os.path.join(FIXTURES, "fk.npz")) as f:
        f = {k: f[k] for k in f.files}
    args = [torch.from_numpy(f[k]) for k in (
        "root_angles", "other_angles", "bone_lengths", "K", "scale", "root")]
    host = fk.forward_kinematics(*args, joint_order_switched=switched)
    card = fk.forward_kinematics(*(a.to(cuda) for a in args),
                                 joint_order_switched=switched)
    key = "noswitch" if switched else "switch"       # the fixture's names
    np.testing.assert_allclose(card[0].cpu().numpy(), f[f"xyz_{key}"],
                               atol=2e-5)
    np.testing.assert_allclose(card[1].cpu().numpy(), f[f"uv_{key}"],
                               rtol=1e-4, atol=5e-2)
    for h, c in zip(host, card):
        assert _rel(h, c) <= 1e-6


@pytest.mark.parametrize("pose_num", [6, 10, 45])
def test_mano_layer_on_the_card_matches_the_host(cuda, pose_num):
    g = torch.Generator().manual_seed(pose_num)
    B = 64
    args = (torch.randn(B, 3, generator=g),
            torch.randn(B, pose_num, generator=g),
            torch.randn(B, 10, generator=g) * 0.5)
    args[0][0] = 0.0                     # a zero rotation: Taylor branch
    layer = mano.ManoLayer(mano.synthetic_mano(), pose_num=pose_num)
    host = layer(*args)
    card = layer.to(cuda)(*(a.to(cuda) for a in args))
    assert card[0].device.type == cuda.type
    for h, c in zip(host, card):
        assert _rel(h, c) <= 1e-5


def _flat(feats):
    out = []
    for v in feats.values():
        out.extend(v if isinstance(v, tuple) else (v,))
    return out


@pytest.mark.parametrize("model_name", MODELS)
def test_model_forward_on_the_card_matches_the_host(cuda, model_name):
    """Eval forward of the inference build, b2 crop 64: the geometry's
    inputs card vs host, then the card's outputs from the host's
    geometry inputs, each 1e-4 of range."""
    from handpose_tpu_torch.models import build_model, hook_geometry_inputs
    ch = default_input_channels(model_name)
    cfg = Config(model_name=model_name, input_channels=ch,
                 input_img_shape=(64, 64), compute_dtype="float32")
    g = torch.Generator().manual_seed(len(model_name))
    img = torch.rand(2, 64, 64, ch, generator=g)
    K = torch.tensor([[200.0, 0, 32], [0, 200.0, 32], [0, 0, 1]]).expand(
        2, 3, 3).contiguous()
    scale = torch.full((2, 1), 0.015)
    root = torch.tensor([[0.0, 0.0, 0.6], [0.02, -0.01, 0.55]])
    host_model = build_model(cfg, is_inference=True)
    card_model = build_model(cfg, is_inference=True).to(cuda)
    host_feats = hook_geometry_inputs(host_model)
    card_own = hook_geometry_inputs(card_model)
    with torch.no_grad():
        host = host_model(img, K, scale, root)
        card_model(*(t.to(cuda) for t in (img, K, scale, root)))
        for h, c in zip(_flat(host_feats), _flat(card_own)):
            assert _rel(h, c) <= 1e-4
        sub = build_model(cfg, is_inference=True).to(cuda)
        hook_geometry_inputs(sub, host_feats)
        card = sub(*(t.to(cuda) for t in (img, K, scale, root)))
    for k in ("xyz", "uv", "uv_aux", "theta", "beta"):
        h, c = getattr(host, k), getattr(card, k)
        assert (h is None) == (c is None), k
        if h is not None:
            assert c.device.type == cuda.type and _rel(h, c) <= 1e-4, k


@pytest.mark.parametrize("model_name,k2", [("ThreeHandShapeAndPoseMANO", 36),
                                           ("Resnet50MANO3DHandPose", 53)])
def test_mano_train_step_kernels_against_plain(cuda, model_name, k2):
    """One fused train step (crop 64, B 4, 24 channels) through K1, K2
    and K3 against the same step with the plain versions, held to the
    plain step with the moment rows summed in reverse order, as
    ``test_torch_gpu.py`` holds the ResNet-50 step (the hand-mask term,
    a step function of uv, left out of the losses held): one launch of
    K1 and K3, and K2 36 times (ResNetMano) or 53 (ResNet-50)."""
    import tempfile
    from handpose_tpu_torch.data.rhd import RHDDataset, write_synthetic_rhd
    cfg = Config(model_name=model_name, input_channels=24,
                 input_img_shape=(64, 64), compute_dtype="float32")
    with tempfile.TemporaryDirectory() as root:
        write_synthetic_rhd(root, "evaluation", n=4, seed=2)
        raw = RHDDataset(root, "evaluation",
                         cache_decoded=True).raw_batch(range(4)).to(cuda)
    (lk, gk, nk), (lp, gp, np_), (lq, gq, _) = _step_routes(
        cfg, raw, ("kernel", "plain", "plain, rows reversed"))
    assert nk == [1, k2, 1] and np_ == [0, 0, 0]
    for losses in (lk, lp, lq):
        # the hand-mask term is a step function of uv (no gradient): the
        # rest of the total is held
        losses["loss"] -= losses.pop("loss_hand_mask", 0.0)
    for k in lk:
        drift = abs(lq[k] - lp[k]) / abs(lp[k])
        np.testing.assert_allclose(lk[k], lp[k], rtol=1e-5 + 2 * drift,
                                   err_msg=k)
    err = float((gk - gp).norm() / gp.norm())
    drift = float((gq - gp).norm() / gp.norm())
    assert err <= 2 * drift + 1e-4, (err, drift)
