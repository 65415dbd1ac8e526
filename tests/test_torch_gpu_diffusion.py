"""The diffusion family on the card, held to the host.

``Unet1D`` at full width (dim 64, mults 1/2/4/8, 63-long sequences,
256-d condition) in its plain and time-table modes; the DDIM sampler on
the full T = 400 / S = 200 ladder and the DDPM sampler at T = 20, each
from an injected x_T (and, for DDPM, injected per-step noise), in two
parts: the whole sampler in float64, card vs host to 1e-9 of range, and
each denoiser call of the host's float64 run replayed in float32, card
vs host within twice the host's own float32-vs-float64 distance on the
call plus 1e-5 of range (a free-running float32 sample's distance from
float64 varies 1x-4x from one x_T to the next, so it cannot bound
another device's); the hoisted sampler against the unhoisted one on the
card in float64, to 1e-9 of range; and one fused train step of
``DiffusionHandPose`` (crop 64, B 4, T 20 / S 10, injected draws)
routed through K1, K2 and K3 against the same step with the plain
versions, as ``test_torch_gpu.py`` holds the ResNet-50 step.  float32,
TF32 off.

Marked ``gpu``; each test skips when no CUDA device is present.  This
file imports no JAX, so it also runs where JAX is not installed, without
the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_diffusion.py
"""

import copy

import numpy as np
import pytest
import torch

from handpose_tpu_torch import Config
from handpose_tpu_torch.models.zoo import init_parameters
from handpose_tpu_torch.nn.diffusion import GaussianDiffusion1D, Unet1D

from test_torch_gpu import _step_routes

pytestmark = pytest.mark.gpu

FEAT = 256


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


def _inputs(B, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, 63, 1, generator=g),
            torch.randint(0, 400, (B,), generator=g),
            torch.randn(B, FEAT, generator=g))


def test_unet1d_full_width_on_the_card_matches_the_host(cuda):
    """b4, plain and time-table modes, 1e-5 of range."""
    unet = init_parameters(Unet1D(64, condition_feat_dim=FEAT), seed=1)
    x, t, c = _inputs(4, 1)
    card = copy.deepcopy(unet).to(cuda)
    times = torch.tensor([399.0, 201.0, 0.0])
    with torch.no_grad():
        host = unet(x, t, c)
        got = card(x.to(cuda), t.to(cuda), c.to(cuda))
        assert _rel(host, got) <= 1e-5
        tabs = unet(None, times, c)
        ctabs = card(None, times.to(cuda), c.to(cuda))
        for k, v in tabs.items():
            assert _rel(v, ctabs[k]) <= 1e-5, k
        host = unet(x, t, c, time_tables={k: v[1] for k, v in tabs.items()})
        got = card(x.to(cuda), t.to(cuda), c.to(cuda),
                   time_tables={k: v[1] for k, v in ctabs.items()})
        assert _rel(host, got) <= 1e-5


def _to(v, device, dtype):
    if torch.is_tensor(v):
        return v.to(device, dtype) if v.is_floating_point() else v.to(device)
    if isinstance(v, dict):
        return {k: _to(x, device, dtype) for k, x in v.items()}
    if isinstance(v, (tuple, list)):
        return type(v)(_to(x, device, dtype) for x in v)
    return v


@pytest.mark.parametrize("T,S", [(400, 200), (20, 20)])
def test_sampler_on_the_card_within_both_devices_own_drift(cuda, T, S):
    """A sample at full width, b4, from an injected x_T (DDPM: and
    per-step noise): in float64 card vs host <= 1e-9 of range; each
    denoiser call of the host's float64 run in float32, card vs host
    within 2 x the host's float32-vs-float64 distance on the call + 1e-5
    of range."""
    unet = init_parameters(Unet1D(64, condition_feat_dim=FEAT), seed=2)
    gd = GaussianDiffusion1D(63, timesteps=T, sampling_timesteps=S)
    _, _, c = _inputs(4, 2)
    g = torch.Generator().manual_seed(3)
    x_T = torch.randn(4, 63, 1, generator=g)
    noise = None if S < T else torch.randn(T, 4, 63, 1, generator=g)
    card_unet = copy.deepcopy(unet).to(cuda)
    run = lambda u, d: gd.sample(u, 4, c.to(d).double(),
                                 init_noise=x_T.double(), step_noise=noise)
    host64, card64 = copy.deepcopy(unet).double(), card_unet.double()
    calls = []
    host64.register_forward_hook(
        lambda m, args, kwargs, out: calls.append((args, kwargs, out)),
        with_kwargs=True)
    h64 = run(host64, "cpu")
    c64 = run(card64, cuda)
    assert c64.device.type == "cuda" and _rel(h64, c64) <= 1e-9
    assert len(calls) == S
    card_unet = card64.float()
    f32 = torch.float32
    with torch.no_grad():
        for args, kwargs, out in calls:
            host = unet(*_to(args, "cpu", f32), **_to(kwargs, "cpu", f32))
            card = card_unet(*_to(args, cuda, f32), **_to(kwargs, cuda, f32))
            drift = _rel(out, host)
            assert _rel(host, card) <= 2 * drift + 1e-5, drift


def test_hoisted_sampler_on_the_card_equals_unhoisted(cuda):
    """b32 (where 'auto' hoists), the full ladder: the sampler of
    DiffusionHandPose at its defaults (seed 0) on its trunk's features of
    a synthetic RHD batch; hoisted vs unhoisted in float64 <= 1e-9 of
    range (the two routes round the time projections in other orders,
    which 200 steps carry far above that in float32).  A sampler of
    untrained weights can grow its state geometrically step by step (the
    JAX package's too, for some seeds), where the clip makes the sample
    chaotic; the default seed's does not."""
    import tempfile
    from handpose_tpu_torch.data.preprocess import (model_input,
                                                    preprocess_batch)
    from handpose_tpu_torch.data.rhd import RHDDataset, write_synthetic_rhd
    from handpose_tpu_torch.models import build_model
    cfg = Config(model_name="DiffusionHandPose", input_channels=3)
    with tempfile.TemporaryDirectory() as root:
        write_synthetic_rhd(root, "evaluation", n=32, seed=5)
        raw = RHDDataset(root, "evaluation",
                         cache_decoded=True).raw_batch(range(32)).to(cuda)
    net = build_model(cfg).to(cuda)
    with torch.no_grad():
        sample = preprocess_batch(raw, crop_size=256, sigma=25.0,
                                  switch_joint_order=True)
        c = net.features(model_input(sample, 3))
    model = net.diff_model.double()
    x_T = torch.randn(32, 1, 63, device=cuda,
                      generator=torch.Generator(device=cuda).manual_seed(5))
    outs = []
    for hoist in ("auto", False):
        model.sampler_hoist = hoist
        outs.append(model.sample(c.double(), init_noise=x_T.double()))
    assert model.hoists(32) is False
    assert _rel(outs[1], outs[0]) <= 1e-9


def test_diffusion_train_step_kernels_against_plain(cuda):
    """One fused train step of DiffusionHandPose (crop 64, B 4, 3
    channels, T 20 / S 10, injected draws) through K1, K2 and K3 against
    the same step with the plain versions, held to the plain step with
    the moment rows summed in reverse order: one launch of K1 and K3, 53
    of K2."""
    import tempfile
    from handpose_tpu_torch.data.rhd import RHDDataset, write_synthetic_rhd
    cfg = Config(model_name="DiffusionHandPose", input_channels=3,
                 input_img_shape=(64, 64), compute_dtype="float32",
                 num_timesteps=20, num_sampling_timesteps=10)
    with tempfile.TemporaryDirectory() as root:
        write_synthetic_rhd(root, "evaluation", n=4, seed=3)
        raw = RHDDataset(root, "evaluation",
                         cache_decoded=True).raw_batch(range(4)).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(6)
    draws = {"init_noise": torch.randn(4, 1, 63, generator=g, device=cuda),
             "diff_t": torch.randint(0, 20, (4,), generator=g, device=cuda),
             "diff_noise": torch.randn(4, 1, 63, generator=g, device=cuda)}
    (lk, gk, nk), (lp, gp, np_), (lq, gq, _) = _step_routes(
        cfg, raw, ("kernel", "plain", "plain, rows reversed"),
        model_draws=draws)
    assert nk == [1, 53, 1] and np_ == [0, 0, 0]
    assert sorted(lk) == ["loss", "loss_diffusion", "loss_xyz"]
    for k in lk:
        drift = abs(lq[k] - lp[k]) / abs(lp[k])
        np.testing.assert_allclose(lk[k], lp[k], rtol=1e-5 + 2 * drift,
                                   err_msg=k)
    err = float((gk - gp).norm() / gp.norm())
    drift = float((gq - gp).norm() / gp.norm())
    assert err <= 2 * drift + 1e-4, (err, drift)
