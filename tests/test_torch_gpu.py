"""The port's CUDA kernels on the card, held to their plain versions.

K1 (scoremap), K2 (BatchNorm moments) and K3 (stem max-pool backward),
and the train step routed through the kernels against the same step with
the plain versions substituted.

Marked ``gpu``; each test skips when no CUDA device is present.  This
file imports no JAX, so it also runs where JAX is not installed, without
the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from handpose_tpu_torch import Config
from handpose_tpu_torch.ops import (heatmap, moments, moments_cuda,
                                    pool_bwd_cuda, pooling, scoremap_cuda)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cases(B, K, H, W, seed):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-20, max(H, W) + 20, (B, K, 2)).astype(np.float32)
    edges = [(0, 5), (H - 1, 5), (1, W - 1), (-0.5, 3), (-7, -2),
             (H - 1.5, W - 1.5)][:K]
    coords[0, :len(edges)] = edges
    vis = rng.uniform(size=(B, K)) > 0.25
    return torch.from_numpy(coords), torch.from_numpy(vis)


@pytest.mark.parametrize("shape", [(4, 21, 256, 256), (2, 21, 320, 240),
                                   (2, 5, 37, 53), (1, 3, 1, 1)])
def test_scoremap_kernel_matches_plain(cuda, shape):
    B, K, H, W = shape
    coords, vis = _cases(B, K, H, W, seed=H)
    coords, vis = coords.to(cuda), vis.to(cuda)
    before = scoremap_cuda.KERNEL.launches
    out = scoremap_cuda.render_gaussian_maps_cuda(coords, (H, W), 25.0, vis)
    torch.cuda.synchronize()
    assert scoremap_cuda.KERNEL.launches == before + 1
    ref = heatmap.render_gaussian_maps(coords, (H, W), 25.0, vis)
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert float((out - ref).abs().max()) <= 1e-6


def test_scoremap_kernel_rejects_bad_inputs(cuda):
    coords, vis = _cases(2, 21, 64, 64, seed=0)
    coords, vis = coords.to(cuda), vis.to(cuda)
    with pytest.raises(ValueError):
        scoremap_cuda.render_gaussian_maps_cuda(coords.double(), (64, 64),
                                                25.0, vis)
    with pytest.raises(ValueError):
        scoremap_cuda.render_gaussian_maps_cuda(coords, (64, 64), 25.0,
                                                vis.float())
    with pytest.raises(ValueError):
        scoremap_cuda.render_gaussian_maps_cuda(coords, (64, 64), 25.0,
                                                vis[:1])


def test_serving_path_runs_the_kernel(cuda):
    """Preprocess + forward on the card against the host path (float32,
    TF32 off): one kernel launch per batch."""
    from handpose_tpu_torch.data.rhd import RHDDataset, write_synthetic_rhd
    from handpose_tpu_torch.infer import load_serving_model, serve
    import tempfile
    cfg = Config(model_name="Hand3DPosePriorNetwork", input_channels=21,
                 input_img_shape=(64, 64), compute_dtype="float32")
    with tempfile.TemporaryDirectory() as root:
        write_synthetic_rhd(root, "evaluation", n=4, seed=1)
        raw = RHDDataset(root, "evaluation").raw_batch(range(4))
    host = serve(load_serving_model(cfg, device="cpu"), raw, cfg,
                 device="cpu")
    before = scoremap_cuda.KERNEL.launches
    card = serve(load_serving_model(cfg, device=cuda), raw, cfg)
    assert scoremap_cuda.KERNEL.launches == before + 1
    for a, b in zip(host, card):
        err = float((b.cpu() - a).abs().max() / a.abs().max())
        assert err <= 1e-4


def _moment_inputs(N, C, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(N, C, generator=g, device=dev) + 0.5).to(dtype)
    shift = torch.randn(C, generator=g, device=dev) * 0.1 + 0.25
    return x, shift


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(4100, 64), (1025, 512), (16384, 512),
                                   (17, 64), (1, 64), (333, 72), (50, 5)])
def test_moments_kernel_matches_plain(cuda, shape, dtype):
    """Each sum to 1e-5 of the channel's sum of |x - shift| (the scale of
    a float32 sum's rounding), bit-identical over two runs."""
    N, C = shape
    x, shift = _moment_inputs(N, C, dtype, cuda, seed=N + C)
    for sh in (torch.zeros_like(shift), shift):
        before = moments_cuda.KERNEL.launches
        s, ss = moments_cuda.shifted_moments_cuda(x, sh)
        s2, ss2 = moments_cuda.shifted_moments_cuda(x, sh)
        torch.cuda.synchronize()
        assert moments_cuda.KERNEL.launches == before + 2
        assert torch.equal(s, s2) and torch.equal(ss, ss2)
        ps, pss = moments.shifted_moments(x, sh)
        d = x.to(torch.float32) - sh
        for out, ref, scale in ((s, ps, d.abs().sum(0)), (ss, pss, pss)):
            assert bool(((out - ref).abs() <= 1e-5 * scale + 1e-30).all())


def test_moments_kernel_rejects_bad_inputs(cuda):
    x, shift = _moment_inputs(64, 64, torch.bfloat16, cuda, seed=0)
    kernel = moments_cuda.shifted_moments_cuda
    with pytest.raises(ValueError):
        kernel(x.t(), shift)                          # not a row view
    with pytest.raises(ValueError):
        kernel(x.double(), shift)
    with pytest.raises(ValueError):
        kernel(x, shift.double())
    with pytest.raises(ValueError):
        kernel(x, shift[:32])


def _pool_inputs(shape, dtype, dev, seed, ties=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    N, C, H, W = shape
    if ties:
        x = torch.randint(-2, 3, shape, generator=g, device=dev).float()
    else:
        x = torch.randn(shape, generator=g, device=dev)
    x = torch.relu(x).to(dtype).contiguous(memory_format=torch.channels_last)
    dy = torch.randn((N, C, (H + 1) // 2, (W + 1) // 2), generator=g,
                     device=dev).to(dtype).contiguous(
                         memory_format=torch.channels_last)
    return x, dy


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,ties", [((4, 64, 32, 32), False),
                                        ((4, 64, 32, 32), True),
                                        ((2, 64, 33, 17), False),
                                        ((3, 5, 9, 7), True),
                                        ((1, 8, 1, 1), False)])
def test_pool_bwd_kernel_equals_plain(cuda, shape, ties, dtype):
    """Both sum a pixel's terms in float32 in one order and round once:
    equal exactly."""
    x, dy = _pool_inputs(shape, dtype, cuda, seed=shape[2], ties=ties)
    before = pool_bwd_cuda.KERNEL.launches
    dx = pool_bwd_cuda.max_pool_3x3s2p1_bwd_cuda(x, dy)
    torch.cuda.synchronize()
    assert pool_bwd_cuda.KERNEL.launches == before + 1
    assert dx.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(dx, pooling.max_pool_3x3s2p1_bwd(x, dy))


def test_pool_bwd_autograd_converts_an_nchw_gradient(cuda):
    x, dy = _pool_inputs((2, 64, 16, 16), torch.bfloat16, cuda, seed=1)
    xr = x.clone().requires_grad_()
    y = pooling.stem_max_pool(xr)
    y.backward(dy.contiguous())                        # NCHW-contiguous
    assert torch.equal(xr.grad, pooling.max_pool_3x3s2p1_bwd(x, dy))
    with pytest.raises(ValueError, match="channels_last"):
        pool_bwd_cuda.max_pool_3x3s2p1_bwd_cuda(x, dy.contiguous())


def test_train_step_kernels_against_plain(cuda):
    """One fused train step (crop 64, B 4, float32, TF32 off) through K1,
    K2 and K3, against the same step from the same state with the plain
    versions substituted: losses rtol 1e-5, parameters after the Adam
    step to 2 lr (an element whose gradient is at rounding level may
    step either way) with 99% of them to 1e-3 lr."""
    import copy
    import tempfile
    from unittest import mock
    from handpose_tpu_torch.data import preprocess as pp_mod
    from handpose_tpu_torch.data.rhd import RHDDataset, write_synthetic_rhd
    from handpose_tpu_torch.models import build_model
    from handpose_tpu_torch.train import (create_train_state,
                                          make_fused_train_step)
    cfg = Config(model_name="Hand3DPosePriorNetwork", input_channels=21,
                 input_img_shape=(64, 64), compute_dtype="float32")
    with tempfile.TemporaryDirectory() as root:
        write_synthetic_rhd(root, "evaluation", n=4, seed=1)
        raw = RHDDataset(root, "evaluation").raw_batch(range(4)).to(cuda)
    pp = dict(crop_size=64, sigma=cfg.sigma, switch_joint_order=True)
    base = build_model(cfg).to(cuda)
    runs = []
    for plain in (False, True):
        model = copy.deepcopy(base)
        state = create_train_state(model, cfg)
        step = make_fused_train_step(model, cfg, pp_mod.preprocess_batch, pp)
        counts = [k.launches for k in (scoremap_cuda.KERNEL,
                                       moments_cuda.KERNEL,
                                       pool_bwd_cuda.KERNEL)]
        with mock.patch.object(pp_mod, "render_gaussian_maps_cuda",
                               heatmap.render_gaussian_maps
                               if plain else
                               scoremap_cuda.render_gaussian_maps_cuda), \
                mock.patch.object(moments, "_moments",
                                  moments.shifted_moments
                                  if plain else moments._moments), \
                mock.patch.object(pooling, "_pool_bwd",
                                  pooling.max_pool_3x3s2p1_bwd
                                  if plain else pooling._pool_bwd):
            _, losses = step(state, raw)
        torch.cuda.synchronize()
        rose = [k.launches - c for k, c in zip(
            (scoremap_cuda.KERNEL, moments_cuda.KERNEL,
             pool_bwd_cuda.KERNEL), counts)]
        assert rose == ([0, 0, 0] if plain else [1, 40, 2])
        runs.append((losses, model))
    (lk, mk), (lp, mp) = runs
    for k in lk:
        np.testing.assert_allclose(float(lk[k]), float(lp[k]), rtol=1e-5)
    lr = cfg.lr
    with torch.no_grad():
        diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(
            mk.parameters(), mp.parameters())])
    assert float(diffs.max()) <= 2 * lr * 1.001
    assert float((diffs > 1e-3 * lr).float().mean()) <= 0.01
