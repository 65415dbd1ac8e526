"""The port's CUDA kernels on the card, held to their plain versions.

K1 (scoremap), K2 (BatchNorm moments, up to the ResNet-50 trunk's
C = 2048 in both dtypes) and K3 (stem max-pool backward), the RHD and
InterHand2.6M preprocessing on the card against the host, the train
steps of the flagship and of a ResNet-50 model routed through the
kernels against the same step with the plain versions substituted, and
the space-to-depth stem against the k3s2 stem.

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
        raw = RHDDataset(root, "evaluation",
                         cache_decoded=True).raw_batch(range(4))
    host = serve(load_serving_model(cfg, device="cpu"), raw, cfg,
                 device="cpu")
    before = scoremap_cuda.KERNEL.launches
    card = serve(load_serving_model(cfg, device=cuda), raw, cfg)
    assert scoremap_cuda.KERNEL.launches == before + 1
    for a, b in zip(host, card):
        err = float((b.cpu() - a).abs().max() / a.abs().max())
        assert err <= 1e-4


def test_augmented_preprocess_on_the_card_matches_the_host(cuda):
    """All six augmentations on the card, with draws made there from a
    card generator and handed to the host path too: every key of the
    sample dict within float32 rounding (K1 against the plain render on
    jittered coordinates, crop windows exact), one K1 launch."""
    from handpose_tpu_torch.data.preprocess import (draw_augmentations,
                                                    preprocess_batch)
    from handpose_tpu_torch.data.rhd import RHDDataset, write_synthetic_rhd
    import tempfile
    flags = dict(coord_uv_noise=True, hue_aug=True, crop_center_noise=True,
                 crop_scale_noise=True, crop_offset_noise=True,
                 scoremap_dropout=True)
    with tempfile.TemporaryDirectory() as root:
        write_synthetic_rhd(root, "evaluation", n=8, seed=2)
        raw = RHDDataset(root, "evaluation",
                         cache_decoded=True).raw_batch(range(8))
    host_raw = raw.to("cpu")
    card_raw = raw.to(cuda)
    g = torch.Generator(device=cuda).manual_seed(5)
    draws = draw_augmentations(set(flags), (8, (320, 320), (64, 64), 0), g)
    before = scoremap_cuda.KERNEL.launches
    card = preprocess_batch(card_raw, crop_size=64, draws=draws, **flags)
    torch.cuda.synchronize()
    assert scoremap_cuda.KERNEL.launches == before + 1
    host = preprocess_batch(
        host_raw, crop_size=64, **flags,
        draws=type(draws)(*(None if d is None else d.cpu() for d in draws)))
    for k, a in host.items():
        b = card[k].cpu()
        assert b.dtype == a.dtype and b.shape == a.shape, k
        if a.dtype.is_floating_point:
            assert float((b - a).abs().max()) <= 1e-5 * max(
                1.0, float(a.abs().max())), k
        else:
            assert torch.equal(a, b), k


def test_interhand_preprocess_on_the_card_matches_the_host(cuda):
    """InterHand2.6M frames of two sizes, padded, decoded from the port's
    JPEGs: both augmentations on the card with card-made draws, handed
    to the host path too; every key within float32 rounding, integers,
    booleans and right_hand_mask exact, one K1 launch."""
    from handpose_tpu_torch.data.interhand import (InterHandDataset,
                                                   write_synthetic_interhand)
    from handpose_tpu_torch.data.preprocess import (
        draw_augmentations, preprocess_interhand_batch)
    import tempfile
    flags = dict(coord_uv_noise=True, scoremap_dropout=True)
    with tempfile.TemporaryDirectory() as root:
        write_synthetic_interhand(root, "val", n=6, seed=3,
                                  image_sizes=[(96, 64), (64, 96)])
        raw = InterHandDataset(root, "val",
                               pad_to="auto").raw_batch(range(6))
    host_raw, card_raw = raw.to("cpu"), raw.to(cuda)
    g = torch.Generator(device=cuda).manual_seed(6)
    draws = draw_augmentations(set(flags), (6, (96, 96), (64, 64), 0), g)
    before = scoremap_cuda.KERNEL.launches
    card = preprocess_interhand_batch(card_raw, crop_size=64, draws=draws,
                                      **flags)
    torch.cuda.synchronize()
    assert scoremap_cuda.KERNEL.launches == before + 1
    host = preprocess_interhand_batch(
        host_raw, crop_size=64, **flags,
        draws=type(draws)(*(None if d is None else d.cpu() for d in draws)))
    for k, a in host.items():
        b = card[k].cpu()
        assert b.dtype == a.dtype and b.shape == a.shape, k
        if a.dtype.is_floating_point and k != "right_hand_mask":
            assert float((b - a).abs().max()) <= 1e-5 * max(
                1.0, float(a.abs().max())), k
        else:
            assert torch.equal(a, b), k


def _moment_inputs(N, C, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(N, C, generator=g, device=dev) + 0.5).to(dtype)
    shift = torch.randn(C, generator=g, device=dev) * 0.1 + 0.25
    return x, shift


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(4100, 64), (1025, 512), (16384, 512),
                                   (17, 64), (1, 64), (333, 72), (50, 5),
                                   (16384, 2048), (65536, 1024)])
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
                                        ((1, 8, 1, 1), False),
                                        ((2, 16, 31, 17), True),
                                        ((2, 16, 33, 15), False),
                                        ((2, 3, 9, 7), True),
                                        ((2, 520, 9, 7), False)])
def test_pool_bwd_kernel_equals_plain(cuda, shape, ties, dtype):
    """Both sum a pixel's terms in float32 in one order and round once:
    equal exactly.  One launch, counted under its variant."""
    x, dy = _pool_inputs(shape, dtype, cuda, seed=shape[2], ties=ties)
    kernel = pool_bwd_cuda.KERNEL
    before, by_variant = kernel.launches, dict(kernel.by_variant)
    dx = pool_bwd_cuda.max_pool_3x3s2p1_bwd_cuda(x, dy)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    variant = "tiled_sync" if dtype == torch.bfloat16 and shape[1] % 2 \
        else "tiled"
    assert kernel.by_variant[variant] == by_variant.get(variant, 0) + 1
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
        raw = RHDDataset(root, "evaluation",
                         cache_decoded=True).raw_batch(range(4)).to(cuda)
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


def _step_routes(cfg, raw, routes, **step_kw):
    """One fused train step of ``cfg``'s model from one seeded state per
    route ('kernel', 'plain', 'plain, rows reversed': the plain versions
    with the BN moments' rows summed in reverse order), ``step_kw`` (e.g.
    a stochastic model's ``model_draws``) passed to each: (losses, the
    gradient as one vector, the kernels' launches) each."""
    import copy
    from unittest import mock
    from handpose_tpu_torch.data import preprocess as pp_mod
    from handpose_tpu_torch.models import build_model
    from handpose_tpu_torch.train import (create_train_state,
                                          make_fused_train_step)
    pp = dict(crop_size=cfg.crop_size, sigma=cfg.sigma,
              switch_joint_order=True)
    base = build_model(cfg).to(raw.image.device)
    kernels = (scoremap_cuda.KERNEL, moments_cuda.KERNEL,
               pool_bwd_cuda.KERNEL)
    sums = {"kernel": moments._moments, "plain": moments.shifted_moments,
            "plain, rows reversed": lambda x, sh: moments.shifted_moments(
                x.flip(0), sh)}
    runs = []
    for route in routes:
        plain = route != "kernel"
        model = copy.deepcopy(base)
        state = create_train_state(model, cfg)
        step = make_fused_train_step(model, cfg, pp_mod.preprocess_batch, pp)
        counts = [k.launches for k in kernels]
        with mock.patch.object(pp_mod, "render_gaussian_maps_cuda",
                               heatmap.render_gaussian_maps
                               if plain else
                               scoremap_cuda.render_gaussian_maps_cuda), \
                mock.patch.object(moments, "_moments", sums[route]), \
                mock.patch.object(pooling, "_pool_bwd",
                                  pooling.max_pool_3x3s2p1_bwd
                                  if plain else pooling._pool_bwd):
            _, losses = step(state, raw, **step_kw)
        torch.cuda.synchronize()
        grad = torch.cat([state.optimizer.state[p]["exp_avg"].flatten()
                          for p in model.parameters()]) / 0.1
        runs.append(({k: float(v) for k, v in losses.items()}, grad,
                     [k.launches - c for k, c in zip(kernels, counts)]))
    return runs


def test_resnet50_train_step_kernels_against_plain(cuda):
    """One fused train step of OnlyThreeDimHandPose (ResNet-50 at full
    depth and width, crop 64, B 4, float32, TF32 off) through K1, K2 and
    K3, against the same step from the same state with the plain versions
    substituted.  The float32 gradient of 16 Bottleneck blocks of
    train-mode BatchNorm is ill-conditioned (on the host, JAX's own
    gradient moves ~7e-2 of its largest element when the batch is
    reversed), so the yardstick is the plain step with the moment rows
    summed in reverse order: kernels vs plain within twice that drift
    (+ 1e-5 for the losses, + 1e-4 for the gradient's norm).  One launch
    of K1 and K3 and 53 of K2."""
    import tempfile
    from handpose_tpu_torch.data.rhd import RHDDataset, write_synthetic_rhd
    cfg = Config(model_name="OnlyThreeDimHandPose", input_channels=3,
                 input_img_shape=(64, 64), compute_dtype="float32")
    with tempfile.TemporaryDirectory() as root:
        write_synthetic_rhd(root, "evaluation", n=4, seed=1)
        raw = RHDDataset(root, "evaluation",
                         cache_decoded=True).raw_batch(range(4)).to(cuda)
    (lk, gk, nk), (lp, gp, np_), (lq, gq, _) = _step_routes(
        cfg, raw, ("kernel", "plain", "plain, rows reversed"))
    assert nk == [1, 53, 1] and np_ == [0, 0, 0]
    for k in lk:
        drift = abs(lq[k] - lp[k]) / abs(lp[k])
        np.testing.assert_allclose(lk[k], lp[k], rtol=1e-5 + 2 * drift)
    err = float((gk - gp).norm() / gp.norm())
    drift = float((gq - gp).norm() / gp.norm())
    assert err <= 2 * drift + 1e-4, (err, drift)


def test_s2d_stem_equals_k3s2_stem_on_the_card(cuda):
    """The ResNet-50 trunk with the same weights under both stems,
    float32, TF32 off, deterministic cuDNN, b4 at crop 64: eval and
    train outputs to 1e-5 of range.  ``k3s2_s2d`` builds the same conv
    as ``k3s2`` (the s2d re-layout is the TPU's), so no float32 sum
    order separates them, not even in the ill-conditioned train mode."""
    from handpose_tpu_torch.models.zoo import init_parameters
    from handpose_tpu_torch.nn.resnet import ExtendedResNet50
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.rand((4, 3, 64, 64), generator=g, device=cuda).contiguous(
        memory_format=torch.channels_last)
    weights = init_parameters(ExtendedResNet50(3), seed=4).state_dict()
    trunks = {}
    for stem in ("k3s2", "k3s2_s2d"):
        trunks[stem] = ExtendedResNet50(3, stem=stem).to(cuda)
        trunks[stem].load_state_dict(weights)

    def rel(a, b):
        return float((a - b).abs().max() / a.abs().max())

    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        with torch.no_grad():
            ev = [trunks[s].eval()(x) for s in ("k3s2", "k3s2_s2d")]
            tr = [trunks[s].train()(x) for s in ("k3s2", "k3s2_s2d")]
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = flags
    assert rel(*ev) <= 1e-5, rel(*ev)
    assert rel(*tr) <= 1e-5, rel(*tr)
