"""The port's CUDA kernel on the card, held to its plain version.

Marked ``gpu``; each test skips when no CUDA device is present.  This
file imports no JAX, so it also runs where JAX is not installed, without
the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from handpose_tpu_torch import Config
from handpose_tpu_torch.ops import heatmap, scoremap_cuda

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
