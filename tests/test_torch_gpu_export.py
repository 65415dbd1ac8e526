"""The serving artifacts on the card: the fused pipeline exported and
replayed there against eager serving, with K1 launched inside it.

The flagship at crop 64, batch 4 (bf16 compute, the seeded init), from a
seeded RHD raw batch: the exported program, after a save/load round
trip, launches the scoremap kernel once a call and the eval BatchNorm
kernel once per BatchNorm, 40 a call (their registered operators, which
the program records), and gives eager ``serve``'s (xyz, uv) bit for bit;
the scoremap operator itself
dispatches a CUDA tensor to the kernel and a host tensor to the plain
render.  Marked ``gpu``; each test skips when no CUDA device is present.
This file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_export.py
"""

import io

import numpy as np
import pytest
import torch

from handpose_tpu_torch import Config
from handpose_tpu_torch.data.preprocess import RawBatch
from handpose_tpu_torch.infer import export, load_serving_model, serve
from handpose_tpu_torch.ops import bn_apply_cuda, heatmap, scoremap_cuda

pytestmark = pytest.mark.gpu
FIELDS = ("image", "mask", "keypoint_uv", "keypoint_vis", "keypoint_xyz",
          "camera_K")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _raw(B, S, seed):
    rng = np.random.default_rng(seed)
    K = np.tile(np.asarray([[S, 0, S / 2], [0, S, S / 2], [0, 0, 1]],
                           np.float32), (B, 1, 1))
    xyz = (rng.normal(size=(B, 42, 3)) * 0.05 + [0, 0, 0.6]).astype(
        np.float32)
    uvw = np.einsum("bij,bkj->bki", K, xyz)
    return RawBatch(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        rng.integers(0, 255, (B, S, S, 3), dtype=np.uint8),
        rng.integers(0, 34, (B, S, S), dtype=np.uint8),
        (uvw[..., :2] / uvw[..., 2:3]).astype(np.float32),
        (rng.uniform(size=(B, 42)) > 0.3).astype(np.float32), xyz, K)))


def test_exported_pipeline_on_the_card_equals_eager_serving(cuda):
    cfg = Config(model_name="Hand3DPosePriorNetwork", input_channels=21,
                 input_img_shape=(64, 64))
    raw = _raw(4, 80, 3).to(cuda)
    blob = export.export_fused_pipeline(cfg, None, 4, (80, 80), device=cuda)
    fn = export.load_exported_pipeline(blob)
    before = scoremap_cuda.KERNEL.launches
    bn_before = bn_apply_cuda.KERNEL.launches
    xyz, uv = fn(*raw)
    torch.cuda.synchronize()
    assert scoremap_cuda.KERNEL.launches == before + 1
    assert bn_apply_cuda.KERNEL.launches == bn_before + 40
    assert xyz.device.type == "cuda"
    want = serve(load_serving_model(cfg, device=cuda), raw, cfg, cuda)
    assert torch.equal(xyz, want[0]) and torch.equal(uv, want[1])
    program = torch.export.load(io.BytesIO(blob))
    op = torch.ops.handpose_tpu_torch.render_gaussian_maps.default
    assert sum(n.target == op for n in program.graph.nodes) == 1
    bn_op = torch.ops.handpose_tpu_torch.bn_eval_apply.default
    assert sum(n.target == bn_op for n in program.graph.nodes) == 40


def test_the_registered_op_dispatches_by_device(cuda):
    rng = np.random.default_rng(4)
    coords = torch.from_numpy(rng.uniform(-5, 70, (3, 21, 2)).astype(
        np.float32))
    vis = torch.from_numpy(rng.uniform(size=(3, 21)) > 0.3)
    op = torch.ops.handpose_tpu_torch.render_gaussian_maps
    before = scoremap_cuda.KERNEL.launches
    host = op(coords, vis, 64, 64, 25.0)
    assert scoremap_cuda.KERNEL.launches == before
    card = op(coords.to(cuda), vis.to(cuda), 64, 64, 25.0)
    torch.cuda.synchronize()
    assert scoremap_cuda.KERNEL.launches == before + 1
    assert torch.equal(host, heatmap.render_gaussian_maps(coords, (64, 64),
                                                          25.0, vis))
    assert float((card.cpu() - host).abs().max()) <= 1e-6
