"""The port's import boundary and device defaults.

``handpose_tpu_torch`` imports neither JAX nor flax nor anything of
``handpose_tpu``, decodes images without loading the JAX package's
native decoder (``native/``), and its entry points default to the card
and raise when there is none.  A serving process that loads an exported
artifact imports the package's ops and loader, and no model, config or
training module.  Decided inside the tests, never at import.
"""

import os
import subprocess
import sys

import pytest
import torch
from _torch_port import port_worker_niced  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import handpose_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "handpose_tpu"))
new = ["handpose_tpu_torch.nn.diffusion", "handpose_tpu_torch.nn.diffusion2d",
       "handpose_tpu_torch.utils.fid",
       "handpose_tpu_torch.examples.diffusion1d",
       "handpose_tpu_torch.examples.diffusion2d",
       "handpose_tpu_torch.ops.camera", "handpose_tpu_torch.ops.patch",
       "handpose_tpu_torch.utils.vis", "handpose_tpu_torch.utils.device_info",
       "handpose_tpu_torch.infer.export",
       "handpose_tpu_torch.examples.serving_demo",
       "handpose_tpu_torch.parallel.distributed",
       "handpose_tpu_torch.parallel.mesh", "handpose_tpu_torch.train.nans",
       "handpose_tpu_torch.parallel.sharding",
       "handpose_tpu_torch.parallel.dryrun"]
assert all(n in names for n in new), names
print(len(names), bad)
"""


def test_port_imports_no_jax_flax_or_reference_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"          # niced and single-threaded
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    n, bad = res.stdout.strip().split(" ", 1)
    assert int(n) >= 25          # every module was imported
    assert bad == "[]"


_DECODE_PROBE = """
import sys
import numpy as np
from handpose_tpu_torch.data import imageio
path = sys.argv[1]
imageio.write_png(path, np.zeros((4, 6, 3), np.uint8))
assert imageio.decode_batch([path], 4, 6).shape == (1, 4, 6, 3)
maps = open("/proc/self/maps").read()
print("libimageio-" in maps, "fastdecode" in maps,
      sorted(m for m in sys.modules if m.split(".")[0] in
             ("cv2", "PIL", "jax", "handpose_tpu")))
"""


def test_port_decodes_with_its_own_library(tmp_path):
    """The port's codecs run from its own library: the JAX package's
    ``native/`` decoder is not loaded, and neither cv2 nor PIL is
    imported."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"          # niced and single-threaded
    res = subprocess.run(
        [sys.executable, "-c", _DECODE_PROBE, str(tmp_path / "a.png")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "True False []"


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    from handpose_tpu_torch import Config, resolve_device
    from handpose_tpu_torch.data.rhd import write_synthetic_rhd
    from handpose_tpu_torch.infer import (Evaluator, load_serving_model,
                                          serve)
    write_synthetic_rhd(str(tmp_path), "evaluation", n=2)
    cfg = Config(model_name="Hand3DPosePriorNetwork", input_channels=21,
                 dataset_root_dir=str(tmp_path), input_img_shape=(32, 32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Evaluator(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_serving_model(cfg)
    model = load_serving_model(cfg, device="cpu")
    from handpose_tpu_torch.data.rhd import RHDDataset
    raw = RHDDataset(str(tmp_path), "evaluation").raw_batch([0, 1])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(model, raw, cfg)
    xyz, uv = serve(model, raw, cfg, device="cpu")
    assert xyz.shape == (2, 21, 3) and torch.isfinite(xyz).all()


_LOAD_PROBE = """
import sys
import torch
from handpose_tpu_torch.infer.export import load_exported_file
fn = load_exported_file(sys.argv[1])
xyz, uv = fn(torch.zeros(1, 32, 32, 21), torch.eye(3)[None] * 100,
             torch.ones(1, 1), torch.tensor([[0.0, 0.0, 0.6]]))
assert xyz.shape == (1, 21, 3) and uv.shape == (1, 21, 2)
print(sorted(m for m in sys.modules if m.startswith("handpose_tpu")))
"""


def test_loading_an_artifact_imports_no_model_config_or_train_module(
        tmp_path):
    from handpose_tpu_torch import Config
    from handpose_tpu_torch.infer.export import export_forward, save_exported
    cfg = Config(model_name="Hand3DPosePriorNetwork", input_channels=21,
                 input_img_shape=(32, 32), compute_dtype="float32")
    path = str(tmp_path / "fwd.pt2")
    save_exported(path, export_forward(cfg, None, 1, device="cpu"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"          # niced and single-threaded
    res = subprocess.run([sys.executable, "-c", _LOAD_PROBE, path],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=240)
    assert res.returncode == 0, res.stderr
    modules = eval(res.stdout.strip().splitlines()[-1])
    assert "handpose_tpu_torch.ops.scoremap_cuda" in modules
    heavy = [m for m in modules if m.split(".")[:2][-1] in (
        "models", "config", "train", "nn", "data", "convert", "losses")]
    assert heavy == [] and "handpose_tpu" not in modules
