"""The port's visualisation, the inference CLI's run, overlay and export
flags, profiling, the build cache and the serving demo, on the host.

* ``utils/vis.py`` against ``handpose_tpu.utils.vis``, which draws with
  cv2: the keypoint and skeleton drawing pixel for pixel (points off the
  image, negative, half a pixel apart, both joint orders, partly visible
  hands), ``to_uint8_image``, ``load_skeleton``, ``save_scoremap_grid``,
  ``save_mesh_obj`` and ``save_image`` (PNG exactly; JPEG within its
  quantisation);
* the inference CLI (``python -m handpose_tpu_torch.infer``'s ``main``)
  on a flagship run trained here (RHD, crop 32, float32): ``--from_run``
  with explicit dataset flags winning over the run's config
  (``tests/test_evaluator.py:202``), falling back to ``checkpoint/``,
  exiting without weights; ``--visualize_dir`` writing the named
  overlays, drawn as the JAX package draws them from the uv of the
  ``is_inference=True`` branch; ``--export``;
* ``profile_epoch`` writing a trace, ``compilation_cache_dir`` moving
  the native build directory, ``device_info`` on the host;
* the serving demo's ``--fresh`` and ``--fused`` runs.
"""

import json
import os
import shutil
import sys

import cv2
import numpy as np
import pytest
import torch

from handpose_tpu.utils import vis as jvis
from handpose_tpu_torch.config import Config
from handpose_tpu_torch.data import imageio
from handpose_tpu_torch.data.rhd import write_synthetic_rhd
from handpose_tpu_torch.infer import Evaluator, export
from handpose_tpu_torch.infer import __main__ as infer_cli
from handpose_tpu_torch.infer.evaluator import inference_uv
from handpose_tpu_torch.models import build_model
from handpose_tpu_torch.ops import cuda_build
from handpose_tpu_torch.train import Worker
from handpose_tpu_torch.utils import device_info, vis

import _torch_port  # noqa: F401  (one torch thread)

N, BATCH, CROP = 8, 4, 32
SMALL = ["--device", "cpu", "--set", f"input_img_shape={CROP},{CROP}",
         "--set", "compute_dtype=float32"]


def _uv(rng, lo, hi):
    return rng.uniform(lo, hi, (21, 2)).astype(np.float32)


def _draw_case(name):
    """(image, uv, vis, joint order) of a drawing case."""
    rng = np.random.default_rng(DRAW_CASES.index(name))
    img = rng.integers(0, 255, (40, 56, 3), dtype=np.uint8)
    vis_ = None
    order = "mano"
    if name == "off_image":
        uv = _uv(rng, -30, 90)
    elif name == "negative":
        uv = _uv(rng, -30, 20)
    elif name == "half_pixel":
        # .5 coordinates round half to even; neighbours half a pixel apart
        uv = (rng.integers(2, 38, (21, 2)) + 0.5).astype(np.float32)
        uv[1::2] = uv[::2][:10] + 0.5
    elif name == "rhd_order":
        uv, order = _uv(rng, 0, 40), "rhd"
    elif name == "partly_visible":
        uv, vis_ = _uv(rng, -5, 50), rng.uniform(size=(21, 1)) > 0.4
    else:
        uv = _uv(rng, 0, 40)
    return img, uv, vis_, order


DRAW_CASES = ["in_image", "off_image", "negative", "half_pixel",
              "rhd_order", "partly_visible"]


@pytest.mark.parametrize("case", DRAW_CASES)
def test_draw_keypoints_equals_cv2(case):
    img, uv, v, order = _draw_case(case)
    want = jvis.draw_keypoints(img, uv, v, (0, 255, 0), order)
    got = vis.draw_keypoints(img, uv, v, (0, 255, 0), order)
    np.testing.assert_array_equal(got, want)
    assert (got != img).any()
    np.testing.assert_array_equal(img, _draw_case(case)[0])   # a copy


def test_plot_pred_vs_gt_equals_cv2():
    img, gt, v, _ = _draw_case("partly_visible")
    pred = gt + np.random.default_rng(1).normal(0, 3, gt.shape)
    np.testing.assert_array_equal(vis.plot_pred_vs_gt(img, pred, gt, v),
                                  jvis.plot_pred_vs_gt(img, pred, gt, v))


def test_lines_and_circles_equal_cv2_over_random_cases():
    rng = np.random.default_rng(2)
    for _ in range(2000):
        h, w = (int(v) for v in rng.integers(1, 30, 2))
        img = np.zeros((h, w, 3), np.uint8)
        p1, p2 = (tuple(int(v) for v in rng.integers(-50, 80, 2))
                  for _ in range(2))
        want = cv2.line(img.copy(), p1, p2, (0, 255, 0), 1)
        got = img.copy()
        vis.draw_line(got, p1, p2, np.array((0, 255, 0), np.uint8))
        np.testing.assert_array_equal(got, want, err_msg=f"{p1} {p2}")
        c = tuple(int(v) for v in rng.integers(-4, 34, 2))
        r = int(rng.integers(0, 5))
        want = cv2.circle(img.copy(), c, r, (255, 0, 0), -1)
        got = img.copy()
        vis.draw_filled_circle(got, c, r, np.array((255, 0, 0), np.uint8))
        np.testing.assert_array_equal(got, want, err_msg=f"{c} {r}")


def test_to_uint8_image_and_load_skeleton(tmp_path):
    img = np.random.default_rng(3).uniform(-0.7, 0.7, (8, 9, 3))
    np.testing.assert_array_equal(vis.to_uint8_image(img),
                                  jvis.to_uint8_image(img))
    path = tmp_path / "skeleton.txt"
    path.write_text("# joint_name joint_id parent_id\n" + "".join(
        f"j{i} {i} {i - 1 if i % 4 else -1}\n" for i in range(8)))
    assert vis.load_skeleton(str(path), 8) == jvis.load_skeleton(str(path),
                                                                 8)


def test_save_scoremap_grid_and_mesh_obj_as_jax(tmp_path):
    maps = np.random.default_rng(4).uniform(-0.1, 1.2, (21, 12, 10))
    vis.save_scoremap_grid(maps, str(tmp_path / "port.png"))
    jvis.save_scoremap_grid(maps, str(tmp_path / "jax.png"))
    a = cv2.imread(str(tmp_path / "port.png"), cv2.IMREAD_UNCHANGED)
    b = cv2.imread(str(tmp_path / "jax.png"), cv2.IMREAD_UNCHANGED)
    assert a.shape == (36, 70)
    np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(5)
    verts, faces = rng.normal(size=(30, 3)), rng.integers(0, 30, (12, 3))
    vis.save_mesh_obj(verts, faces, str(tmp_path / "port.obj"))
    jvis.save_mesh_obj(verts, faces, str(tmp_path / "jax.obj"))
    assert (tmp_path / "port.obj").read_text() == \
        (tmp_path / "jax.obj").read_text()


def test_save_image_png_exact_and_jpeg_within_quantisation(tmp_path):
    img, uv, _, _ = _draw_case("in_image")
    img = vis.draw_keypoints(np.zeros_like(img) + 90, uv)
    vis.save_image(str(tmp_path / "a.png"), img)
    jvis.save_image(str(tmp_path / "b.png"), img)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "a.png")),
                                  cv2.imread(str(tmp_path / "b.png")))
    # JPEG is lossy and 4:2:0 smears the 1-pixel green lines: the port's
    # file loses no more than cv2's at the same quality
    vis.save_image(str(tmp_path / "a.jpg"), img)
    jvis.save_image(str(tmp_path / "b.jpg"), img)
    back = imageio.decode_batch([str(tmp_path / "a.jpg")], 40, 56)[0]
    ref = cv2.imread(str(tmp_path / "b.jpg"))[:, :, ::-1]
    err = np.abs(back.astype(float) - img).mean()
    assert err <= 1.1 * np.abs(ref.astype(float) - img).mean() + 0.5
    with pytest.raises(ValueError, match="bmp"):
        vis.save_image(str(tmp_path / "a.bmp"), img)


def test_3d_plots_write_files_and_name_matplotlib_when_missing(
        tmp_path, monkeypatch):
    rng = np.random.default_rng(6)
    vis.plot_3d_keypoints(rng.normal(size=(21, 3)), str(tmp_path / "k.png"))
    vis.plot_mesh(rng.normal(size=(30, 3)), rng.integers(0, 30, (12, 3)),
                  str(tmp_path / "m.png"), joints=rng.normal(size=(21, 3)))
    assert (tmp_path / "k.png").stat().st_size > 0
    assert (tmp_path / "m.png").stat().st_size > 0
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        vis.plot_3d_keypoints(rng.normal(size=(21, 3)), str(tmp_path / "x"))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("rhd"))
    write_synthetic_rhd(root, "training", n=N, seed=7)
    write_synthetic_rhd(root, "evaluation", n=N, seed=8)
    return root


@pytest.fixture(scope="module")
def run(tree, tmp_path_factory):
    """(run_dir, best validation MPJPE) of one flagship epoch (two steps,
    validation over the split): config.json, checkpoint/ and
    model_best/."""
    logs = tmp_path_factory.mktemp("logs")
    cfg = Config(model_name="Hand3DPosePriorNetwork", input_channels=21,
                 dataset_name="RHD", dataset_root_dir=tree,
                 batch_size=BATCH, infer_batch_size=BATCH, max_epoch=1,
                 input_img_shape=(CROP, CROP), compute_dtype="float32",
                 log_every_steps=0, save_log_dir=str(logs))
    w = Worker(cfg, device="cpu")
    best = w.run()
    yield os.path.abspath(w.run_dir), best
    shutil.rmtree(logs, ignore_errors=True)


def _run_like(run_dir, dst, ckpts, cfg_edit=None):
    """A run directory at ``dst`` with ``run_dir``'s config.json (edited
    by ``cfg_edit``) and links to the checkpoints named in ``ckpts``."""
    os.makedirs(dst)
    with open(os.path.join(run_dir, "config.json")) as f:
        cfg = Config.from_json(f.read())
    if cfg_edit:
        cfg = cfg.replace(**cfg_edit)
    with open(os.path.join(dst, "config.json"), "w") as f:
        f.write(cfg.to_json())
    for name in ckpts:
        os.symlink(os.path.join(run_dir, name), os.path.join(dst, name))
    return str(dst)


def test_infer_from_run_explicit_dataset_flags_win(run, tree, tmp_path):
    """The run's config names an RHD root that does not exist and a
    batch of 8; the flags given on the command line win, even where one
    equals the usual default, and the run's model_best gives its best
    validation MPJPE exactly."""
    run_dir, best = run
    hostile = _run_like(run_dir, tmp_path / "run", ["model_best"],
                        {"dataset_root_dir": "/nonexistent/rhd",
                         "dataset_name": "InterHand2.6M",
                         "infer_batch_size": 8})
    mpjpe = infer_cli.main(["--from_run", hostile, "--data_root", tree,
                            "--dataset", "RHD", "--batch_size",
                            str(BATCH), "--device", "cpu"])
    assert mpjpe == best


def test_infer_from_run_falls_back_to_checkpoint_and_exits_without(
        run, tree, tmp_path):
    run_dir, _ = run
    only_ckpt = _run_like(run_dir, tmp_path / "a", ["checkpoint"])
    mpjpe = infer_cli.main(["--from_run", only_ckpt, "--device", "cpu"])
    with open(os.path.join(run_dir, "config.json")) as f:
        cfg = Config.from_json(f.read())
    want = Evaluator(cfg, weights=os.path.join(run_dir, "checkpoint"),
                     device="cpu").evaluate()
    assert mpjpe == want
    empty = _run_like(run_dir, tmp_path / "b", [])
    with pytest.raises(SystemExit, match="no model_best"):
        infer_cli.main(["--from_run", empty, "--device", "cpu"])


def test_infer_visualize_dir_writes_the_jax_overlays(run, tmp_path,
                                                     monkeypatch):
    """The first batch's first 3 overlays, named as JAX names them, each
    the JAX package's cv2 drawing of the port's crop, ground truth and
    inference-branch uv."""
    run_dir, best = run
    saved = {}
    real_save = vis.save_image

    def capture(path, img):
        saved[os.path.basename(path)] = img
        real_save(path, img)

    monkeypatch.setattr(vis, "save_image", capture)
    out = tmp_path / "vis"
    mpjpe = infer_cli.main(["--from_run", run_dir, "--device", "cpu",
                            "--visualize_dir", str(out),
                            "--visualize_n", "3"])
    assert mpjpe == best
    names = [f"000_{i:03d}_pre.jpg" for i in range(3)]
    assert sorted(os.listdir(out / "img")) == names
    back = imageio.decode_batch([str(out / "img" / n) for n in names],
                                CROP, CROP)
    assert back.shape == (3, CROP, CROP, 3)

    # the same overlays drawn by the JAX package from the port's values
    with open(os.path.join(run_dir, "config.json")) as f:
        cfg = Config.from_json(f.read())
    ev = Evaluator(cfg, weights=os.path.join(run_dir, "model_best"),
                   device="cpu")
    raw = next(iter(ev.batches()))
    from handpose_tpu_torch.data.preprocess import (model_input,
                                                    preprocess_batch)
    from handpose_tpu_torch.infer.evaluator import serving_kwargs
    from handpose_tpu_torch.train.steps import forward
    with torch.no_grad():
        s = preprocess_batch(raw, **serving_kwargs(cfg))
        uv = inference_uv(cfg, forward(ev.model, s, cfg), s)
        # the is_inference=True branch gives the same uv
        infer_model = build_model(cfg, is_inference=True)
        infer_model.load_state_dict(ev.model.state_dict())
        uv_inf = infer_model(model_input(s, 21), s["camera_intrinsic_matrix"],
                             s["keypoint_scale"], s["keypoint_xyz_root"]).uv
    assert torch.equal(uv, uv_inf)
    for i, n in enumerate(names):
        want = jvis.plot_pred_vs_gt(
            jvis.to_uint8_image(s["image_crop"][i].numpy()), uv[i].numpy(),
            s["keypoint_uv21"][i].numpy(), s["keypoint_vis21"][i].numpy())
        np.testing.assert_array_equal(saved[n], want)


def test_infer_export_writes_a_loadable_forward(run, tmp_path):
    run_dir, _ = run
    path = str(tmp_path / "fwd.pt2")
    infer_cli.main(["--from_run", run_dir, "--device", "cpu", "--export",
                    path, "--export_batch", "2"])
    fn = export.load_exported_file(path)
    with open(os.path.join(run_dir, "config.json")) as f:
        cfg = Config.from_json(f.read())
    from handpose_tpu_torch.infer import load_serving_model
    model = load_serving_model(cfg, os.path.join(run_dir, "model_best"),
                               device="cpu")
    args = (torch.from_numpy(np.random.default_rng(9).uniform(
        0, 1, (2, CROP, CROP, 21)).astype(np.float32)),
        torch.eye(3).expand(2, 3, 3) * 100, torch.ones(2, 1) * 0.05,
        torch.tensor([[0.0, 0.0, 0.6]] * 2))
    xyz, uv = fn(*args)
    with torch.no_grad():
        want = model(*args)
    assert torch.equal(xyz, want.xyz) and torch.equal(uv, want.uv)


def test_profile_epoch_writes_a_trace_and_the_cache_dir_moves_the_build(
        tmp_path):
    cfg = Config(model_name="Hand3DPosePriorNetwork", input_channels=21,
                 use_fake_data=True, dataset_name="synthetic",
                 batch_size=2, max_epoch=1, input_img_shape=(CROP, CROP),
                 compute_dtype="float32", log_every_steps=0,
                 save_log_dir=str(tmp_path / "logs"), profile_epoch=0,
                 compilation_cache_dir=str(tmp_path / "cache"))
    saved = cuda_build.BUILD_DIR
    try:
        w = Worker(cfg, device="cpu")
        assert cuda_build.BUILD_DIR == (tmp_path / "cache").resolve()
        w.run(fast_debug=True)
    finally:
        cuda_build.BUILD_DIR = saved
    traces = os.listdir(os.path.join(w.run_dir, "profile"))
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(os.path.join(w.run_dir, "profile", traces[0])) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert any("conv" in str(n) for n in names)
    shutil.rmtree(tmp_path / "logs", ignore_errors=True)


def test_device_info_lists_the_host_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the cards are listed")
    info = device_info.get_device_info()
    assert len(info) == 1 and info[0]["platform"] == "cpu"
    assert device_info.get_device_utilization_as_string().startswith(
        "dev0 cpu:")


@pytest.mark.parametrize("fused", [False, True])
def test_serving_demo(fused, tmp_path, monkeypatch):
    from handpose_tpu_torch.examples import serving_demo
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    argv = ["--fresh", "--device", "cpu", "--batch_size", "2", "--out",
            str(tmp_path / "demo.pt2")] + (["--fused"] if fused else [])
    xyz, uv = serving_demo.main(argv)
    assert xyz.shape == (2, 21, 3) and uv.shape == (2, 21, 2)
    assert torch.isfinite(xyz).all() and torch.isfinite(uv).all()
    assert (tmp_path / "demo.pt2").stat().st_size > 1e6
