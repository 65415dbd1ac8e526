"""Port parity: the Evaluator and the RHD dataset, whole split.

The port's ``write_synthetic_rhd`` writes a 10-sample tree of PNGs; the
JAX ``RHDDataset`` reads the same files.  The port's ``Evaluator`` (batch 4: 4 + 4 + a partial 2) is
held to the JAX fused eval step summed over the same batches, float32
compute: rtol 1e-5 on the whole-split MPJPE, visible counts exactly.
"""

import os

import jax
import numpy as np
import pytest
import torch

from handpose_tpu.config import Config as JConfig
from handpose_tpu.data.preprocess import preprocess_batch as jpreprocess
from handpose_tpu.data.rhd import RHDDataset as JRHDDataset
from handpose_tpu.models import build_model as jbuild
from handpose_tpu.train.state import TrainState
from handpose_tpu.train.steps import make_fused_eval_step as jmake_eval
from handpose_tpu_torch.config import Config
from handpose_tpu_torch.data.pipeline import (epoch_index_chunks,
                                              raw_device_batches)
from handpose_tpu_torch.data.rhd import RHDDataset, write_synthetic_rhd
from handpose_tpu_torch.infer import Evaluator
from handpose_tpu_torch.infer.__main__ import main as cli_main

from _torch_port import MODEL, flax_weights, unflatten
from _torch_port import port_worker_niced  # noqa: F401

CROP, N, BATCH = 64, 10, 4


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("rhd"))
    write_synthetic_rhd(root, "evaluation", n=N, seed=6)
    return root


@pytest.fixture(scope="module")
def weights():
    return flax_weights(CROP)


def _cfg(root, crop=CROP):
    return Config(model_name=MODEL, input_channels=21, dataset_name="RHD",
                  dataset_root_dir=root, infer_batch_size=BATCH,
                  input_img_shape=(crop, crop), compute_dtype="float32")


def test_jax_dataset_reads_the_ports_tree(tree):
    ours = RHDDataset(tree, "evaluation")
    theirs = JRHDDataset(tree, "evaluation", cache_decoded=True)
    assert len(ours) == len(theirs) == N
    idx = [7, 8, 9, 2]
    for a, b in zip(ours.raw_batch(idx), theirs.raw_batch(idx)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_synthetic_tree_matches_the_jax_writer(tmp_path, tree):
    """Same seed, same samples: the JAX writer's PNG tree decodes to the
    port's cache."""
    pytest.importorskip("cv2")
    from handpose_tpu.data.rhd import write_synthetic_rhd as jwrite
    jroot = str(tmp_path / "jax_rhd")
    jwrite(jroot, "evaluation", n=N, seed=6)
    theirs = JRHDDataset(jroot, "evaluation", use_native_decode=False)
    ours = RHDDataset(tree, "evaluation")
    for a, b in zip(ours.raw_batch(range(N)), theirs.raw_batch(range(N))):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_evaluator_whole_split_matches_jax(tree, weights):
    jcfg = JConfig(model_name=MODEL, input_channels=21,
                   input_img_shape=(CROP, CROP), compute_dtype="float32")
    import optax
    jm = jbuild(jcfg)
    var = unflatten(weights)
    state = TrainState.create(apply_fn=jm.apply, params=var["params"],
                              tx=optax.identity(),
                              batch_stats=var["batch_stats"])
    step = jmake_eval(jm, jcfg, jpreprocess,
                      dict(crop_size=CROP, sigma=jcfg.sigma,
                           switch_joint_order=jcfg.joint_order_switched))
    ds = JRHDDataset(tree, "evaluation", cache_decoded=True)
    total = count = 0.0
    sizes = []
    for raw in ds.batches(BATCH, drop_remainder=False):
        sizes.append(raw.image.shape[0])
        m = step(state, jax.device_put(raw), jax.random.PRNGKey(0))
        total += float(m["mpjpe_sum"])
        count += float(m["mpjpe_count"])
    assert sizes == [4, 4, 2]

    ev = Evaluator(_cfg(tree), weights=weights, device="cpu")
    assert [b.image.shape[0] for b in ev.batches()] == [4, 4, 2]
    np.testing.assert_allclose(ev.evaluate(), total / count, rtol=1e-5)


def test_evaluator_cli_reads_npz_weights(tree, weights, tmp_path, capsys):
    path = str(tmp_path / "w.npz")
    np.savez(path, **weights)
    ev = Evaluator(_cfg(tree), weights=path, device="cpu")
    got = cli_main(["--data_root", tree, "--batch_size", str(BATCH),
                    "--weights", path, "--device", "cpu",
                    "--set", f"input_img_shape={CROP},{CROP}",
                    "--set", "compute_dtype=float32"])
    assert "visible-joint MPJPE" in capsys.readouterr().out
    np.testing.assert_allclose(got, ev.evaluate(), rtol=1e-6)
    assert np.isfinite(got) and got > 0


def test_evaluator_max_batches_and_nothing_visible(tree):
    ev = Evaluator(_cfg(tree, crop=32), device="cpu")
    assert np.isfinite(ev.evaluate(max_batches=1))
    ev.dataset()._uv_vis[..., 2] = 0.0
    with pytest.warns(UserWarning, match="no visible keypoints"):
        assert np.isnan(ev.evaluate())


def test_dataset_without_cache_names_the_way_to_build_it(tree, tmp_path):
    """Without a cache the dataset decodes the PNGs, and a missing PNG
    raises naming it; ``cache_decoded=True`` builds the cache, after which
    the PNGs are no longer read."""
    import shutil
    root = str(tmp_path / "rhd")
    shutil.copytree(tree, root)
    d = os.path.join(root, "evaluation")
    for f in os.listdir(d):
        if f.startswith("decoded_"):
            os.remove(os.path.join(d, f))
    missing = os.path.join(d, "mask", "00003.png")
    os.remove(missing)
    with pytest.raises(OSError, match="00003.png"):
        RHDDataset(root, "evaluation").raw_batch([2, 3])
    with pytest.raises(OSError, match="00003.png"):
        RHDDataset(root, "evaluation", cache_decoded=True)
    assert not [f for f in os.listdir(d) if f.startswith("decoded_")]
    shutil.copy(os.path.join(tree, "evaluation", "mask", "00003.png"),
                missing)
    cached = RHDDataset(root, "evaluation", cache_decoded=True)
    assert sorted(f for f in os.listdir(d) if f.startswith("decoded_")) \
        == ["decoded_color_320.u8", "decoded_mask_320.u8"]
    shutil.rmtree(os.path.join(d, "color"))
    for a, b in zip(cached.raw_batch(range(N)),
                    RHDDataset(tree, "evaluation").raw_batch(range(N))):
        np.testing.assert_array_equal(a, b)


def test_pipeline_order_and_tensors(tree):
    from handpose_tpu.data.pipeline import epoch_index_chunks as jchunks
    for shuffle in (False, True):
        for drop in (False, True):
            assert epoch_index_chunks(N, 4, shuffle, 3, drop) == \
                jchunks(N, 4, shuffle, 3, drop)
    ds = RHDDataset(tree, "evaluation")
    batches = list(raw_device_batches(ds, 4, torch.device("cpu")))
    assert [b.image.shape[0] for b in batches] == [4, 4, 2]
    assert batches[0].keypoint_vis.dtype == torch.bool
    np.testing.assert_array_equal(batches[2].image.numpy(),
                                  ds.raw_batch([8, 9]).image)
