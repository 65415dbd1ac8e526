"""Port parity: the Evaluator on InterHand2.6M, with the PCK curve.

An 8-frame val split from the JAX package's ``write_synthetic_interhand``
(64x40 and 40x64 JPEGs padded to 64x64), batch 4, crop 32, float32.  The
port's ``Evaluator.evaluate`` and ``evaluate_full`` against the JAX
package's eval-step functions on the same weights and batches (one
compiled program: ``preprocess_interhand_batch``, ``_forward``,
``_eval_metrics`` and ``pck_sum_count``), aggregated by the formula of
``handpose_tpu/infer/evaluator.py:208-239``: MPJPE, the PCK curve and
the AUC rtol 1e-5, the visible and correct-joint counts exactly.

The JAX step adds PCK only for a model with an ``xyz`` output; the
flagship's training-mode output has none, so both sides make the
absolute keypoints the serving branch makes, ``rel_normed_to_absolute``
of the prediction and of the ground truth's normalised coordinates with
the sample's scale and root, over the MPJPE's visible joints.

Also: ``python -m handpose_tpu_torch.infer --dataset InterHand2.6M
--pck`` prints what ``inference.py --pck`` prints; the synthetic data
path; RHD's ``evaluate_full`` agrees with its ``evaluate``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from handpose_tpu.config import Config as JConfig
from handpose_tpu.data import interhand as jih
from handpose_tpu.data.preprocess import \
    preprocess_interhand_batch as jpreprocess
from handpose_tpu.metrics import pck_sum_count as jpck_sum_count
from handpose_tpu.models import build_model as jbuild
from handpose_tpu.ops.projection import rel_normed_to_absolute as jabs
from handpose_tpu.train.steps import _eval_metrics as jeval_metrics
from handpose_tpu.train.steps import _forward as jforward
from handpose_tpu_torch.config import Config
from handpose_tpu_torch.data.interhand import InterHandDataset
from handpose_tpu_torch.infer import Evaluator
from handpose_tpu_torch.infer.__main__ import main as cli_main

from _torch_port import MODEL, flax_weights, interhand_raws, unflatten
from _torch_port import port_worker_niced  # noqa: F401

SIZES = [(64, 40), (40, 64)]
CROP, B, N = 32, 4, 8
TS = np.linspace(0.02, 0.05, 31)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    pytest.importorskip("cv2")
    root = str(tmp_path_factory.mktemp("ih"))
    jih.write_synthetic_interhand(root, "val", n=N, seed=7,
                                  image_sizes=SIZES)
    return root


@pytest.fixture(scope="module")
def weights():
    return flax_weights(CROP, seed=9)


def _cfg(root, **kw):
    return Config(model_name=MODEL, input_channels=21,
                  dataset_name="InterHand2.6M", dataset_root_dir=root,
                  infer_batch_size=B, input_img_shape=(CROP, CROP),
                  compute_dtype="float32", num_workers=2, **kw)


@pytest.fixture(scope="module")
def jax_sums(tree, weights):
    """Per batch: (mpjpe_sum, mpjpe_count, pck_correct_sum, pck_count)."""
    jcfg = JConfig(model_name=MODEL, input_channels=21,
                   input_img_shape=(CROP, CROP), compute_dtype="float32")
    model = jbuild(jcfg)
    var = unflatten(weights)
    pp = dict(crop_size=CROP, sigma=jcfg.sigma,
              switch_joint_order=jcfg.joint_order_switched)
    ts = jnp.asarray(TS)

    @jax.jit
    def sums(raw):
        batch = jpreprocess(raw, **pp)
        out, _ = jforward(model.apply, var["params"], var["batch_stats"],
                          batch, jcfg, False, jax.random.PRNGKey(0))
        m = jeval_metrics(out, batch, jcfg, ts)
        scale, root = batch["keypoint_scale"], batch["keypoint_xyz_root"]
        cs, cn = jpck_sum_count(
            jabs(out.coord_xyz_rel_normed, scale, root),
            jabs(batch["keypoint_xyz21_rel_normed"], scale, root),
            batch["keypoint_vis21"], ts)
        return m["mpjpe_sum"], m["mpjpe_count"], cs, cn

    ds = InterHandDataset(tree, "val", pad_to="auto")
    return [tuple(np.asarray(a, np.float64)
                  for a in sums(interhand_raws(raw)[0]))
            for raw in ds.batches(B, drop_remainder=False)]


def test_evaluator_mpjpe_and_pck_match_jax(tree, weights, jax_sums):
    # the aggregation of evaluator.py:208-239
    total = sum(float(s[0]) for s in jax_sums)
    count = sum(float(s[1]) for s in jax_sums)
    correct = np.sum([s[2] for s in jax_sums], axis=0)
    n = sum(float(s[3]) for s in jax_sums)
    curve = correct / n
    auc = np.trapezoid(curve, TS) / (TS[-1] - TS[0])

    ev = Evaluator(_cfg(tree), weights=weights, device="cpu")
    np.testing.assert_allclose(ev.evaluate(), total / count, rtol=1e-5)
    full = ev.evaluate_full()
    np.testing.assert_allclose(full["mpjpe"], total / count, rtol=1e-5)
    np.testing.assert_array_equal(full["pck_thresholds"], TS)
    np.testing.assert_allclose(full["pck"], curve, rtol=1e-5)
    np.testing.assert_allclose(full["auc_20_50mm"], auc, rtol=1e-5)
    assert 0 < auc < 1 and np.all(np.diff(full["pck"]) >= 0)
    # the step's counts, batch by batch, exactly
    step = ev._pck_step(TS)
    for raw, want in zip(ev.batches(), jax_sums):
        m = step(raw)
        assert float(m["mpjpe_count"]) == want[1]
        assert float(m["pck_count"]) == want[3] == want[1]
        np.testing.assert_array_equal(m["pck_correct_sum"].numpy(), want[2])
    assert len(ev._pck_steps) == 1          # one step per thresholds tuple
    ev.evaluate_full(thresholds=TS)
    assert len(ev._pck_steps) == 1


def test_infer_cli_pck_on_interhand(tree, weights, tmp_path, capsys):
    path = str(tmp_path / "w.npz")
    np.savez(path, **weights)
    res = cli_main(["--dataset", "InterHand2.6M", "--data_root", tree,
                    "--batch_size", str(B), "--weights", path, "--device",
                    "cpu", "--pck", "--set", f"input_img_shape={CROP},{CROP}",
                    "--set", "compute_dtype=float32", "--set",
                    "num_workers=2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("visible-joint MPJPE: ")
    assert out[1] == f"AUC (20-50mm): {res['auc_20_50mm']:.4f}"
    assert [t.split(":")[0] for t in out[2:]] == \
        [f"  PCK@{mm}mm" for mm in (20, 26, 32, 38, 44, 50)]
    want = Evaluator(_cfg(tree), weights=weights,
                     device="cpu").evaluate_full()
    assert res["mpjpe"] == want["mpjpe"]
    np.testing.assert_array_equal(res["pck"], want["pck"])
    mpjpe = cli_main(["--dataset", "InterHand2.6M", "--data_root", tree,
                      "--batch_size", str(B), "--weights", path, "--device",
                      "cpu", "--max_batches", "1", "--set",
                      f"input_img_shape={CROP},{CROP}", "--set",
                      "compute_dtype=float32"])
    assert np.isfinite(mpjpe)


def test_pck_and_auc_equal_jax():
    """The metrics' own copies against the JAX package's on random
    poses, thresholds in metres."""
    import torch
    from handpose_tpu import metrics as jm
    from handpose_tpu_torch import metrics as tm
    rng = np.random.default_rng(3)
    pred = rng.normal(0, 0.04, (5, 21, 3)).astype(np.float32)
    gt = pred + rng.normal(0, 0.02, (5, 21, 3)).astype(np.float32)
    vis = rng.uniform(size=(5, 21)) > 0.3
    p, g, v = (torch.from_numpy(a) for a in (pred, gt, vis))
    ts = TS.astype(np.float32)
    np.testing.assert_allclose(tm.pck(p, g, v, torch.from_numpy(ts)),
                               jm.pck(pred, gt, vis, ts), rtol=1e-6)
    cs, cn = tm.pck_sum_count(p, g, v, torch.from_numpy(ts))
    jcs, jcn = jm.pck_sum_count(pred, gt, vis, ts)
    np.testing.assert_array_equal(cs, jcs)
    assert float(cn) == float(jcn) == vis.sum()
    np.testing.assert_allclose(float(tm.auc_pck(p, g, v)),
                               float(jm.auc_pck(pred, gt, vis)), rtol=1e-5)
    assert float(tm.pck(p, g, torch.zeros_like(v), TS).sum()) == 0.0


def test_synthetic_data_and_rhd_evaluate_full(tmp_path):
    cfg = Config(model_name=MODEL, input_channels=21,
                 dataset_name="synthetic", infer_batch_size=B,
                 input_img_shape=(CROP, CROP), compute_dtype="float32")
    ev = Evaluator(cfg, device="cpu")
    full = ev.evaluate_full()
    assert full["mpjpe"] == ev.evaluate() and np.isfinite(full["mpjpe"])
    assert full["pck"].shape == (31,)
    from handpose_tpu_torch.data.rhd import write_synthetic_rhd
    write_synthetic_rhd(str(tmp_path), "evaluation", n=6, seed=2)
    ev = Evaluator(cfg.replace(dataset_name="RHD",
                               dataset_root_dir=str(tmp_path),
                               cache_decoded=True), device="cpu")
    full = ev.evaluate_full(thresholds=[0.01, 0.5, 1.0])
    assert full["mpjpe"] == ev.evaluate()
    assert np.all(np.diff(full["pck"]) >= 0) and full["pck"][-1] <= 1
    with pytest.raises(ValueError, match="not in"):
        Evaluator(cfg.replace(dataset_name="COCO"), device="cpu")
