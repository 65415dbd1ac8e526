"""Port parity: the losses module, the per-model loss gates and the eval
metrics of every trainer.

* ``LossCalculation``'s four terms on ``tests/fixtures/losses.npz``
  against the JAX package's criterion and the fixture's own values (the
  torch reference's), rtol 1e-6 each;
* L1, contrastive and the per-axis clamp of ``hand_mask_loss`` on a
  non-square mask against the JAX functions (rtol 1e-6);
* ``train.steps.compute_losses`` for every model name against the JAX
  function on the same outputs and sample dict: the same terms, rtol
  1e-6, ``loss_uv`` unscaled and ``uv / 1e5`` in the total;
* ``hand_mask_loss`` on uv out of int32's range or not finite, exactly
  as the JAX function (its saturating cast, NaN to 0);
* the eval metrics: ``TwoDimHandPose``'s MPJPE on uv and no PCK,
  ``OnlyThreeDimHandPose``'s and ``Resnet50MANO3DHandPose``'s on xyz
  with PCK, against JAX's
  ``_eval_metrics`` (rtol 1e-6); ``Hand3DPoseNet``'s MPJPE on the
  canonical coords, its PCK on the absolute coordinates built with the
  JAX functions (the JAX step has none for trainer-B models).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handpose_tpu import losses as jlosses
from handpose_tpu.config import Config as JConfig
from handpose_tpu.metrics import pck_sum_count as jpck_sum_count
from handpose_tpu.models.zoo import ModelOutput as JOutput
from handpose_tpu.ops.projection import \
    rel_normed_to_absolute as jrel_normed_to_absolute
from handpose_tpu.train import steps as jsteps
from handpose_tpu_torch import losses
from handpose_tpu_torch.config import MODEL_NAMES, Config
from handpose_tpu_torch.models.zoo import ModelOutput
from handpose_tpu_torch.train import steps

from _torch_port import port_worker_niced  # noqa: F401  (one torch thread, niced)

RTOL = 1e-6
B = 4
TERMS = ("xyz", "uv", "hand_mask", "regularization")
FIXTURE_KEYS = {"xyz": "loss_xyz", "uv": "loss_uv",
                "hand_mask": "loss_hand_mask", "regularization": "loss_reg"}
PCK_T = np.linspace(0.02, 0.05, 31).astype(np.float32)


@pytest.fixture(scope="module")
def fixture():
    import os
    path = os.path.join(os.path.dirname(__file__), "fixtures", "losses.npz")
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _args(f, to):
    return ([to(f[k]) for k in ("pre_xyz", "gt_xyz", "pre_uv", "gt_uv",
                                "vis")],
            dict(hand_mask=to(f["hand_mask"]), theta=to(f["theta"]),
                 beta=to(f["beta"])))


def _all_on(mod):
    return mod.LossCalculation(comp_xyz_loss=True, comp_uv_loss=True,
                               comp_hand_mask_loss=True,
                               comp_regularization_loss=True)


@pytest.mark.parametrize("term", TERMS)
def test_loss_terms_match_jax_and_the_fixture(fixture, term):
    args, kw = _args(fixture, torch.from_numpy)
    got = getattr(_all_on(losses)(*args, **kw), term)
    args, kw = _args(fixture, jnp.asarray)
    want = getattr(_all_on(jlosses)(*args, **kw), term)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    np.testing.assert_allclose(float(got), fixture[FIXTURE_KEYS[term]],
                               rtol=RTOL)
    off = losses.LossCalculation(**{f"comp_{t}_loss": t != term
                                    for t in TERMS})
    args, kw = _args(fixture, torch.from_numpy)
    assert getattr(off(*args, **kw), term) is None


def test_l1_contrastive_and_empty_visibility_match_jax():
    rng = np.random.default_rng(1)
    a, b = (rng.normal(size=(B, 21, 3)).astype(np.float32) for _ in "ab")
    vis = rng.uniform(size=(B, 21, 1)) > 0.4
    got = losses.masked_l1_loss(torch.from_numpy(a), torch.from_numpy(b),
                                torch.from_numpy(vis))
    want = jlosses.masked_l1_loss(jnp.asarray(a), jnp.asarray(b),
                                  jnp.asarray(vis))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    l1 = losses.LossCalculation(loss_type="L1", comp_xyz_loss=True)
    assert float(l1(torch.from_numpy(a), torch.from_numpy(b), None, None,
                    torch.from_numpy(vis)).xyz) == float(got)
    none = torch.zeros(B, 21, 1, dtype=torch.bool)
    assert float(losses.masked_l2_loss(torch.from_numpy(a),
                                       torch.from_numpy(b), none)) == 0.0
    f1, f2 = (rng.normal(size=(8, 16)).astype(np.float32) for _ in "ab")
    label = (rng.uniform(size=8) > 0.5).astype(np.float32)
    got = losses.contrastive_loss(*map(torch.from_numpy, (f1, f2, label)))
    want = jlosses.contrastive_loss(*map(jnp.asarray, (f1, f2, label)))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    calc = losses.LossCalculation(comp_contrastive_loss=True)
    assert float(calc(None, None, None, None, None,
                      feat1=torch.from_numpy(f1), feat2=torch.from_numpy(f2),
                      label=torch.from_numpy(label)).contrastive) \
        == float(got)


def test_hand_mask_loss_clamps_u_by_width_and_v_by_height():
    """A 40 x 64 mask, uv past both edges: u clamps at W - 1 = 63, v at
    H - 1 = 39, as in the JAX function."""
    rng = np.random.default_rng(2)
    mask = (rng.uniform(size=(B, 40, 64)) > 0.5).astype(np.float32)
    gt = rng.uniform(-5, 70, (B, 21, 2)).astype(np.float32)
    pred = rng.uniform(-5, 70, (B, 21, 2)).astype(np.float32)
    got = losses.hand_mask_loss(*map(torch.from_numpy, (pred, gt, mask)))
    want = jlosses.hand_mask_loss(*map(jnp.asarray, (pred, gt, mask)))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    # every sample at (63, 39), the mask's last row and column
    edge = np.full((B, 21, 2), 1e3, np.float32)
    got = losses.hand_mask_loss(torch.from_numpy(edge), torch.from_numpy(gt),
                                torch.from_numpy(mask))
    hits = mask[:, 39, 63].sum() * 21
    gt_i = np.clip(gt.astype(np.int32), 0, [63, 39])
    gts = sum(mask[b, gt_i[b, :, 1], gt_i[b, :, 0]].sum() for b in range(B))
    np.testing.assert_allclose(float(got), 1 - hits / (gts + 1e-8),
                               rtol=RTOL)


def test_hand_mask_loss_takes_out_of_range_and_non_finite_uv_as_jax():
    """uv of +-1e10, +-inf, NaN, +-3e9 and in-range values, on both axes
    of predictions and labels: the port equals the JAX function exactly.
    JAX's int32 cast saturates and sends NaN to 0 before the clamp (so
    3e9 samples column W - 1); torch's own cast gives INT_MIN on the
    host, which the clamp took to column 0."""
    H, W = 40, 64
    rng = np.random.default_rng(3)
    mask = (rng.uniform(size=(B, H, W)) > 0.5).astype(np.float32)
    mask[:, :, 0] = 0.0                 # column 0 and row 0 empty,
    mask[:, 0, :] = 0.0                 # the last column and row full
    mask[:, :, W - 1] = 1.0
    mask[:, H - 1, :] = 1.0
    odd = np.float32([1e10, -1e10, np.inf, -np.inf, np.nan, 3e9, -3e9,
                      300.7, 12.5, -0.5, 39.99, 63.99, 7.0])
    n = len(odd)
    idx = np.arange(B * 21 * 2).reshape(B, 21, 2)
    pred = odd[idx % n]
    gt = rng.uniform(-5, 70, (B, 21, 2)).astype(np.float32)
    gt[:, ::3] = odd[(idx[:, ::3] * 5 + 1) % n]
    for p, g in ((pred, gt), (gt, pred)):
        got = losses.hand_mask_loss(*map(torch.from_numpy, (p, g, mask)))
        want = jlosses.hand_mask_loss(*map(jnp.asarray, (p, g, mask)))
        assert float(got) == float(want), (float(got), float(want))


def _outputs_and_batch(seed):
    """Model outputs with every field a loss can read, and a sample dict
    with every label, as numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    out = dict(xyz=f(B, 21, 3) * 0.1, uv=f(B, 21, 2) * 20 + 32,
               diffusion_loss=np.float32(0.37), theta=f(B, 10),
               beta=f(B, 10), coord_xyz_rel_normed=f(B, 21, 3),
               can_xyz=f(B, 21, 3), rot_mat=f(B, 3, 3))
    batch = dict(keypoint_vis21=rng.uniform(size=(B, 21, 1)) > 0.3,
                 keypoint_xyz21=f(B, 21, 3) * 0.1,
                 keypoint_uv21=f(B, 21, 2) * 20 + 32,
                 kp_coord_xyz21_rel_can=f(B, 21, 3), rot_mat=f(B, 3, 3),
                 right_hand_mask=(rng.uniform(size=(B, 64, 64)) > 0.5)
                 .astype(np.float32),
                 keypoint_scale=rng.uniform(0.01, 0.02, (B, 1))
                 .astype(np.float32),
                 keypoint_xyz_root=f(B, 3) * 0.1 + [0, 0, 0.6],
                 keypoint_xyz21_rel_normed=f(B, 21, 3))
    batch["keypoint_xyz_root"] = batch["keypoint_xyz_root"].astype(
        np.float32)
    return out, batch


def _to_both(out, batch, fields):
    """(JAX output, JAX batch, port output, port batch) with only
    ``fields`` of the output set, as the model would."""
    jout = JOutput(**{k: jnp.asarray(out[k]) for k in fields})
    pout = ModelOutput(**{k: torch.as_tensor(out[k]) for k in fields})
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    pb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    return jout, jb, pout, pb


# the fields each model's training-mode output sets
_FIELDS = {"TwoDimHandPose": ("uv", "diffusion_loss"),
           "OnlyThreeDimHandPose": ("xyz", "uv"),
           "Hand3DPoseNet": ("coord_xyz_rel_normed", "can_xyz", "rot_mat"),
           "Hand3DPosePriorNetwork": ("coord_xyz_rel_normed", "can_xyz",
                                      "rot_mat"),
           "TwoDimHandPoseWithFK": ("xyz", "uv", "diffusion_loss"),
           "ThreeDimHandPose": ("xyz", "uv", "diffusion_loss"),
           "DiffusionHandPose": ("xyz", "uv", "diffusion_loss"),
           "MANO3DHandPose": ("xyz", "uv", "theta", "beta"),
           "ThreeHandShapeAndPoseMANO": ("xyz", "uv", "theta", "beta",
                                         "diffusion_loss"),
           "Resnet50MANO3DHandPose": ("xyz", "uv", "theta", "beta",
                                      "diffusion_loss")}


@pytest.mark.parametrize("model", MODEL_NAMES)
def test_compute_losses_match_jax(model):
    """Every model's gates: the same terms and values as the JAX
    function; the total carries ``loss_uv / 1e5`` and reports
    ``loss_uv`` unscaled."""
    out, batch = _outputs_and_batch(seed=len(model))
    jout, jb, pout, pb = _to_both(out, batch, _FIELDS[model])
    want = jsteps.compute_losses(jout, jb, JConfig(model_name=model))
    got = steps.compute_losses(pout, pb, Config(model_name=model))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=RTOL,
                                   err_msg=k)
    total = sum(float(v) / (1e5 if k == "loss_uv" else 1.0)
                for k, v in got.items() if k != "loss")
    np.testing.assert_allclose(float(got["loss"]), total, rtol=RTOL)
    if "loss_uv" in got:
        np.testing.assert_allclose(float(got["loss_uv"]), float(
            losses.masked_l2_loss(pout.uv, pb["keypoint_uv21"],
                                  pb["keypoint_vis21"])), rtol=0)


@pytest.mark.parametrize("model", ["TwoDimHandPose", "OnlyThreeDimHandPose",
                                   "Resnet50MANO3DHandPose",
                                   "Hand3DPoseNet"])
def test_eval_metrics_match_jax(model):
    out, batch = _outputs_and_batch(seed=7)
    jout, jb, pout, pb = _to_both(out, batch, _FIELDS[model])
    want = jsteps._eval_metrics(jout, jb, JConfig(model_name=model),
                                jnp.asarray(PCK_T))
    got = steps._eval_metrics(pout, pb, Config(model_name=model),
                              torch.from_numpy(PCK_T))
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(v),
                                   rtol=RTOL, err_msg=k)
    if model == "TwoDimHandPose":
        assert "pck_correct_sum" not in got and "pck_count" not in got
    elif model in ("OnlyThreeDimHandPose", "Resnet50MANO3DHandPose"):
        assert "pck_correct_sum" in want
    else:
        # the JAX step has no PCK for trainer-B models; the port's is
        # taken on the absolute coordinates both serving branches make
        assert "pck_correct_sum" not in want
        s, r = jb["keypoint_scale"], jb["keypoint_xyz_root"]
        cs, cn = jpck_sum_count(
            jrel_normed_to_absolute(jout.coord_xyz_rel_normed, s, r),
            jrel_normed_to_absolute(jb["keypoint_xyz21_rel_normed"], s, r),
            jb["keypoint_vis21"], jnp.asarray(PCK_T))
        np.testing.assert_allclose(got["pck_correct_sum"].numpy(),
                                   np.asarray(cs), rtol=RTOL)
        assert float(got["pck_count"]) == float(cn)
