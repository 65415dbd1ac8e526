"""Port parity: the fused eval step and ``serve``, end to end.

A seeded raw batch goes through the JAX program and the port (float32
compute, the same carried-across weights).  Tolerances: visible counts
exactly; losses and MPJPE to rtol 1e-4 (float32 trunks, reordered sums);
serving xyz and uv to 1e-4 of their range.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handpose_tpu.config import Config as JConfig
from handpose_tpu.data.preprocess import model_input as jmodel_input
from handpose_tpu.data.preprocess import preprocess_batch as jpreprocess
from handpose_tpu.models import build_model as jbuild
from handpose_tpu.train.state import TrainState
from handpose_tpu.train.steps import make_fused_eval_step as jmake_eval
from handpose_tpu_torch.config import Config
from handpose_tpu_torch.convert import load_flax_variables
from handpose_tpu_torch.data.preprocess import preprocess_batch
from handpose_tpu_torch.infer import load_serving_model, serve
from handpose_tpu_torch.losses import masked_l2_loss, rot_mat_mse
from handpose_tpu_torch.metrics import masked_sum_count, mpjpe
from handpose_tpu_torch.models import build_model
from handpose_tpu_torch.train.steps import make_fused_eval_step

from _torch_port import (MODEL, flax_weights, jax_raw, max_rel_err,
                         seeded_raw, torch_raw, unflatten)
from _torch_port import port_worker_niced  # noqa: F401

CROP = 64
KEYS = ("loss_xyz", "loss_rot", "loss", "mpjpe", "mpjpe_sum", "mpjpe_count")


def _cfgs(**kw):
    common = dict(model_name=MODEL, input_channels=21,
                  input_img_shape=(CROP, CROP), compute_dtype="float32", **kw)
    return JConfig(**common), Config(**common)


def _pp(cfg):
    return dict(crop_size=cfg.crop_size, sigma=cfg.sigma,
                switch_joint_order=cfg.joint_order_switched)


@pytest.fixture(scope="module")
def weights():
    return flax_weights(CROP)


def _jax_eval(jcfg, flat, raw):
    import optax
    model = jbuild(jcfg)
    var = unflatten(flat)
    state = TrainState.create(apply_fn=model.apply, params=var["params"],
                              tx=optax.identity(),
                              batch_stats=var["batch_stats"])
    step = jmake_eval(model, jcfg, jpreprocess, _pp(jcfg))
    return step(state, jax_raw(raw), jax.random.PRNGKey(0))


def _port_eval(cfg, flat, raw):
    model = load_flax_variables(build_model(cfg), flat)
    step = make_fused_eval_step(model, cfg, preprocess_batch, _pp(cfg))
    return step(torch_raw(raw))


@pytest.mark.parametrize("B,grad_accum", [(4, 1), (4, 2), (3, 2)])
def test_fused_eval_step_matches_jax(weights, B, grad_accum):
    jcfg, cfg = _cfgs(grad_accum=grad_accum)
    raw = seeded_raw(B, 80, seed=30 + B)
    ref = _jax_eval(jcfg, weights, raw)
    out = _port_eval(cfg, weights, raw)
    assert set(out) == set(KEYS)
    assert float(out["mpjpe_count"]) == float(ref["mpjpe_count"]) > 0
    for key in KEYS:
        np.testing.assert_allclose(float(out[key]), float(ref[key]),
                                   rtol=1e-4, err_msg=key)


def test_serve_matches_jax_fused_pipeline(weights):
    """``serve`` against the body of ``export_fused_pipeline``, jitted."""
    jcfg, cfg = _cfgs()
    raw = seeded_raw(3, 80, seed=41)
    jm = jbuild(jcfg, is_inference=True)
    var = unflatten(weights)

    @jax.jit
    def direct(r):
        s = jpreprocess(r, **_pp(jcfg))
        out = jm.apply(var, jmodel_input(s, 21), s["camera_intrinsic_matrix"],
                       s["keypoint_scale"], s["keypoint_xyz_root"],
                       train=False)
        return out.xyz, out.uv

    ref_xyz, ref_uv = direct(jax_raw(raw))
    model = load_serving_model(cfg, weights, device="cpu")
    xyz, uv = serve(model, torch_raw(raw), cfg, device="cpu")
    assert xyz.shape == (3, 21, 3) and uv.shape == (3, 21, 2)
    assert max_rel_err(ref_xyz, xyz) <= 1e-4
    assert max_rel_err(ref_uv, uv) <= 1e-4


def test_serve_takes_numpy_raw_batches(weights):
    _, cfg = _cfgs()
    raw = seeded_raw(2, 80, seed=42)
    model = load_serving_model(cfg, weights, device="cpu")
    from handpose_tpu_torch.data.preprocess import RawBatch
    from _torch_port import RAW_FIELDS
    a = serve(model, RawBatch(*(raw[k] for k in RAW_FIELDS)), cfg,
              device="cpu")
    b = serve(model, torch_raw(raw), cfg, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_losses_and_metrics_match_jax():
    from handpose_tpu import losses as jl
    from handpose_tpu import metrics as jmet
    rng = np.random.default_rng(9)
    p = rng.normal(size=(3, 21, 3)).astype(np.float32)
    g = rng.normal(size=(3, 21, 3)).astype(np.float32)
    r1 = rng.normal(size=(3, 3, 3)).astype(np.float32)
    r2 = rng.normal(size=(3, 3, 3)).astype(np.float32)
    for vis in (rng.uniform(size=(3, 21, 1)) > 0.4, np.zeros((3, 21, 1), bool)):
        tp, tg, tv = map(torch.from_numpy, (p, g, vis))
        np.testing.assert_allclose(float(masked_l2_loss(tp, tg, tv)),
                                   float(jl.masked_l2_loss(p, g, vis)),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(mpjpe(tp, tg, tv)),
                                   float(jmet.mpjpe(p, g, vis)), rtol=1e-6)
        s, n = masked_sum_count(tp, tg, tv)
        js, jn = jmet.masked_sum_count(p, g, vis)
        np.testing.assert_allclose(float(s), float(js), rtol=1e-6)
        assert float(n) == float(jn)
    np.testing.assert_allclose(
        float(rot_mat_mse(torch.from_numpy(r1), torch.from_numpy(r2))),
        float(jl.rot_mat_mse(r1, r2)), rtol=1e-6)
