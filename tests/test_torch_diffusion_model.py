"""Port parity: ``DiffusionHandPose`` (M5), float32, against the JAX package.

The model at crop 64, batch 4, full depth and width (the ResNet-50
``k3s2`` trunk, ``condition_feat_dim`` 256, ``Unet1D`` dim 64 with mults
1/2/4/8), T 20 and DDIM S 10 (the JAX transfer test's choice for
bounding drift), with the JAX model's variables (its traced ``init``,
refilled from a seed) carried across by ``convert.load_flax_variables``.
The sample dict is the port's preprocessing of a seeded raw RHD batch;
the model's three draws (the loss's t and noise, the sampler's x_T) are
injected into both packages.

One JAX program computes, from one compile, the train-mode forward with
the trainer-A losses (``loss_xyz`` and ``loss_diffusion``), the batch
statistics it leaves, the gradient of the loss, the DDIM sample and the
outputs of the two bone heads (the geometry's inputs).  As in
``test_torch_fk_mano_models.py``, the check is split where FK's
conditioning breaks: the sample and the bone heads' outputs are held to
JAX's, and the port's outputs, losses and gradient are computed from
JAX's bone-head outputs (``models.hook_geometry_inputs``, the port's own
gradient kept).  Train-mode BatchNorm over small stage-4 batches makes
the float32 gradient ill-conditioned, so each train-mode check is 1e-4
of the leaf's range plus twice JAX's largest movement of it when the
same program runs the batch, and the injected draws with it, in each of
the 23 other orders; the port's own movement sets nothing.

Further: the UNet's gradient comes only from ``diffusion_loss`` (the
sample has none: the port's counterpart of
``tests/test_models.py::test_ddim_sample_stops_gradients``);
``diffusion_sample_in_train=False``; the fused raw-batch step with the
draws as an argument equals the sample-dict path with ``_inject_``
entries; ``serve`` is deterministic; the train CLI and then the infer
CLI on its ``model_best``; the converter's round trip.
"""

import glob
import itertools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handpose_tpu.config import Config as JConfig
from handpose_tpu.data.preprocess import model_input as jmodel_input
from handpose_tpu.models import build_model as jbuild
from handpose_tpu.train import steps as jsteps
from handpose_tpu_torch.config import Config
from handpose_tpu_torch.convert import (export_flax_variables,
                                        flatten_variables,
                                        load_flax_variables)
from handpose_tpu_torch.data.preprocess import preprocess_batch
from handpose_tpu_torch.infer import __main__ as infer_cli
from handpose_tpu_torch.infer import load_serving_model, serve
from handpose_tpu_torch.models import build_model, hook_geometry_inputs
from handpose_tpu_torch.train import __main__ as train_cli
from handpose_tpu_torch.train import steps
from handpose_tpu_torch.train.state import create_train_state

from _torch_port import (array_ranges, flax_weights, max_rel_err, pp_kwargs,
                         seeded_raw, torch_raw, unflatten)
from _torch_port import port_worker_niced  # noqa: F401

MODEL = "DiffusionHandPose"
CROP, RAW, B, T, S = 64, 80, 4, 20, 10
TOL = 1e-4
REORDERS = tuple(itertools.permutations(range(B)))[1:]
HEADS = ("bone_angle_pred_model", "bone_length_pred_model")
SMALL = ["--device", "cpu", "--batch_size", "4",
         "--set", "input_img_shape=64,64", "--set", "compute_dtype=float32",
         "--set", f"num_timesteps={T}", "--set",
         f"num_sampling_timesteps={S}"]


def _cfgs(**kw):
    args = dict(dict(model_name=MODEL, input_img_shape=(CROP, CROP),
                     input_channels=3, compute_dtype="float32",
                     num_timesteps=T, num_sampling_timesteps=S), **kw)
    return JConfig(**args), Config(**args)


@pytest.fixture(scope="module")
def batch():
    """The port's preprocessing of a seeded raw batch, as numpy."""
    with torch.no_grad():
        sample = preprocess_batch(torch_raw(seeded_raw(B, RAW, 21)),
                                  **pp_kwargs(CROP))
    return {k: v.numpy() for k, v in sample.items()}


@pytest.fixture(scope="module")
def draws():
    """The model's three draws: x_T, the loss's t and its noise."""
    rng = np.random.default_rng(22)
    return {"init_noise": rng.normal(size=(B, 1, 63)).astype(np.float32),
            "diff_t": rng.integers(0, T, B).astype(np.int32),
            "diff_noise": rng.normal(size=(B, 1, 63)).astype(np.float32)}


@pytest.fixture(scope="module")
def weights():
    return flax_weights(CROP, 3, seed=3, model=MODEL, num_timesteps=T,
                        num_sampling_timesteps=S)


def _capture(mdl, method):
    return len(mdl.scope.path) == 1 and (
        (method == "__call__" and mdl.name in HEADS)
        or (method == "sample" and mdl.name == "diff_model"))


def _jax_program(jcfg):
    """run(variables, batch, draws) -> (losses, outputs, batch stats,
    gradients, the sample, the bone heads' outputs), one compile."""
    model = jbuild(jcfg)

    def loss_fn(params, bs, batch, draws):
        inp = jmodel_input(batch, jcfg.input_channels)
        pose_x0 = batch["keypoint_xyz21_rel_normed"].reshape(B, 1, -1)
        out, state = model.apply(
            {"params": params, "batch_stats": bs}, inp,
            batch["camera_intrinsic_matrix"], batch["keypoint_scale"],
            batch["keypoint_xyz_root"], pose_x0, train=True,
            rngs={"diffusion": jax.random.PRNGKey(0)},
            capture_intermediates=_capture,
            mutable=["batch_stats", "intermediates"], **draws)
        inter = state["intermediates"]
        feats = {n: inter[n]["__call__"][0] for n in HEADS}
        sample = inter["diff_model"]["sample"][0]
        losses = jsteps.compute_losses(out, batch, jcfg)
        return losses["loss"], (losses, out, state["batch_stats"], sample,
                                feats)

    def run(variables, batch, draws):
        (_, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            variables["params"], variables["batch_stats"], batch, draws)
        return aux + (grads,)

    return jax.jit(run)


def _flat_feats(feats) -> dict:
    """{name or name/i: numpy} of the bone heads' outputs (tuples split)."""
    flat = {}
    for n, v in feats.items():
        for i, x in enumerate(v if isinstance(v, (tuple, list)) else (v,)):
            key = f"{n}/{i}" if isinstance(v, (tuple, list)) else n
            flat[key] = np.asarray(x.detach() if torch.is_tensor(x) else x)
    return flat


def _jax_side(fn, variables, batch, draws, order):
    """JAX's side on the batch and draws in sample order ``order``, its
    batch axes put back in the batch's own order."""
    o = list(order)
    losses, out, bs, sample, feats, grads = fn(
        variables, {k: jnp.asarray(v[o]) for k, v in batch.items()},
        {k: jnp.asarray(v[o]) for k, v in draws.items()})
    back = np.argsort(order)
    return dict(losses={k: float(v) for k, v in losses.items()},
                out={k: np.asarray(getattr(out, k))[back]
                     for k in ("xyz", "uv")},
                bs=flatten_variables({"batch_stats": bs}),
                grads=flatten_variables({"params": grads}),
                sample=np.asarray(sample)[back], feats=feats,
                flat_feats={k: v[back] for k, v in _flat_feats(feats).items()})


DRIFT_KEYS = ("out", "bs", "grads", "flat_feats")


def _drift(jax_, ranges, moved, drift):
    for key in DRIFT_KEYS:
        for k, want in jax_[key].items():
            d = drift.setdefault(key, {})
            moved_by = float(np.abs(moved[key][k] - want).max()) / \
                ranges[key][k]
            d[k] = max(d.get(k, 0.0), moved_by)
    d = drift.setdefault("sample", 0.0)
    drift["sample"] = max(d, max_rel_err(jax_["sample"], moved["sample"]))
    for k, want in jax_["losses"].items():
        d = drift.setdefault("losses", {})
        d[k] = max(d.get(k, 0.0), abs(moved["losses"][k] - want) / abs(want))


def _t(d: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in d.items()}


def _port_model(cfg, flat):
    """The port's model with ``flat``, its sampler's output recorded."""
    port = load_flax_variables(build_model(cfg), flat)
    samples = []
    sample = port.diff_model.sample

    def recording_sample(*a, **kw):
        samples.append(sample(*a, **kw))
        return samples[-1]

    port.diff_model.sample = recording_sample
    return port, samples


@pytest.fixture(scope="module")
def runs(batch, draws, weights):
    """(jax, drift, port): JAX's and the port's losses, train outputs,
    batch stats, gradients, sample and bone-head outputs, and JAX's
    largest movement of each over the ``REORDERS``.  The port's outputs
    come from JAX's bone-head outputs; its own are in ``feats``."""
    jcfg, cfg = _cfgs()
    fn = _jax_program(jcfg)
    variables = unflatten(weights)
    jax_ = _jax_side(fn, variables, batch, draws, range(B))
    ranges, drift = array_ranges(jax_, DRIFT_KEYS), {}
    for order in REORDERS:
        _drift(jax_, ranges, _jax_side(fn, variables, batch, draws, order),
               drift)
    port, samples = _port_model(cfg, weights)
    own = hook_geometry_inputs(port, {
        n: tuple(map(np.asarray, v)) if isinstance(v, (tuple, list))
        else np.asarray(v) for n, v in jax_["feats"].items()})
    tb = _t(batch)
    out = steps._forward(port, tb, cfg, True, model_draws=_t(draws))
    losses = steps.compute_losses(out, tb, cfg)
    losses["loss"].backward()
    variables = export_flax_variables(port)
    port_side = dict(
        losses={k: float(v.detach()) for k, v in losses.items()},
        out={k: getattr(out, k).detach().numpy() for k in ("xyz", "uv")},
        bs={k: v for k, v in variables.items()
            if k.startswith("batch_stats/")},
        grads=export_flax_variables(port, grads=True),
        sample=samples[0].numpy(), feats=_flat_feats(own))
    jax_["feats"] = jax_.pop("flat_feats")
    drift["feats"] = drift.pop("flat_feats")
    return jax_, drift, port_side


def _within(want, got, drift, what):
    err = max_rel_err(want, got)
    assert err <= TOL + 2 * drift, (what, err, drift)


def test_sample_and_geometry_inputs_match_jax(runs):
    """The DDIM sample (B, 1, 63) from the injected x_T, then the bone
    heads' outputs (FK's inputs) on the port's own sample."""
    jax_, drift, port = runs
    assert port["sample"].shape == (B, 1, 63)
    _within(jax_["sample"], port["sample"], drift["sample"], "sample")
    assert sorted(port["feats"]) == sorted(jax_["feats"])
    for k, want in jax_["feats"].items():
        _within(want, port["feats"][k], drift["feats"][k], k)


def test_train_outputs_and_losses_match_jax(runs):
    """xyz and uv from JAX's bone-head outputs; ``loss_xyz``,
    ``loss_diffusion`` (the denoiser's loss on the injected t and noise)
    and their total."""
    jax_, drift, port = runs
    for k, want in jax_["out"].items():
        _within(want, port["out"][k], drift["out"][k], k)
    assert sorted(port["losses"]) == sorted(jax_["losses"]) == [
        "loss", "loss_diffusion", "loss_xyz"]
    for k, want in jax_["losses"].items():
        np.testing.assert_allclose(port["losses"][k], want,
                                   rtol=TOL + 2 * drift["losses"][k],
                                   err_msg=k)


def test_batch_stats_and_gradient_tree_match_jax(runs):
    """Each leaf on its own scale: the statistics the train-mode forward
    leaves, and the gradient of the total loss (the UNet's from
    ``loss_diffusion`` alone), 1e-4 of its range plus twice JAX's own
    largest movement of it under the reorderings."""
    jax_, drift, port = runs
    for key in ("bs", "grads"):
        assert sorted(port[key]) == sorted(jax_[key])
        for path, want in jax_[key].items():
            assert key == "bs" or np.abs(want).max() > 0, path
            _within(want, port[key][path], drift[key][path], path)


def test_unet_gradient_comes_only_from_diffusion_loss(batch, draws, weights):
    """The sample carries no gradient: the xyz and uv terms reach the bone
    heads and not the UNet or the trunk; ``diffusion_loss`` reaches the
    UNet and the trunk."""
    _, cfg = _cfgs()
    port = load_flax_variables(build_model(cfg), weights)
    out = steps._forward(port, _t(batch), cfg, True, model_draws=_t(draws))
    (out.xyz.square().sum() + out.uv.square().sum()).backward(
        retain_graph=True)
    unet = list(port.diff_model.unet.parameters())
    assert all(p.grad is None for p in unet)
    assert all(p.grad is None for p in port.resnet_extractor.parameters())
    assert any(p.grad is not None and float(p.grad.abs().sum()) > 0
               for p in port.bone_angle_pred_model.parameters())
    port.zero_grad(set_to_none=True)
    out.diffusion_loss.backward()
    assert all(p.grad is not None for p in unet)
    assert sum(float(p.grad.abs().sum()) for p in unet) > 0
    assert float(port.resnet_extractor.fc_proj.weight.grad.abs().sum()) > 0
    assert all(p.grad is None for p in port.bone_length_pred_model
               .parameters())


def test_sample_in_train_false_trains_only_the_denoiser(runs, batch, draws,
                                                        weights):
    """``diffusion_sample_in_train=False``: training returns only
    ``diffusion_loss`` (JAX's, within the tolerance) and the losses hold
    only its term; eval mode still samples."""
    jax_, drift, _ = runs
    _, cfg = _cfgs(diffusion_sample_in_train=False)
    port = load_flax_variables(build_model(cfg), weights)
    tb = _t(batch)
    out = steps._forward(port, tb, cfg, True, model_draws=_t(draws))
    assert out.xyz is None and out.uv is None
    losses = steps.compute_losses(out, tb, cfg)
    assert sorted(losses) == ["loss", "loss_diffusion"]
    np.testing.assert_allclose(
        float(losses["loss"].detach()), jax_["losses"]["loss_diffusion"],
        rtol=TOL + 2 * drift["losses"]["loss_diffusion"])
    with torch.no_grad():
        ev = steps.forward(port, tb, cfg, model_draws=_t(draws))
    assert ev.xyz.shape == (B, 21, 3) and ev.diffusion_loss is not None


def test_raw_batch_step_takes_the_draws_as_the_sample_dict_path(weights,
                                                                draws):
    """The fused raw-batch train step with ``model_draws`` and the
    sample-dict step with the draws as ``_inject_`` entries give the same
    losses and update, in two microbatches (each draw cut with the batch);
    without draws a generator makes the step repeatable."""
    _, cfg = _cfgs(lr=1e-3, grad_accum=2)
    raw = torch_raw(seeded_raw(B, RAW, 23))
    with torch.no_grad():
        sample = preprocess_batch(raw, **pp_kwargs(CROP))
    inject = {f"_inject_{k}": v for k, v in _t(draws).items()}
    results = []
    for route in ("raw", "dict"):
        model = load_flax_variables(build_model(cfg), weights)
        state = create_train_state(model, cfg, 1)
        if route == "raw":
            step = steps.make_fused_train_step(model, cfg, preprocess_batch,
                                               pp_kwargs(CROP))
            _, losses = step(state, raw, model_draws=_t(draws))
        else:
            _, losses = steps.make_train_step(model, cfg)(
                state, {**sample, **inject})
        results.append(({n: float(v) for n, v in losses.items()},
                        export_flax_variables(model)))
    (la, va), (lb, vb) = results
    assert la == lb and sorted(la) == ["loss", "loss_diffusion", "loss_xyz"]
    for path, v in va.items():
        np.testing.assert_array_equal(v, vb[path], err_msg=path)
    cfg = cfg.replace(grad_accum=1)
    runs = []
    for _ in range(2):
        model = load_flax_variables(build_model(cfg), weights)
        step = steps.make_fused_train_step(model, cfg, preprocess_batch,
                                           pp_kwargs(CROP))
        _, losses = step(create_train_state(model, cfg, 1), raw,
                         generator=torch.Generator().manual_seed(5))
        runs.append({n: float(v) for n, v in losses.items()})
    assert runs[0] == runs[1]


def test_serve_is_deterministic_and_hoist_agnostic(weights):
    """``serve`` draws x_T from a generator seeded ``cfg.seed`` on each
    call: two calls agree exactly, and the hoisted and unhoisted samplers
    agree to 2e-5 of range."""
    raw = seeded_raw(B, RAW, 24)
    outs = []
    for hoist in ("on", "on", "off"):
        _, cfg = _cfgs(sampler_hoist=hoist)
        model = load_serving_model(cfg, weights, device="cpu")
        outs.append(serve(model, torch_raw(raw), cfg, device="cpu"))
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)
    for a, b in zip(outs[0], outs[2]):
        assert max_rel_err(a, b) <= 2e-5
    assert outs[0][0].shape == (B, 21, 3)


@pytest.fixture
def logs(tmp_path):
    """A log directory removed after the test (a checkpoint is ~400
    MB)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_train_cli_then_infer_cli_on_model_best(logs, capsys):
    """``--model DiffusionHandPose --fake_data`` trains one epoch (the
    model's draws from the Worker's generator, validation from one seeded
    afresh); the infer CLI given only the run's ``model_best`` reports
    the run's best validation MPJPE exactly."""
    best = train_cli.main(["--model", MODEL, "--fake_data", "--fast_debug",
                           "--max_epoch", "1", "--log_dir", str(logs),
                           *SMALL])
    runs = glob.glob(os.path.join(str(logs), MODEL, "synthetic", "run_*"))
    assert len(runs) == 1 and np.isfinite(best)
    log = open(os.path.join(runs[0], "log.txt")).read()
    assert "training DiffusionHandPose" in log and "loss_diffusion" in log
    mpjpe = infer_cli.main(["--dataset", "synthetic", "--ckpt",
                            os.path.join(runs[0], "model_best"), *SMALL])
    assert mpjpe == best
    assert f"visible-joint MPJPE: {best:.5f} mm" in capsys.readouterr().out


def test_convert_round_trip(weights):
    """Every parameter and statistic round-trips exactly: the UNet's 1-D
    kernels (K, I, O), GroupNorm scales and RMSNorm ``g``s among them;
    a missing leaf raises."""
    _, cfg = _cfgs()
    port = load_flax_variables(build_model(cfg), weights)
    assert len(port.state_dict()) == len(weights)
    back = export_flax_variables(port)
    assert sorted(back) == sorted(weights)
    for path, v in weights.items():
        np.testing.assert_array_equal(back[path], v, err_msg=path)
    k = "params/diff_model/unet/init_conv/kernel"
    assert weights[k].shape == (7, 1, 64)
    assert tuple(port.diff_model.unet.init_conv.weight.shape) == (64, 1, 7)
    assert back["params/diff_model/unet/mid_attn/norm/g"].shape == (1, 1,
                                                                    512)
    with pytest.raises(KeyError, match="no flax variable"):
        load_flax_variables(port, {p: v for p, v in weights.items()
                                   if not p.endswith("block1/norm/scale")})
