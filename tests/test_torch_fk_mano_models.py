"""Port parity: the FK and MANO models, float32, against the JAX package.

``TwoDimHandPoseWithFK`` (M2), ``ThreeDimHandPose`` (M3),
``MANO3DHandPose`` (M6), ``ThreeHandShapeAndPoseMANO`` (M7, ResNetMano
on 24 channels) and ``Resnet50MANO3DHandPose`` (M8, 24 channels) at crop
64, batch 4, full depth and width, on the synthetic MANO stand-in, with
the JAX model's variables (its traced ``init``, refilled from a seed)
carried across by ``convert.load_flax_variables``.  The sample dict is
the port's preprocessing of a seeded raw RHD batch, handed to both.

One JAX program per model computes, from one compile, the train-mode
forward with its trainer-A losses (the model's gates, ``loss_uv / 1e5``
in the total), the batch statistics it leaves, the gradient of the loss,
the eval-mode outputs of the model's inference build, and in both modes
the geometry's inputs: the outputs of the modules the port model's
``geometry_inputs`` names (the bone heads, the MANO heads, the MANO
trunk or the sigmoid MLP).

Random MANO heads drive MANO far from where it was meant to work (the
port's ``ResNetMano`` output is 1.5e-6 of range from JAX's, the joints
MANO makes of it 4e-4), and seeded bone heads on pixel uv would do the
same to FK (angles of tens of radians, joints at z ~ 0 where the
projection has its pole): ``TwoDimHandPoseWithFK``'s are scaled into
FK's working range (``BONE_HEAD_SCALE``).  Each check is split where the
conditioning breaks: the geometry's inputs are held to JAX's, and the
port's outputs, losses and gradient are computed from JAX's inputs
(``models.hook_geometry_inputs`` hands the port JAX's values with the
port's own gradient).  The same JAX program runs on the batch in the 23
other sample orders: train-mode BatchNorm over 16-row stage-4 batches
makes the float32 gradient ill-conditioned
(``test_torch_resnet50_step.py``), so each train-mode check is 1e-4 of
the leaf's own range plus twice JAX's largest movement of it under those
reorderings; the port's own movement sets nothing.  The hand-mask term
samples the mask at the integer-truncated uv, a step function of uv: it
is held to JAX's function on the port's uv, exactly.  Eval mode: 1e-4 of
range.
Further: ``uv_from_xd`` 2, 2.5 and 3; ``ThreeHandShapeAndPoseMANO``
with 3 channels and ``network_regress_uv``; ``ResNetMano`` at crop 256,
where its ``AvgPool2d(7)`` drops the last row and column of the 8x8 map;
the converter's round trip on the MANO models.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handpose_tpu import losses as jlosses
from handpose_tpu.config import Config as JConfig
from handpose_tpu.data.preprocess import model_input as jmodel_input
from handpose_tpu.models import build_model as jbuild
from handpose_tpu.nn.resnet import ResNetMano as JResNetMano
from handpose_tpu.train import steps as jsteps
from handpose_tpu_torch.config import Config, default_input_channels
from handpose_tpu_torch.convert import (export_flax_variables,
                                        flatten_variables,
                                        load_flax_variables)
from handpose_tpu_torch.data.preprocess import preprocess_batch
from handpose_tpu_torch import models
from handpose_tpu_torch.models import build_model, hook_geometry_inputs
from handpose_tpu_torch.nn.resnet import ResNetMano
from handpose_tpu_torch.train import steps

from _torch_port import (array_ranges, flax_weights, max_rel_err, pp_kwargs,
                         seeded_raw, seeded_variables, torch_raw, unflatten)
from _torch_port import port_worker_niced  # noqa: F401

CROP, RAW, B = 64, 80, 4
TOL = 1e-4
# JAX's own drift is measured over every other order of the batch
REORDERS = tuple(itertools.permutations(range(B)))[1:]
# TwoDimHandPoseWithFK's bone heads read pixel uv (tens of pixels), not a
# unit-scale pose: their last Dense layers are scaled down so that FK
# starts where it works, joints in front of the camera and uv about the
# crop, as ThreeDimHandPose's do from its seeded weights
BONE_HEAD_SCALE = 1 / 32
MODELS = ("TwoDimHandPoseWithFK", "ThreeDimHandPose", "MANO3DHandPose",
          "ThreeHandShapeAndPoseMANO", "Resnet50MANO3DHandPose")
OUT_KEYS = ("xyz", "uv", "uv_aux", "theta", "beta")


def _cfgs(model, **kw):
    args = dict(dict(model_name=model, input_img_shape=(CROP, CROP),
                     input_channels=default_input_channels(model),
                     compute_dtype="float32"), **kw)
    return JConfig(**args), Config(**args)


def _fields(out) -> dict:
    return {k: np.asarray(getattr(out, k)) for k in OUT_KEYS
            if getattr(out, k) is not None}


@pytest.fixture(scope="module")
def batch():
    """The port's preprocessing of a seeded raw batch, as numpy."""
    with torch.no_grad():
        sample = preprocess_batch(torch_raw(seeded_raw(B, RAW, 11)),
                                  **pp_kwargs(CROP))
    return {k: v.numpy() for k, v in sample.items()}


def _reordered(batch, order):
    return {k: v[list(order)].copy() for k, v in batch.items()}


def _capture(names):
    def capture(mdl, method):
        return method == "__call__" and len(mdl.scope.path) == 1 \
            and mdl.name in names
    return capture


def _jax_apply(m, jcfg, names, variables, batch, train):
    """(outputs, new batch stats or None, {name: output of the top-level
    module ``name``}) of the flax model ``m`` on a sample dict."""
    inp = jmodel_input(batch, jcfg.input_channels)
    pose_x0 = batch["keypoint_xyz21_rel_normed"].reshape(inp.shape[0], 1, -1)
    out, state = m.apply(
        variables, inp, batch["camera_intrinsic_matrix"],
        batch["keypoint_scale"], batch["keypoint_xyz_root"], pose_x0,
        train=train, capture_intermediates=_capture(names),
        mutable=["batch_stats", "intermediates"] if train
        else ["intermediates"])
    feats = {n: state["intermediates"][n]["__call__"][0] for n in names}
    return out, state.get("batch_stats"), feats


def _jax_program(model_name, jcfg):
    """run(variables, batch) -> (losses, train outputs, batch stats,
    gradients, eval outputs of the inference build, train features, eval
    features), one compile; the features are the outputs of the modules
    the model's ``geometry_inputs`` names."""
    model = jbuild(jcfg)
    infer = jbuild(jcfg, is_inference=True)
    names = _geometry_inputs(model_name)

    def loss_fn(params, bs, batch):
        out, new_bs, feats = _jax_apply(
            model, jcfg, names, {"params": params, "batch_stats": bs},
            batch, True)
        losses = jsteps.compute_losses(out, batch, jcfg)
        return losses["loss"], (losses, out, new_bs, feats)

    def run(variables, batch):
        (_, (losses, out, new_bs, feats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(variables["params"],
                                   variables["batch_stats"], batch)
        ev, _, ev_feats = _jax_apply(infer, jcfg, names, variables, batch,
                                     False)
        return losses, out, new_bs, grads, ev, feats, ev_feats

    return jax.jit(run)


def _geometry_inputs(model_name):
    """The modules whose outputs enter the model's geometry (FK or MANO)."""
    return getattr(models, model_name).geometry_inputs


def _substitute(port, feats):
    """The port's geometry inputs take the values of ``feats`` (JAX's)
    with the port's own gradient; returns {name: the port's own
    output}."""
    return hook_geometry_inputs(port, {
        n: tuple(map(np.asarray, v)) if isinstance(v, (tuple, list))
        else np.asarray(v) for n, v in feats.items()})


def _flat_feats(feats) -> dict:
    """{name or name/i: numpy} of captured features (tuples split)."""
    flat = {}
    for n, v in feats.items():
        if isinstance(v, (tuple, list)):
            flat.update({f"{n}/{i}": np.asarray(
                x.detach() if torch.is_tensor(x) else x)
                for i, x in enumerate(v)})
        else:
            flat[n] = np.asarray(v.detach() if torch.is_tensor(v) else v)
    return flat


def _scale_bone_heads(flat):
    """The last Dense layer of each bone head MLP times
    ``BONE_HEAD_SCALE``."""
    last = {}
    for k in flat:
        head, mlp, dense, _ = k.split("/")[1:] if k.count("/") == 4 \
            else (None,) * 4
        if head in ("boneAngle", "bonelength"):
            i = int(dense.split("_")[1])
            last[head, mlp] = max(last.get((head, mlp), 0), i)
    for (head, mlp), i in last.items():
        for leaf in ("kernel", "bias"):
            flat[f"params/{head}/{mlp}/Dense_{i}/{leaf}"] *= BONE_HEAD_SCALE
    return flat


@pytest.fixture(scope="module")
def weights():
    flat = {m: flax_weights(CROP, default_input_channels(m), seed=i,
                            model=m) for i, m in enumerate(MODELS)}
    _scale_bone_heads(flat["TwoDimHandPoseWithFK"])
    return flat


def _held_losses(losses):
    """The losses held within a tolerance: all but the hand-mask term, a
    step function of uv, which also leaves the total."""
    held = dict(losses)
    held["loss"] -= held.pop("loss_hand_mask", 0.0)
    return held


def _jax_side(fn, variables, batch, order):
    """JAX's side of :func:`runs` on ``batch`` in sample order ``order``,
    its batch axes put back in the batch's own order."""
    losses, out, bs, grads, ev, feats, ev_feats = fn(
        variables, {k: jnp.asarray(v) for k, v in
                    _reordered(batch, order).items()})
    back = np.argsort(order)
    return dict(losses={k: float(v) for k, v in losses.items()},
                out={k: v[back] for k, v in _fields(out).items()},
                bs=flatten_variables({"batch_stats": bs}),
                grads=flatten_variables({"params": grads}),
                ev={k: v[back] for k, v in _fields(ev).items()},
                feats=feats, ev_feats=ev_feats,
                flat_feats={k: v[back] for k, v in _flat_feats(feats).items()})


DRIFT_KEYS = ("out", "bs", "grads", "flat_feats")


def _drift(jax_, ranges, moved, drift):
    """``drift`` raised to JAX's movement under one reordering
    (``moved``): each array over its range (``ranges``, as
    ``max_rel_err``, in float32), each held loss relative."""
    for key in DRIFT_KEYS:
        for k, want in jax_[key].items():
            d = drift.setdefault(key, {})
            moved_by = float(np.abs(moved[key][k] - want).max()) / \
                ranges[key][k]
            d[k] = max(d.get(k, 0.0), moved_by)
    held = _held_losses(moved["losses"])
    for k, want in _held_losses(jax_["losses"]).items():
        d = drift.setdefault("losses", {})
        d[k] = max(d.get(k, 0.0), abs(held[k] - want) / abs(want))


@pytest.fixture(scope="module")
def runs(batch, weights):
    """{model: (jax, drift, port)}: JAX's and the port's losses, train
    outputs (``out``), batch stats (``bs``), gradients (``grads``), eval
    outputs (``ev``) and geometry inputs in both modes (``feats``,
    ``ev_feats``), as numpy, and JAX's largest movement of each of them
    over the batch's ``REORDERS`` (:func:`_drift`).  The port's outputs
    are computed from JAX's geometry inputs (:func:`_substitute`); its
    own geometry inputs are what ``feats`` and ``ev_feats`` hold."""
    res = {}
    for model in MODELS:
        jcfg, cfg = _cfgs(model)
        flat = weights[model]
        fn = _jax_program(model, jcfg)
        variables = unflatten(flat)
        jax_ = _jax_side(fn, variables, batch, range(B))
        ranges, drift = array_ranges(jax_, DRIFT_KEYS), {}
        for order in REORDERS:
            _drift(jax_, ranges, _jax_side(fn, variables, batch, order),
                   drift)
        port = _port_run(cfg, flat, batch, jax_)
        jax_["feats"] = jax_.pop("flat_feats")
        port["feats"] = _flat_feats(port["feats"])
        for side in (jax_, port):
            side["ev_feats"] = _flat_feats(side["ev_feats"])
        drift["feats"] = drift.pop("flat_feats")
        res[model] = (jax_, drift, port)
    return res


def _port_run(cfg, flat, b, jax_side):
    """The port's side of :func:`runs` on the sample dict ``b``, its
    geometry inputs substituted by ``jax_side``'s."""
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    port = load_flax_variables(build_model(cfg), flat)
    own = _substitute(port, jax_side["feats"])
    out = steps._forward(port, tb, cfg, True)
    losses = steps.compute_losses(out, tb, cfg)
    losses["loss"].backward()
    variables = export_flax_variables(port)
    infer = load_flax_variables(build_model(cfg, is_inference=True), flat)
    ev_own = _substitute(infer, jax_side["ev_feats"])
    with torch.no_grad():
        ev = steps.forward(infer, tb, cfg)
    return dict(losses={k: float(v.detach()) for k, v in losses.items()},
                out=_fields(_detached(out)),
                bs={k: v for k, v in variables.items()
                    if k.startswith("batch_stats/")},
                grads=export_flax_variables(port, grads=True),
                ev=_fields(ev), feats=own, ev_feats=ev_own)


def _detached(out):
    for k in OUT_KEYS:
        if getattr(out, k) is not None:
            setattr(out, k, getattr(out, k).detach())
    return out


def _within(want, got, drift, what):
    """max |got - want| over the range of ``want`` <= 1e-4 + twice JAX's
    own largest movement of it under the batch's reorderings."""
    err = max_rel_err(want, got)
    assert err <= TOL + 2 * drift, (what, err, drift)


@pytest.mark.parametrize("model", MODELS)
def test_train_outputs_and_losses_match_jax(runs, batch, model):
    """The geometry's inputs (the heads' or the trunk's outputs), then the
    outputs and the trainer-A losses computed from JAX's geometry
    inputs, train mode."""
    jax_, drift, port = runs[model]
    for key in ("feats", "out"):
        assert sorted(port[key]) == sorted(jax_[key])
        for k, want in jax_[key].items():
            _within(want, port[key][k], drift[key][k], k)
    assert sorted(port["losses"]) == sorted(jax_["losses"])
    hand = port["losses"].get("loss_hand_mask")
    if hand is not None:
        # a step function of uv: JAX's function on the port's uv, exactly
        want = jlosses.hand_mask_loss(jnp.asarray(port["out"]["uv"]),
                                      jnp.asarray(batch["keypoint_uv21"]),
                                      jnp.asarray(batch["right_hand_mask"]))
        assert hand == float(want)
    pl = _held_losses(port["losses"])
    for k, want in _held_losses(jax_["losses"]).items():
        np.testing.assert_allclose(pl[k], want,
                                   rtol=TOL + 2 * drift["losses"][k],
                                   err_msg=k)
    if "loss_uv" in pl:
        assert abs(pl["loss"] - pl["loss_xyz"] - pl["loss_uv"] / 1e5) \
            <= 1e-6 * pl["loss"]


@pytest.mark.parametrize("model", MODELS)
def test_batch_stats_and_gradient_tree_match_jax(runs, model):
    """Each leaf on its own scale: the statistics the train-mode forward
    leaves, and the gradient of the total loss, each 1e-4 of its range
    plus twice JAX's own largest movement of it under the batch's
    reorderings."""
    jax_, drift, port = runs[model]
    for key in ("bs", "grads"):
        assert sorted(port[key]) == sorted(jax_[key])
        for path, want in jax_[key].items():
            assert key == "bs" or np.abs(want).max() > 0, path
            _within(want, port[key][path], drift[key][path], path)


@pytest.mark.parametrize("model", MODELS)
def test_inference_outputs_match_jax(runs, model):
    """Eval mode, the inference build: the geometry's inputs, then the
    outputs from JAX's geometry inputs, 1e-4 of range."""
    jax_, _, port = runs[model]
    for k, want in jax_["ev_feats"].items():
        assert max_rel_err(want, port["ev_feats"][k]) <= TOL, k
    want, got = jax_["ev"], port["ev"]
    assert sorted(got) == sorted(want) and "xyz" in got
    if model == "TwoDimHandPoseWithFK":
        assert sorted(got) == ["uv", "uv_aux", "xyz"]
    for k in want:
        assert max_rel_err(want[k], got[k]) <= TOL, k


def _port_eval(cfg, flat, batch, feats):
    """The port's training build of ``cfg`` in eval mode on ``batch``,
    its geometry inputs substituted by ``feats``."""
    port = load_flax_variables(build_model(cfg), flat)
    _substitute(port, feats)
    with torch.no_grad():
        return steps.forward(port, {k: torch.from_numpy(v)
                                    for k, v in batch.items()}, cfg)


@pytest.mark.parametrize("xd", [2.0, 2.5, 3.0])
def test_uv_from_xd_selects_the_training_uv(runs, weights, batch, xd):
    """The training build's uv in eval mode: the direct uv (2), the mean
    of the direct and the projected (2.5) or the projected (3), from the
    JAX inference build's ``uv_aux`` (direct) and ``uv`` (projected)."""
    model = "TwoDimHandPoseWithFK"
    jax_ = runs[model][0]
    ev = jax_["ev"]
    want = {2.0: ev["uv_aux"], 2.5: (ev["uv_aux"] + ev["uv"]) / 2,
            3.0: ev["uv"]}[xd]
    _, cfg = _cfgs(model, uv_from_xd=xd)
    feats = {n: (jax_["ev_feats"][f"{n}/0"], jax_["ev_feats"][f"{n}/1"])
             if n == "boneAngle" else jax_["ev_feats"][n]
             for n in _geometry_inputs(model)}
    out = _port_eval(cfg, weights[model], batch, feats)
    assert out.uv_aux is None
    assert max_rel_err(want, out.uv) <= TOL
    assert max_rel_err(ev["xyz"], out.xyz) <= TOL


def test_three_hand_shape_with_3_channels_and_regressed_uv(batch):
    """``ThreeHandShapeAndPoseMANO`` on the 3-channel stem (``conv1`` on
    the image crop) with ``network_regress_uv``: 26 outputs, uv from the
    regressed scale and translation about [545, 128, 128]; eval mode, the
    trunk's output, then the outputs from JAX's trunk output."""
    model = "ThreeHandShapeAndPoseMANO"
    jcfg, cfg = _cfgs(model, input_channels=3, network_regress_uv=True)
    flat = flax_weights(CROP, 3, seed=9, model=model, network_regress_uv=True)
    assert flat["params/resnet_Mano/fc/kernel"].shape == (512, 26)
    assert not any("conv11" in k for k in flat)
    names = _geometry_inputs(model)
    want, _, feats = jax.jit(lambda v, b: _jax_apply(
        jbuild(jcfg), jcfg, names, v, b, False))(
            unflatten(flat), {k: jnp.asarray(v) for k, v in batch.items()})
    port = load_flax_variables(build_model(cfg), flat)
    own = _substitute(port, feats)
    with torch.no_grad():
        got = steps.forward(port, {k: torch.from_numpy(v)
                                   for k, v in batch.items()}, cfg)
    assert max_rel_err(feats["resnet_Mano"], own["resnet_Mano"]) <= TOL
    for k in ("xyz", "uv"):
        assert max_rel_err(getattr(want, k), getattr(got, k)) <= TOL, k


def test_resnet_mano_pools_the_top_left_7x7_at_crop_256():
    """Eval forward of ``ResNetMano`` at crop 256, batch 1: the final map
    is 8x8 and the pool is the mean of its top-left 7x7 square."""
    jnet = JResNetMano(fc_dim=23, input_channel=3, bn_variance="fast")
    x = np.random.default_rng(4).uniform(
        0, 1, (1, 256, 256, 3)).astype(np.float32)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 256, 256, 3)))
    flat = seeded_variables(shapes, seed=4)
    want = jax.jit(jnet.apply)(unflatten(flat), jnp.asarray(x))
    net = load_flax_variables(ResNetMano(23, 3).eval(), flat)
    feats = {}
    net.fc.register_forward_hook(
        lambda m, i, o: feats.__setitem__("in", i[0]))
    net.BasicBlock_15.register_forward_hook(
        lambda m, i, o: feats.__setitem__("map", o))
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert tuple(feats["map"].shape) == (1, 512, 8, 8)
    torch.testing.assert_close(feats["in"],
                               feats["map"][:, :, :7, :7].mean((2, 3)))
    assert max_rel_err(want, got) <= TOL


def test_convert_round_trip_of_the_mano_models(weights):
    """Parameters and statistics round-trip exactly; the MANO layer's
    constants are neither expected from nor exported to the flax
    variables, and the state dict leaves them out."""
    for model in ("MANO3DHandPose", "ThreeHandShapeAndPoseMANO",
                  "Resnet50MANO3DHandPose"):
        _, cfg = _cfgs(model)
        flat = weights[model]
        port = load_flax_variables(build_model(cfg), flat)
        sd = port.state_dict()
        assert len(sd) == len(flat)
        assert not any(k.startswith("mano_layer.") for k in sd)
        assert len(dict(port.mano_layer.named_buffers())) == 8
        back = export_flax_variables(port)
        assert sorted(back) == sorted(flat)
        for path, v in flat.items():
            np.testing.assert_array_equal(back[path], v)
        with pytest.raises(KeyError, match="no flax variable"):
            load_flax_variables(port, {k: v for k, v in flat.items()
                                       if not k.endswith("bn1/scale")
                                       and not k.endswith("bn_init/scale")})
