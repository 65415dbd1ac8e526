"""Port parity: the serving artifacts (``infer/export.py``).

``export_forward`` for OnlyThreeDimHandPose, the flagship,
ThreeHandShapeAndPoseMANO (no uv: zeros in its place) and
DiffusionHandPose (T 8, DDIM 4; its x_T drawn at export time from a
generator seeded ``cfg.seed``, as ``serve`` draws it), and
``export_fused_pipeline`` of the flagship on an RHD raw batch, crop 64,
batch 2, float32, on the host, with the JAX models' variables carried
across by ``convert.py``.  Each artifact is held

* to the JAX model's in-framework output (the fused one: JAX's
  preprocessing and forward) at ``tests/test_torch_model_f32.py``'s
  tolerance, 1e-4 of range for xyz, and uv 1e-3 absolute as the JAX
  package's own export round trip holds it (DiffusionHandPose: JAX given
  the port's x_T);
* bit for bit to the port's eager forward (``serve`` for the fused one),
  after a save/load round trip in a fresh process that imports only
  torch, numpy and ``handpose_tpu_torch.ops``.

The fused program holds exactly one call of the scoremap kernel's
registered operator and none of the plain render's operations, so on
the card its replay launches the kernel.  One JAX program per case,
compiled once for the file.
"""

import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handpose_tpu.config import Config as JConfig
from handpose_tpu.data.preprocess import model_input as jmodel_input
from handpose_tpu.data.preprocess import preprocess_batch as jpreprocess
from handpose_tpu.models import build_model as jbuild
from handpose_tpu_torch.config import Config, default_input_channels
from handpose_tpu_torch.convert import load_flax_variables
from handpose_tpu_torch.data.preprocess import model_input, preprocess_batch
from handpose_tpu_torch.infer import export
from handpose_tpu_torch.infer.serving import serve
from handpose_tpu_torch.models import build_model

from _torch_port import (RAW_FIELDS, flax_weights, jax_raw, max_rel_err,
                         pp_kwargs, seeded_raw, torch_raw, unflatten)
from _torch_port import port_worker_niced  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROP, RAW, B = 64, 80, 2
TOL, UV_ATOL = 1e-4, 1e-3
FLAGSHIP = "Hand3DPosePriorNetwork"
FORWARD_MODELS = ("OnlyThreeDimHandPose", FLAGSHIP,
                  "ThreeHandShapeAndPoseMANO", "DiffusionHandPose")
CASES = FORWARD_MODELS + ("fused_pipeline",)
OP = torch.ops.handpose_tpu_torch.render_gaussian_maps.default
# ResNetMano's fc feeds MANO directly: seeded at full scale it drives the
# synthetic MANO far out of its working range, where float32 joints lose
# digits (tests/test_torch_fk_mano_models.py); scaled into it here
MANO_FC_SCALE = 1 / 32
# OnlyThreeDimHandPose regresses xyz directly and projects it: seeded, its
# depths scatter about 0, the projection's pole, where uv is thousands of
# pixels and its float32 digits are noise.  Its last layer is scaled and
# its depths shifted to a hand's 0.6 m before the camera
XYZ_HEAD = "params/threeDimPoseEstimate/Dense_4/"
XYZ_HEAD_SCALE = 1e-4


def _cfgs(model):
    kw = dict(model_name=model, input_img_shape=(CROP, CROP),
              input_channels=default_input_channels(model),
              compute_dtype="float32")
    if model == "DiffusionHandPose":
        kw.update(num_timesteps=8, num_sampling_timesteps=4)
    return JConfig(**kw), Config(**kw)


def _weights(model, jcfg):
    extra = ({"num_timesteps": 8, "num_sampling_timesteps": 4}
             if model == "DiffusionHandPose" else {})
    flat = flax_weights(CROP, jcfg.input_channels, seed=5, model=model,
                        **extra)
    if model == "ThreeHandShapeAndPoseMANO":
        flat = {k: v * MANO_FC_SCALE if "/fc/" in k else v
                for k, v in flat.items()}
    if model == "OnlyThreeDimHandPose":
        flat[XYZ_HEAD + "kernel"] = flat[XYZ_HEAD + "kernel"] * XYZ_HEAD_SCALE
        bias = flat[XYZ_HEAD + "bias"] * XYZ_HEAD_SCALE
        bias[2::3] += 0.6
        flat[XYZ_HEAD + "bias"] = bias
    return flat


@pytest.fixture(scope="module")
def raw():
    return seeded_raw(B, RAW, 31)


@pytest.fixture(scope="module")
def sample(raw):
    with torch.no_grad():
        return preprocess_batch(torch_raw(raw), **pp_kwargs(CROP))


def _forward_args(sample, cfg):
    return (model_input(sample, cfg.input_channels).contiguous(),
            sample["camera_intrinsic_matrix"], sample["keypoint_scale"],
            sample["keypoint_xyz_root"])


def _jax_forward(jcfg, flat, args, draws):
    fn = jax.jit(jbuild(jcfg, is_inference=True).apply)
    out = fn(unflatten(flat), *(jnp.asarray(a.numpy()) for a in args),
             rngs={"diffusion": jax.random.PRNGKey(0)},
             **{k: jnp.asarray(v.numpy()) for k, v in draws.items()})
    return out.xyz, out.uv


def _jax_fused(jcfg, flat, raw):
    model = jbuild(jcfg, is_inference=True)

    @jax.jit
    def run(variables, r):
        s = jpreprocess(r, **pp_kwargs(CROP))
        out = model.apply(variables, jmodel_input(s, jcfg.input_channels),
                          s["camera_intrinsic_matrix"], s["keypoint_scale"],
                          s["keypoint_xyz_root"])
        return out.xyz, out.uv

    return run(unflatten(flat), jax_raw(raw))


@pytest.fixture(scope="module")
def cases(raw, sample):
    """{case: dict(blob, args, eager (xyz, uv), jax (xyz, uv))}."""
    out = {}
    for case in CASES:
        model_name = FLAGSHIP if case == "fused_pipeline" else case
        jcfg, cfg = _cfgs(model_name)
        flat = _weights(model_name, jcfg)
        model = load_flax_variables(build_model(cfg, is_inference=True),
                                    flat)
        if case == "fused_pipeline":
            # in the artifact's input dtypes (the visibility as float32,
            # as the JAX artifact takes it)
            args = tuple(torch.from_numpy(np.ascontiguousarray(
                raw[k])) for k in RAW_FIELDS)
            args = args[:3] + (args[3].float(),) + args[4:]
            blob = export.export_fused_pipeline(cfg, flat, B, (RAW, RAW),
                                                device="cpu")
            eager = serve(model, torch_raw(raw), cfg, device="cpu")
            ref = _jax_fused(jcfg, flat, raw)
        else:
            args = _forward_args(sample, cfg)
            blob = export.export_forward(cfg, flat, B, device="cpu")
            draws = export.baked_draws(model, cfg, B, "cpu")
            kw = ({"generator": torch.Generator().manual_seed(cfg.seed)}
                  if draws else {})
            with torch.no_grad():
                o = model(*args, **kw)
            eager = export._xyz_uv(o, B, cfg.keypoint_num, "cpu")
            ref = _jax_forward(jcfg, flat, args, draws)
        out[case] = dict(blob=blob, args=args, eager=eager, jax=ref)
    return out


_RELOAD = """
import io, json, sys
import numpy as np
import torch
import handpose_tpu_torch.ops
torch.set_num_threads(1)        # the test process's: the same CPU kernels
work = sys.argv[1]
cases = json.load(open(work + "/cases.json"))
res = {}
for case in cases:
    program = torch.export.load(f"{work}/{case}.pt2")
    args = torch.load(f"{work}/{case}.args.pt")
    with torch.no_grad():
        res[case] = [t.clone() for t in program.module()(*args)]
torch.save(res, work + "/out.pt")
print(json.dumps(sorted(m for m in sys.modules
                        if m.startswith("handpose_tpu"))))
"""


@pytest.fixture(scope="module")
def reloaded(cases, tmp_path_factory):
    """Each artifact's outputs from a fresh process that loads it."""
    work = tmp_path_factory.mktemp("artifacts")
    for case, c in cases.items():
        export.save_exported(str(work / f"{case}.pt2"), c["blob"])
        torch.save(c["args"], work / f"{case}.args.pt")
    (work / "cases.json").write_text(json.dumps(list(cases)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"          # niced and single-threaded
    res = subprocess.run([sys.executable, "-c", _RELOAD, str(work)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    modules = json.loads(res.stdout.strip().splitlines()[-1])
    return torch.load(work / "out.pt"), modules


@pytest.fixture(scope="module")
def programs(cases):
    """Each artifact deserialised once for the file (a load of a ResNet-50
    artifact is ~9 s of the host's time)."""
    return {case: torch.export.load(io.BytesIO(c["blob"]))
            for case, c in cases.items()}


def _targets(program) -> list:
    """Every call_function target of the program, its submodules'
    (a scan's body) included."""
    return [n.target for gm in program.graph_module.modules()
            if isinstance(gm, torch.fx.GraphModule)
            for n in gm.graph.nodes if n.op == "call_function"]


def test_fused_pipeline_calls_the_scoremap_op_once_and_no_plain_render(
        programs):
    targets = _targets(programs["fused_pipeline"])
    assert targets.count(OP) == 1
    # the plain render's exp, its arange grid and its int32 truncation
    assert torch.ops.aten.exp.default not in targets
    forward = _targets(programs[FLAGSHIP])
    assert OP not in forward


def test_the_exported_sampler_is_one_scan(programs):
    targets = [str(t) for t in _targets(programs["DiffusionHandPose"])]
    assert targets.count("scan") == 1, sorted(set(targets))


@pytest.mark.parametrize("case", CASES)
def test_artifact_matches_jax(cases, programs, case):
    c = cases[case]
    fn = export._callable(programs[case])   # load_exported's callable
    xyz, uv = fn(*c["args"])
    jxyz, juv = c["jax"]
    assert xyz.shape == (B, 21, 3) and uv.shape == (B, 21, 2)
    assert max_rel_err(jxyz, xyz) <= TOL
    if juv is None:
        assert case == "ThreeHandShapeAndPoseMANO"
        assert not uv.any()
    else:
        np.testing.assert_allclose(uv.numpy(), np.asarray(juv),
                                   atol=UV_ATOL, rtol=0)


@pytest.mark.parametrize("case", CASES)
def test_reloaded_artifact_equals_eager_serving(cases, reloaded, case):
    outs, _ = reloaded
    for got, want in zip(outs[case], cases[case]["eager"]):
        assert torch.equal(got, want), case


def test_the_loading_process_imports_only_the_ops(reloaded):
    _, modules = reloaded
    assert "handpose_tpu_torch.ops.scoremap_cuda" in modules
    assert not [m for m in modules if m.startswith(
        ("handpose_tpu_torch.models", "handpose_tpu_torch.config",
         "handpose_tpu_torch.train", "handpose_tpu_torch.nn",
         "handpose_tpu_torch.data", "handpose_tpu."))] and \
        "handpose_tpu" not in modules


def test_baked_draws_follow_the_generator_for_ddpm():
    """DDPM draws x_T and then one noise a step from the generator: the
    baked draws, injected, give the generator's sample exactly."""
    _, cfg = _cfgs("DiffusionHandPose")
    cfg = cfg.replace(num_sampling_timesteps=8, resnet_out_feature_dim=64)
    model = build_model(cfg, is_inference=True)
    img = torch.from_numpy(np.random.default_rng(1).uniform(
        -0.5, 0.5, (B, CROP, CROP, 3)).astype(np.float32))
    K = torch.eye(3).expand(B, 3, 3) * 100
    args = (img, K, torch.ones(B, 1), torch.zeros(B, 3) + 0.5)
    draws = export.baked_draws(model, cfg, B, "cpu")
    assert draws["step_noise"].shape == (8, B, 1, 63)
    with torch.no_grad():
        a = model(*args, generator=torch.Generator().manual_seed(cfg.seed))
        b = model(*args, **draws)
    assert torch.equal(a.xyz, b.xyz) and torch.equal(a.uv, b.uv)
