"""The Worker's knobs on one process: ``remat``, ``steps_per_dispatch``,
``debug_nans`` and ``fuse_preprocess=False``, on the CPU.

* ``remat``: the flagship's fused step with activation recomputation is
  bit-equal to the plain step (losses, parameters, BatchNorm statistics
  taking momentum once, the generator's state), in 'fast' and 'shifted'
  (whose shift is the running mean the recompute must find again), and
  launches the BN sums twice; held to JAX's ``remat=True`` fused step
  (crop 32, the same weights): losses rtol 1e-5, the variables as
  ``tests/test_torch_train_step.py`` holds a step.  DiffusionHandPose
  (T 4, DDIM 2 and DDPM 4) under remat: the step bit-equal to the plain
  one and the generator advanced once; the ResNet-50 and ResNetMano
  trunks' remat steps bit-equal to their plain steps (``Remat`` wraps
  any model's forward).  The model's draws made ahead
  (``draws``) are the stream its forward draws itself.
* ``make_fused_multi_step``: k steps over a stacked group equal k
  single steps bit for bit; the Worker runs full groups through it and
  an epoch's tail one step at a time, equal to ``steps_per_dispatch=1``;
  a preemption request while a group is buffered drops the group;
  fake data trains one step at a time (the JAX Worker's rule).
* ``debug_nans``: a NaN planted in one conv kernel raises
  ``FloatingPointError`` naming that module, in the port and in JAX
  (``jax_debug_nans``, restored after); a NaN made in a backward names
  the module whose input gradient it reached.
* ``fuse_preprocess=False``: the Worker preprocesses each batch as its
  own pass and trains ``make_train_step`` on it, equal to the fused
  Worker without augmentations; ``steps_per_dispatch > 1`` with it, and
  several ranks without the fused path, raise JAX's ``ValueError``.
"""

import copy
import os
import shutil
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from handpose_tpu.data.preprocess import preprocess_batch as jpreprocess
from handpose_tpu.train.steps import _make_fused_grad_one as jgrad_one
from handpose_tpu.train.steps import make_fused_train_step as jmake_step
from handpose_tpu_torch.config import Config
from handpose_tpu_torch.convert import export_flax_variables
from handpose_tpu_torch.data.rhd import write_synthetic_rhd
from handpose_tpu_torch.data.synthetic import fake_sample_batch
from handpose_tpu_torch.models import build_model
from handpose_tpu_torch.ops import moments
from handpose_tpu_torch.parallel import distributed
from handpose_tpu_torch.train import PreemptionGuard, Worker
from handpose_tpu_torch.train.nans import NanTrap
from handpose_tpu_torch.train.state import create_train_state
from handpose_tpu_torch.train.steps import (make_fused_multi_step,
                                            make_fused_train_step,
                                            make_train_step)

from _torch_port import (AUG_FLAGS, assert_trajectory_close, flax_weights,
                         jax_raw, jax_train_state, jax_variables, pp_kwargs,
                         seeded_raw, torch_raw, torch_train_state, train_cfgs)
from _torch_port import port_worker_niced  # noqa: F401

CROP, RAW, B, SPE = 32, 40, 4, 2
KW = dict(compute_dtype="float32", max_epoch=3)
FLAGS = {f: True for f in AUG_FLAGS}
N_TREE = 12
POISONED = "PosePrior_net/backbone/trunk/BasicBlock_2/Conv_1"


@pytest.fixture(scope="module")
def flat():
    return flax_weights(CROP, seed=9)


@pytest.fixture(scope="module")
def raws():
    return [torch_raw(seeded_raw(B, RAW, seed=90 + i)) for i in range(2)]


def _counted_sums():
    calls = [0]
    sums = moments._moments

    def counting(x2d, shift):
        calls[0] += 1
        return sums(x2d, shift)

    return calls, mock.patch.object(moments, "_moments", counting)


def _fused_run(flat, raws, cfg, flags=FLAGS):
    """A fused step on each of ``raws`` from ``flat`` on a seeded
    generator: (losses,
    variables, generator state, BN sums launched)."""
    model, state = torch_train_state(flat, cfg, SPE)
    step = make_fused_train_step(model, cfg, None, pp_kwargs(CROP), flags)
    g = torch.Generator().manual_seed(1)
    calls, patch = _counted_sums()
    losses = []
    with patch:
        for raw in raws:
            state, ls = step(state, raw, generator=g)
            losses.append({k: float(v) for k, v in ls.items()})
    return losses, export_flax_variables(model), g.get_state(), calls[0]


def _assert_same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---- remat ----

@pytest.mark.parametrize("bn", ["fast", "shifted"])
def test_remat_flagship_equals_the_plain_step(flat, raws, bn):
    _, cfg = train_cfgs(CROP, **KW, bn_variance=bn)
    plain = _fused_run(flat, raws[:1], cfg)
    remat = _fused_run(flat, raws[:1], cfg.replace(remat=True))
    assert plain[0] == remat[0]
    _assert_same(plain[1], remat[1])        # statistics moved once
    assert torch.equal(plain[2], remat[2])
    assert remat[3] == 2 * plain[3] == 2 * 40


def test_remat_flagship_matches_jax_remat(flat, raws):
    jcfg, cfg = train_cfgs(CROP, **KW, remat=True)
    jmodel, jstate = jax_train_state(flat, jcfg, SPE)
    step = jmake_step(jmodel, jcfg, jpreprocess, pp_kwargs(CROP))
    raw = seeded_raw(B, RAW, seed=95)
    jstate, jm = step(jstate, jax_raw(raw), jax.random.PRNGKey(0))
    model, state = torch_train_state(flat, cfg, SPE)
    state, losses = make_fused_train_step(model, cfg, None, pp_kwargs(CROP))(
        state, torch_raw(raw))
    for k, v in jm.items():
        np.testing.assert_allclose(float(losses[k]), float(v), rtol=1e-5)
    assert_trajectory_close(jax_variables(jstate),
                            export_flax_variables(model))


def _diffusion_cfg(s):
    return Config(model_name="DiffusionHandPose", input_channels=3,
                  input_img_shape=(CROP, CROP), compute_dtype="float32",
                  num_timesteps=4, num_sampling_timesteps=s)


@pytest.mark.parametrize("s", [2, 4])          # DDIM, DDPM (step noise)
def test_remat_diffusion_draws_once(s):
    cfg = _diffusion_cfg(s)
    base = build_model(cfg)
    batch = fake_sample_batch(2, CROP, 3, seed=4)
    runs = []
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        model = copy.deepcopy(base)
        state = create_train_state(model, c)
        g = torch.Generator().manual_seed(2)
        state, losses = make_train_step(model, c)(state, batch, generator=g)
        runs.append(({k: float(v) for k, v in losses.items()},
                     export_flax_variables(model), g.get_state()))
    (lp, vp, gp), (lr, vr, gr) = runs
    assert lp == lr and "loss_diffusion" in lp
    _assert_same(vp, vr)
    assert torch.equal(gp, gr)


@pytest.mark.parametrize("s", [2, 4])
def test_draws_made_ahead_are_the_forwards_own(s):
    """The forward drawing from a generator, and the forward taking
    ``model.draws`` of the same generator, give the same output and leave
    the generator in the same state."""
    model = build_model(_diffusion_cfg(s)).train()
    batch = fake_sample_batch(2, CROP, 3, seed=5)
    args = (batch["image_crop"], batch["camera_intrinsic_matrix"],
            batch["keypoint_scale"], batch["keypoint_xyz_root"],
            batch["keypoint_xyz21_rel_normed"].reshape(2, 1, -1))
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    with torch.no_grad():
        own = model(*args, generator=g1)
        ahead = model(*args, **model.draws(2, g2))
    for name in ("xyz", "uv", "diffusion_loss"):
        assert torch.equal(getattr(own, name), getattr(ahead, name)), name
    assert torch.equal(g1.get_state(), g2.get_state())


@pytest.mark.parametrize("name", ["Hand3DPoseNet",
                                  "ThreeHandShapeAndPoseMANO"])
def test_remat_trains_other_trunks(name):
    cfg = Config(model_name=name, input_img_shape=(CROP, CROP),
                 compute_dtype="float32")
    base = build_model(cfg)
    batch = fake_sample_batch(2, CROP, cfg.input_channels, seed=6)
    runs = []
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        model = copy.deepcopy(base)
        state = create_train_state(model, c)
        state, losses = make_train_step(model, c)(state, batch)
        runs.append(({k: float(v) for k, v in losses.items()},
                     export_flax_variables(model)))
    assert runs[0][0] == runs[1][0]
    _assert_same(runs[0][1], runs[1][1])


# ---- steps_per_dispatch ----

def test_multi_step_equals_k_single_steps(flat, raws):
    _, cfg = train_cfgs(CROP, **KW, steps_per_dispatch=2)
    single = _fused_run(flat, raws, cfg)
    model, state = torch_train_state(flat, cfg, SPE)
    multi = make_fused_multi_step(model, cfg, None, pp_kwargs(CROP), FLAGS)
    g = torch.Generator().manual_seed(1)
    stack = type(raws[0])(*(torch.stack(xs) for xs in zip(*raws)))
    state, losses = multi(state, stack, generator=g)
    assert state.step == 2
    assert [{k: float(v[i]) for k, v in losses.items()}
            for i in range(2)] == single[0]
    _assert_same(single[1], export_flax_variables(model))
    assert torch.equal(single[2], g.get_state())
    with pytest.raises(ValueError, match="steps_per_dispatch=3"):
        make_fused_multi_step(model, cfg, None, pp_kwargs(CROP), k=3)(
            state, stack)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("rhd"))
    write_synthetic_rhd(root, "training", n=N_TREE, seed=8)
    write_synthetic_rhd(root, "evaluation", n=4, seed=9)
    yield root
    shutil.rmtree(root, ignore_errors=True)


@pytest.fixture
def logs(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _cfg(root, logs, **kw):
    return Config(**dict(dict(
        model_name="Hand3DPosePriorNetwork", input_channels=21,
        dataset_name="RHD", dataset_root_dir=root, batch_size=2,
        infer_batch_size=2, max_epoch=1, input_img_shape=(CROP, CROP),
        compute_dtype="float32", save_log_dir=str(logs),
        coord_uv_noise=True), **kw))


def _counting(worker, name):
    calls = []
    fn = getattr(worker, name)

    def counted(state, batch, **kw):
        calls.append(batch[0].shape[0])
        return fn(state, batch, **kw)

    setattr(worker, name, counted)
    return calls


def test_worker_runs_groups_then_the_tail_one_by_one(tree, logs):
    grouped = Worker(_cfg(tree, logs, steps_per_dispatch=4), device="cpu")
    assert "full groups of 4 steps" in open(grouped.log_path).read()
    groups = _counting(grouped, "multi_step")
    singles = _counting(grouped, "train_step")
    grouped.run_epoch(0, "training")
    assert groups == [4] and singles == [2, 2]        # 6 = 4 + 2
    assert grouped.state.step == 6 and len(grouped.stats.train_seconds) == 6
    one = Worker(_cfg(tree, logs, steps_per_dispatch=1), device="cpu")
    one.run_epoch(0, "training")
    _assert_same(export_flax_variables(one.model),
                 export_flax_variables(grouped.model))


def test_worker_drops_a_buffered_group_at_a_request(tree, logs):
    w = Worker(_cfg(tree, logs, steps_per_dispatch=3), device="cpu")
    guard = w.enable_preemption_save(PreemptionGuard(signals=()))
    batches = w._epoch_batches

    def requesting(split, epoch):
        for idx, b in enumerate(batches(split, epoch)):
            if idx == 4:        # iter 3 is buffered, its group not full
                guard.request()
            yield b

    w._epoch_batches = requesting
    singles = _counting(w, "train_step")
    w.run_epoch(0, "training")
    assert w.state.step == 3 and singles == []
    assert "stopping training at epoch 0 iter 4" in open(w.log_path).read()


def test_fake_data_trains_one_step_at_a_time(logs):
    cfg = Config(model_name="OnlyThreeDimHandPose", input_channels=3,
                 use_fake_data=True, batch_size=2, max_epoch=1,
                 input_img_shape=(CROP, CROP), compute_dtype="float32",
                 save_log_dir=str(logs))
    w = Worker(cfg, device="cpu")
    assert w.multi_step is None
    assert "fake data trains one step at a time" in open(w.log_path).read()


# ---- debug_nans ----

def _poisoned(flat):
    out = dict(flat)
    k = f"params/{POISONED}/kernel"
    out[k] = flat[k].copy()
    out[k][0, 0, 0, 0] = np.nan
    return out


def test_debug_nans_names_the_poisoned_conv_in_both_packages(flat, raws):
    bad = _poisoned(flat)
    jcfg, cfg = train_cfgs(CROP, **KW, debug_nans=True)
    model, state = torch_train_state(bad, cfg, SPE)
    step = make_fused_train_step(model, cfg, None, pp_kwargs(CROP))
    with pytest.raises(FloatingPointError,
                       match=POISONED.replace("/", r"\.") + r" \(Conv"):
        step(state, raws[0])
    assert state.step == 0                      # no update taken
    jmodel, jstate = jax_train_state(bad, jcfg, SPE)
    fn = jax.jit(jgrad_one(jmodel, jcfg, jpreprocess, pp_kwargs(CROP)))
    before = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        with pytest.raises(FloatingPointError):
            fn(jstate.params, jstate.batch_stats, jax_raw(
                seeded_raw(B, RAW, seed=90)), jax.random.PRNGKey(0))
    finally:
        jax.config.update("jax_debug_nans", before)


class _NanGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x * 2

    @staticmethod
    def backward(ctx, g):
        return g * float("nan")


class _Bad(torch.nn.Module):
    def forward(self, x):
        return _NanGrad.apply(x)


def test_debug_nans_names_a_backward_that_makes_one():
    model = torch.nn.Sequential(torch.nn.Linear(3, 3), _Bad(),
                                torch.nn.Linear(3, 1))
    trap = NanTrap(model)
    with pytest.raises(FloatingPointError,
                       match=r"input gradient of 1 \(_Bad\)"):
        with trap.watch():
            model(torch.ones(2, 3)).sum().backward()
    with trap.watch():                  # finite: nothing raised
        model[1] = torch.nn.Identity()
        model(torch.ones(2, 3)).sum().backward()


# ---- fuse_preprocess=False ----

def test_unfused_worker_trains_as_the_fused_one(tree, logs):
    kw = dict(steps_per_dispatch=1, coord_uv_noise=False)
    unfused = Worker(_cfg(tree, logs, fuse_preprocess=False, **kw),
                     device="cpu")
    assert "preprocessing unfused" in open(unfused.log_path).read()
    fused = Worker(_cfg(tree, logs, **kw), device="cpu")
    for w in (unfused, fused):
        w.run_epoch(0, "training")
    assert unfused.state.step == 6
    _assert_same(export_flax_variables(fused.model),
                 export_flax_variables(unfused.model))
    assert unfused.run_epoch(0, "validation") == \
        fused.run_epoch(0, "validation")


def test_unfused_worker_refuses_groups_and_ranks(tree, logs):
    with pytest.raises(ValueError, match="requires fuse_preprocess=True"):
        Worker(_cfg(tree, logs, fuse_preprocess=False), device="cpu")
    with mock.patch.object(distributed, "world", lambda: 2), \
            pytest.raises(ValueError, match="requires the fused step path"):
        Worker(_cfg(tree, logs, fuse_preprocess=False, steps_per_dispatch=1),
               device="cpu")
    assert not os.listdir(logs)
