"""The dp x tp layout: ``parallel/sharding.py``, ``parallel/dryrun.py`` and
the Worker's ``mesh_shape``, on the CPU under gloo.

In process: the mesh's shape rule and errors against JAX's
``make_dp_tp_mesh``; the layout rule on torch shapes (the output
dimension first), and leaf for leaf equal to JAX's ``param_sharding``
over ``make_dp_tp_mesh(4)`` on the conftest's CPU devices for the
flagship's and ``OnlyThreeDimHandPose``'s variable trees (initialised
with ``jax.eval_shape``, nothing compiled), mapped through
``convert.py``'s names; the Worker's refusals of meshes it cannot lay
out; the checkpoint writer's refusal of a sharded state.

One 4-process job per file (``tests/_torch_shard_worker.py``, one torch
thread each, niced, no JAX in the children), dp 2 x tp 2:

* the meshes of tp 1, 4 and 2 with their groups' ranks, and the
  ``ValueError``s;
* the dry run: the flagship at crop 32, float32, global batch 16 (8 rows
  a data rank, as in ``tests/test_torch_parallel.py``: at 2 rows a data
  rank the step-1 gradient of plain data parallelism, DDP's as much as
  this layout's, is 3.2% of the tree's largest from one process's,
  against a yardstick of 1.7e-4), with JAX's two augmentations: one
  fused step against the port's 1-process step on the same global batch
  and draws, with ``tests/test_torch_parallel.py``'s yardstick (the
  1-process step with every BatchNorm's rows summed in reverse): the
  losses within max(1e-6, 2x the yardstick's) relative, the gradient
  tree gathered whole (after the mean over the data axis) within 2x the
  yardstick's largest leaf error + 1e-6 of the tree's largest gradient,
  and the statistics within 2x the yardstick's + 1e-6 of each leaf's
  range (measured on the host: 3.6e-7, 5.2e-6 and 1.2e-6 against
  4.5e-7, 6.0e-6 and 1.3e-6); two fused steps, every variable and Adam
  moment bit-equal to a 2-rank
  job's at dp 2 x tp 1 (the second job of the file); the
  state gathered whole bit-equal on all four ranks; each sharded
  parameter stored as exactly O/tp rows, and a rank's parameters and
  Adam moments exactly the replicated bytes less half the sharded ones;
* a Worker with ``mesh_shape=(2, 2)``: one epoch on the RHD tree, padded
  validation one MPJPE on every rank, equal (1e-9 relative) to the
  1-process eval step over the two data shards summed in float64; only
  rank 0 writes.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch
from torch import nn

from handpose_tpu.parallel.sharding import make_dp_tp_mesh as jmake_mesh
from handpose_tpu.parallel.sharding import param_sharding as jrule
from handpose_tpu_torch.config import Config
from handpose_tpu_torch.convert import export_flax_variables, flax_path
from handpose_tpu_torch.data.rhd import RHDDataset, write_synthetic_rhd
from handpose_tpu_torch.infer import Evaluator
from handpose_tpu_torch.infer.evaluator import serving_kwargs
from handpose_tpu_torch.models import build_model
from handpose_tpu_torch.ops import moments
from handpose_tpu_torch.parallel import HostShardSampler
from handpose_tpu_torch.parallel.dryrun import (JAX_AUGMENTATIONS,
                                                dryrun_config, dryrun_inputs)
from handpose_tpu_torch.parallel.sharding import (
    DpTpMesh, TensorParallel, dp_tp_shape, make_dp_tp_mesh, output_dim,
    param_sharding, shard_train_state)
from handpose_tpu_torch.train import Worker, create_train_state
from handpose_tpu_torch.train.checkpoints import save_checkpoint
from handpose_tpu_torch.train.steps import make_fused_train_step

from _torch_port import flax_weights, max_rel_err, torch_raw
from _torch_port import port_worker_niced  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_shard_worker.py")
CROP, BATCH, WORLD = 32, 16, 4
N_TREE, WORKER_BATCH = 10, 4


def _worker_cfg(root, **kw):
    return dict(model_name="Hand3DPosePriorNetwork", input_channels=21,
                dataset_name="RHD", dataset_root_dir=root,
                batch_size=WORKER_BATCH, infer_batch_size=WORKER_BATCH,
                max_epoch=1, input_img_shape=[CROP, CROP],
                compute_dtype="float32", steps_per_dispatch=1,
                coord_uv_noise=True, mesh_shape=[2, 2],
                mesh_axis_names=["data", "model"], **kw)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Job:
    """A running gloo job, waited for by :meth:`result`, so that the
    tests' own work overlaps it."""

    def __init__(self, work, world, parts, **spec):
        self.work, self.world, self.outs = work, world, None
        os.makedirs(work, exist_ok=True)
        with open(os.path.join(work, "job.json"), "w") as f:
            json.dump(dict(spec, world=world, parts=parts, workdir=work), f)
        port = _free_port()
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["OMP_NUM_THREADS"] = "1"
        self.procs = [subprocess.Popen(
            [sys.executable, WORKER, str(port), str(rank), work],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env) for rank in range(world)]

    def result(self):
        """({rank: (json, arrays)}, workdir)."""
        if self.outs is None:
            for p in self.procs:
                try:
                    _, err = p.communicate(timeout=600)
                except subprocess.TimeoutExpired:
                    self.kill()
                    raise
                assert p.returncode == 0, f"rank failed:\n{err[-4000:]}"
            self.outs = {}
            for r in range(self.world):
                with open(os.path.join(self.work, f"rank{r}.json")) as f:
                    self.outs[r] = json.load(f), dict(np.load(os.path.join(
                        self.work, f"rank{r}.npz")))
        return self.outs, self.work

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """The running jobs: ``4``, dp 2 x tp 2 (every part), and ``2``, dp 2
    x tp 1 (the two-step dry run only)."""
    work = str(tmp_path_factory.mktemp("shard"))
    rhd = os.path.join(work, "rhd")
    for split, seed in (("training", 1), ("evaluation", 2)):
        write_synthetic_rhd(rhd, split, n=N_TREE, seed=seed)
    spec = dict(crop=CROP, batch=BATCH, worker_cfg=_worker_cfg(rhd))
    running = {4: _Job(os.path.join(work, "w4"), 4,
                       ["meshes", "dryrun1", "dryrun", "worker"], **spec),
               2: _Job(os.path.join(work, "w2"), 2, ["dryrun"], **spec)}
    try:
        yield running
    finally:
        for j in running.values():
            j.kill()
        shutil.rmtree(work, ignore_errors=True)


@pytest.fixture(scope="module")
def job(jobs):
    """The 4-rank job."""
    return jobs[4]


# ---- the 4-process job ----

def _one_process(steps, reverse=False):
    """The port's 1-process fused step, ``steps`` times, on the dry run's
    global batch and draws: (losses, the first step's gradients,
    variables); with ``reverse`` each BatchNorm sums its rows in reverse
    order."""
    cfg = dryrun_config(CROP, BATCH)
    model = build_model(cfg)
    state = create_train_state(model, cfg, 4)
    step = make_fused_train_step(model, cfg, None, serving_kwargs(cfg),
                                 {f: True for f in JAX_AUGMENTATIONS})
    g = torch.Generator().manual_seed(1)
    raw = dryrun_inputs(BATCH)
    sums = ((lambda x2d, shift: moments.shifted_moments(x2d.flip(0), shift))
            if reverse else moments._moments)
    losses, grads = [], None
    with mock.patch.object(moments, "_moments", sums):
        for i in range(steps):
            state, ls = step(state, raw, generator=g)
            losses.append({k: float(v) for k, v in ls.items()})
            if i == 0:
                grads = export_flax_variables(model, grads=True)
    return losses, grads, export_flax_variables(model)


def _of(arrays, prefix):
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


def _drifts(losses, grads, variables, o_losses, o_grads, o_vars):
    """(loss, gradient, statistics) errors of the other run after one
    step: relative, as a share of the tree's largest gradient, of each
    leaf's range."""
    scale = max(np.abs(v).max() for v in grads.values())
    return (max(abs(o_losses[0][k] - v) / abs(v)
                for k, v in losses[0].items()),
            max(np.abs(o_grads[p] - g).max() for p, g in grads.items())
            / scale,
            max(max_rel_err(v, o_vars[p]) for p, v in variables.items()
                if p.startswith("batch_stats/")))


def test_dryrun_on_four_ranks_matches_one_process_after_a_step(job):
    """``tests/test_torch_parallel.py``'s rule: after one step the losses
    within max(1e-6, 2x the yardstick's), the gradient tree within 2x the
    yardstick's + 1e-6 of the tree's largest gradient and the statistics
    within 2x the yardstick's + 1e-6 of each leaf's range."""
    losses, grads, variables = _one_process(1)
    r_losses, r_grads, r_vars = _one_process(1, reverse=True)
    outs, _ = job.result()
    j0, a0 = outs[0]
    got, got_grads = _of(a0, "var1/"), _of(a0, "grad1/")
    assert sorted(got) == sorted(variables)
    assert sorted(got_grads) == sorted(grads)
    yard = _drifts(losses, grads, variables, r_losses, r_grads, r_vars)
    ours = _drifts(losses, grads, variables, j0["dryrun1"]["losses"],
                   got_grads, got)
    assert ours[0] <= max(1e-6, 2 * yard[0]), (ours, yard)
    assert ours[1] <= 2 * yard[1] + 1e-6, (ours, yard)
    assert ours[2] <= 2 * yard[2] + 1e-6, (ours, yard)
    assert j0["dryrun"]["losses"][0] == j0["dryrun1"]["losses"][0]


def test_tensor_parallel_steps_equal_data_parallel_bit_for_bit(jobs):
    """Two steps at dp 2 x tp 2 equal dp 2 x tp 1 bit for bit: the model
    axis changes no arithmetic.  Both are ``parallel/dryrun.py``'s
    ``TensorParallel`` step, tp 1 with no shards (its gradients averaged
    by ``all_reduce_gradients``, not DDP); the first step of dp 2 x tp 2,
    gradients included, is held to one process above.  (Two steps
    against one process are not held here: after the second step this
    layout misses ``assert_trajectory_close`` by 0.040 of range on the
    stem BatchNorm's bias, whose gradient is rounding noise, since
    Adam's first update is +-lr on every such element; the yardstick
    does not reorder the weight gradients' batch sums, which data
    parallelism does.)"""
    (j4, a4), (j2, a2) = jobs[4].result()[0][0], jobs[2].result()[0][0]
    assert j4["dryrun"]["mesh"] == {"data": 2, "model": 2}
    assert j2["dryrun"]["mesh"] == {"data": 2, "model": 1}
    assert j2["dryrun"]["shard_rows"] == {}
    assert j4["dryrun"]["losses"] == j2["dryrun"]["losses"]
    assert j4["dryrun"]["step"] == j2["dryrun"]["step"] == 2
    assert sorted(k for k in a4 if not k.startswith(("var1/", "grad1/"))
                  ) == sorted(a2)
    for k, v in a2.items():
        np.testing.assert_array_equal(a4[k], v, err_msg=k)


def test_four_ranks_hold_the_same_state_bit_for_bit(job):
    outs, _ = job.result()
    a0 = outs[0][1]
    assert any(k.startswith("adam/") for k in a0)
    for r in range(1, WORLD):
        assert outs[r][0]["dryrun"]["losses"] == outs[0][0]["dryrun"][
            "losses"]
        assert sorted(outs[r][1]) == sorted(a0)
        for k, v in a0.items():
            np.testing.assert_array_equal(outs[r][1][k], v, err_msg=k)


def test_each_rank_stores_exactly_its_rows(job):
    outs, _ = job.result()
    cfg = dryrun_config(CROP, BATCH)
    whole = dict(build_model(cfg).named_parameters())
    for r in range(WORLD):
        d = outs[r][0]["dryrun"]
        rows = d["shard_rows"]
        assert rows and all(kept * 2 == full for kept, full in rows.values())
        sharded = sum(whole[n].numel() * 4 for n in rows)
        assert d["replicated"]["params"] == sum(
            p.numel() * 4 for p in whole.values())
        assert d["stored"]["params"] == d["replicated"]["params"] \
            - sharded // 2
        assert d["stored"]["adam"] == 2 * d["stored"]["params"]
        assert d["replicated"]["adam"] == 2 * d["replicated"]["params"]


def test_meshes_and_their_groups_on_four_ranks(job):
    outs, _ = job.result()
    for r in range(WORLD):
        m = outs[r][0]["meshes"]
        assert m["1"] == {"shape": {"data": 4, "model": 1}, "index": [r, 0],
                          "data": [0, 1, 2, 3], "model": [r]}
        assert m["4"] == {"shape": {"data": 1, "model": 4}, "index": [0, r],
                          "data": [r], "model": [0, 1, 2, 3]}
        d, i = divmod(r, 2)
        assert m["None"] == {"shape": {"data": 2, "model": 2},
                             "index": [d, i], "data": [i, i + 2],
                             "model": [2 * d, 2 * d + 1]}
        errors = outs[r][0]["mesh_errors"]
        assert errors["8,None"] == "need 8 devices, have 4"
        assert "over every rank" in errors["2,None"]
        assert errors["4,3"] == "tp=3 does not divide n_devices=4"


def test_mesh_worker_validates_on_the_data_axis_exactly(job):
    outs, work = job.result()
    ws = [outs[r][0]["worker"] for r in range(WORLD)]
    assert len({w["val_mpjpe"] for w in ws}) == 1
    assert [(w["dp"], w["data_rank"], w["step"]) for w in ws] == [
        (2, 0, 2), (2, 0, 2), (2, 1, 2), (2, 1, 2)]
    rhd = os.path.join(os.path.dirname(work), "rhd")
    cfg = Config.from_json(json.dumps(_worker_cfg(rhd))).replace(
        save_log_dir=os.path.join(work, "ref"))
    ev = Evaluator(cfg, weights=os.path.join(ws[0]["run_dir"], "checkpoint"),
                   device="cpu")
    ds = RHDDataset(rhd, "evaluation")
    total = count = 0.0
    for r in (0, 1):
        sampler = HostShardSampler(len(ds), WORKER_BATCH, r, 2,
                                   shuffle=False, seed=cfg.seed)
        for idx, valid in sampler.local_batches_padded(0):
            raw = ds.raw_batch(idx)
            raw = raw._replace(keypoint_vis=raw.keypoint_vis
                               * valid[:, None])
            m = ev.eval_step(torch_raw(raw._asdict()))
            total += float(m["mpjpe_sum"])
            count += float(m["mpjpe_count"])
    want = total / count
    assert abs(ws[0]["val_mpjpe"] - want) <= 1e-9 * want


def test_mesh_worker_writes_on_rank_0_only(job):
    outs, work = job.result()
    ws = [outs[r][0]["worker"] for r in range(WORLD)]
    assert [w["wrote"] for w in ws] == [True, False, False, False]
    assert all(not os.path.exists(os.path.join(work, f"logs{r}"))
               for r in (1, 2, 3))


# ---- in process ----

@pytest.mark.parametrize("n", [8, 4, 2, 1])
def test_mesh_shape_rule_equals_jax(n):
    want = jmake_mesh(n).shape
    assert dp_tp_shape(n) == (want["data"], want["model"])


def test_mesh_errors_and_the_single_process_mesh():
    mesh = make_dp_tp_mesh()
    assert mesh.shape == {"data": 1, "model": 1}
    assert (mesh.data_group, mesh.model_group) == (None, None)
    with pytest.raises(ValueError, match="need 1024 devices, have 1"):
        make_dp_tp_mesh(1024)
    with pytest.raises(ValueError, match="does not divide"):
        dp_tp_shape(6, tp=4)
    with pytest.raises(ValueError):
        jmake_mesh(1024)


def test_param_rule_layouts_in_torch_order():
    mesh = DpTpMesh(dp=4, tp=2)
    wide = torch.zeros(128, 16, 3, 3)                 # conv OIHW
    assert param_sharding(mesh, wide) == ("model", None, None, None)
    dense = torch.zeros(64, 256)                      # linear (out, in)
    assert param_sharding(mesh, dense) == ("model", None)
    conv1d = torch.zeros(64, 16, 3)                   # conv1d (O, I, K)
    assert param_sharding(mesh, conv1d) == ("model", None, None)
    assert param_sharding(mesh, torch.zeros(128)) == ()   # 1-D
    assert param_sharding(mesh, torch.zeros(63, 16)) == ()  # odd width
    assert param_sharding(mesh, torch.zeros(32, 16)) == ()  # too narrow
    assert param_sharding(DpTpMesh(dp=8, tp=1), wide) == ()
    g = torch.zeros(1, 1, 64)                         # a leaf in flax order
    assert param_sharding(mesh, g, out_dim=2) == (None, None, "model")


# the torch axes of a flax kernel's axes (convert.py's transposes)
_FLAX_AXES = {4: (2, 3, 1, 0), 3: (2, 1, 0), 2: (1, 0)}


@pytest.mark.parametrize("model,channels", [
    ("Hand3DPosePriorNetwork", 21), ("OnlyThreeDimHandPose", 3)])
def test_rule_equals_jax_leaf_for_leaf(model, channels):
    flat = flax_weights(CROP, channels, model=model)
    jmesh = jmake_mesh(4)
    net = build_model(Config(model_name=model, input_channels=channels,
                             input_img_shape=(CROP, CROP),
                             compute_dtype="float32"))
    mesh = DpTpMesh(dp=2, tp=2)
    params = {flax_path(net, n): (n, p) for n, p in net.named_parameters()}
    assert sorted(params) == sorted(k for k in flat
                                    if k.startswith("params/"))
    n_sharded = 0
    for path, (name, p) in params.items():
        spec = param_sharding(mesh, p, out_dim=output_dim(net, name, p))
        if spec and path.endswith("/kernel"):
            spec = tuple(spec[i] for i in _FLAX_AXES[p.ndim])
        assert spec == tuple(jrule(jmesh, flat[path]).spec), path
        n_sharded += bool(spec)
    assert n_sharded > 0
    tp_net = TensorParallel(net, mesh)
    assert len(tp_net.shards) == n_sharded


@pytest.mark.parametrize("shape,names", [
    ((2, 2), ("data", "model")), ((2,), ("data",)),
    ((-1, 3), ("data", "model")), ((1, 1), ("data", "expert")),
    ((1,), ("data", "model"))])
def test_worker_refuses_a_mesh_it_cannot_lay_out(tmp_path, shape, names):
    cfg = Config(model_name="Hand3DPosePriorNetwork", input_channels=21,
                 use_fake_data=True, input_img_shape=(CROP, CROP),
                 save_log_dir=str(tmp_path), mesh_shape=shape,
                 mesh_axis_names=names)
    with pytest.raises(ValueError, match="mesh_"):
        Worker(cfg, device="cpu")


def test_checkpoint_refuses_a_sharded_state(tmp_path):
    model = nn.Sequential(nn.Linear(8, 64))
    state = create_train_state(model, Config(), 1)
    sharded = shard_train_state(state, DpTpMesh(dp=1, tp=1))
    with pytest.raises(ValueError, match="gather_train_state"):
        save_checkpoint(str(tmp_path), sharded, 1, 1.0, False)
    assert not os.path.exists(tmp_path / "checkpoint")
