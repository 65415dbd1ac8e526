"""Data parallelism: ``parallel/`` and the Worker under a process group,
on the CPU under gloo.

One 2-process job per file (``tests/_torch_dist_worker.py``, one torch
thread each, no JAX in the children) runs the flagship at crop 32 on
global raw batches of 16 (8 a rank) with all six augmentations, float32:

* the 2-rank fused step against the port's 1-process step on the same
  global batch, in the three BN modes at ``grad_accum`` 1 and in
  'shifted' (the running mean as the shift) at 2, the draws from one
  generator seed.  The two differ by the order of
  float32 sums (a rank's BatchNorm sums, then the all-reduce); so does
  the 1-process step with every BatchNorm's rows summed in reverse, the
  yardstick (``chip_smoke.py``'s for the kernels).  The first step's
  losses to rtol max(1e-6, 2x the yardstick's), its gradient tree (after
  DDP's mean) to 2x the yardstick's largest leaf error + 1e-6, both as a
  share of the tree's largest gradient, and the BatchNorm statistics to
  2x the yardstick's + 1e-6 of each leaf's range.  Measured on the host:
  losses within 4.7e-7 (yardstick 6.4e-7), gradients 5-7e-6 at
  ``grad_accum`` 1 (yardstick 6-8e-6); a microbatch of 8 at crop 32 runs
  its last BatchNorms over 8 values, and the gradient drifts 1.3% at
  ``grad_accum`` 2 (yardstick 1.3%).  The parameters as
  ``assert_trajectory_close`` holds an Adam step (an element whose
  gradient is rounding noise, such as a bias feeding another BatchNorm,
  steps by +-lr whatever its sign); parameters and statistics bit-equal
  on the two ranks;
* the 2-rank step on JAX's injected draws against JAX's fused step
  sharded over a 2-device slice of the conftest's CPU mesh, the same
  weights (``convert.py``): losses rtol 1e-5 and the variables as
  ``tests/test_torch_train_step.py`` holds a step;
* a Worker (RHD tree, global batch 4): padded validation gives one
  MPJPE, bit-equal on both ranks and equal (1e-9 relative) to the
  1-process eval step over the same padded shards summed in float64,
  and within float32 summation (1e-5) of the Evaluator's whole split;
  only rank 0 writes; its checkpoint resumes a 1-process Worker as a
  resume;
* a preemption request on rank 1 alone stops both ranks at the same
  step boundary, and only rank 0 writes the checkpoint.

In process: ``HostShardSampler`` equals JAX's index for index, and the
microbatch layout of ``shard_batch``/``local_batches`` is JAX's.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from handpose_tpu.data.preprocess import preprocess_batch as jpreprocess
from handpose_tpu.parallel.distributed import HostShardSampler as JSampler
from handpose_tpu.parallel.mesh import make_mesh
from handpose_tpu.parallel.mesh import replicate as jreplicate
from handpose_tpu.parallel.mesh import shard_batch as jshard
from handpose_tpu.train.steps import make_fused_train_step as jmake_step
from handpose_tpu_torch.config import Config
from handpose_tpu_torch.convert import export_flax_variables
from handpose_tpu_torch.data.rhd import RHDDataset, write_synthetic_rhd
from handpose_tpu_torch.infer import Evaluator
from handpose_tpu_torch.ops import moments
from handpose_tpu_torch.parallel import (HostShardSampler, shard_batch,
                                         shard_batch_stacked)
from handpose_tpu_torch.train import Worker
from handpose_tpu_torch.train.checkpoints import load_variables
from handpose_tpu_torch.train.steps import make_fused_train_step

from _torch_port import (AUG_FLAGS, assert_trajectory_close, flax_weights,
                         jax_draws, jax_raw, jax_train_state, jax_variables,
                         max_rel_err, pp_kwargs, seeded_raw, torch_raw,
                         torch_train_state, train_cfgs)
from _torch_port import port_worker_niced  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_dist_worker.py")
CROP, RAW, B, SPE, SEED = 32, 40, 16, 2, 5
FLAGS = {f: True for f in AUG_FLAGS}
KW = dict(compute_dtype="float32", max_epoch=3)
CASES = [("fast", 1, 2), ("stable", 1, 1), ("shifted", 1, 1),
         ("shifted", 2, 1)]
N_TREE, WORKER_BATCH = 10, 4


def _case_name(bn, ga):
    return f"{bn}_ga{ga}"


def _worker_cfg(root):
    return dict(model_name="Hand3DPosePriorNetwork", input_channels=21,
                dataset_name="RHD", dataset_root_dir=root,
                batch_size=WORKER_BATCH, infer_batch_size=WORKER_BATCH,
                max_epoch=1, input_img_shape=[CROP, CROP],
                compute_dtype="float32", steps_per_dispatch=1,
                coord_uv_noise=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def inputs():
    flat = flax_weights(CROP, seed=7)
    raws = [seeded_raw(B, RAW, seed=70 + i) for i in range(2)]
    key = jax.random.PRNGKey(11)
    draws = jax_draws(jax.random.split(key)[0], B, (RAW, RAW), (CROP, CROP))
    return flat, raws, key, draws


class _Job:
    """The 2-process job, started at once and waited for by
    :meth:`result`, so that the tests' own work overlaps it."""

    def __init__(self, procs, work):
        self.procs, self.work, self.outs = procs, work, None

    def result(self):
        """({rank: (json, arrays)}, workdir)."""
        if self.outs is None:
            for p in self.procs:
                try:
                    _, err = p.communicate(timeout=600)
                except subprocess.TimeoutExpired:
                    for q in self.procs:
                        q.kill()
                    raise
                assert p.returncode == 0, f"rank failed:\n{err[-4000:]}"
            self.outs = {}
            for r in (0, 1):
                with open(os.path.join(self.work, f"rank{r}.json")) as f:
                    self.outs[r] = json.load(f), dict(np.load(os.path.join(
                        self.work, f"rank{r}.npz")))
        return self.outs, self.work


@pytest.fixture(scope="module")
def job(inputs, tmp_path_factory):
    """The running 2-process job (:class:`_Job`)."""
    flat, raws, _, draws = inputs
    work = str(tmp_path_factory.mktemp("dist"))
    for split, seed in (("training", 1), ("evaluation", 2)):
        write_synthetic_rhd(os.path.join(work, "rhd"), split, n=N_TREE,
                            seed=seed)
    arrays = {f"weights/{k}": v for k, v in flat.items()}
    for i, raw in enumerate(raws):
        arrays.update({f"raw{i}/{k}": v for k, v in raw.items()})
    arrays.update({f"draws0/{k}": v.numpy()
                   for k, v in draws._asdict().items() if v is not None})
    np.savez(os.path.join(work, "inputs.npz"), **arrays)
    steps = [{"name": _case_name(bn, ga), "steps": n, "draws": "generator",
              "cfg": dict(train_cfgs(CROP, **KW, bn_variance=bn,
                                     grad_accum=ga)[1].__dict__,
                          input_img_shape=[CROP, CROP])}
             for bn, ga, n in CASES]
    steps.append(dict(steps[0], name="given", steps=1, draws="given"))
    spec = {"steps": steps, "pp_kwargs": pp_kwargs(CROP), "flags": FLAGS,
            "generator_seed": SEED, "steps_per_epoch": SPE,
            "worker_cfg": _worker_cfg(os.path.join(work, "rhd")),
            "workdir": work}
    with open(os.path.join(work, "job.json"), "w") as f:
        json.dump(spec, f, default=str)
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(port), str(rank), work],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for rank in (0, 1)]
    try:
        yield _Job(procs, work)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        shutil.rmtree(work, ignore_errors=True)


def _of(arrays, prefix):
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


# ---- in process: the sampler and the batch layout ----

@pytest.mark.parametrize("n,batch,world,shuffle",
                         [(20, 8, 2, True), (10, 4, 2, False),
                          (37, 12, 3, True)])
def test_host_shard_sampler_equals_jax(n, batch, world, shuffle):
    for r in range(world):
        ours = HostShardSampler(n, batch, r, world, shuffle, seed=3)
        ref = JSampler(n, batch, r, world, shuffle, seed=3)
        for epoch in (0, 4):
            assert list(ours.local_batches(epoch)) == \
                list(ref.local_batches(epoch))
            got = list(ours.local_batches_padded(epoch))
            want = list(ref.local_batches_padded(epoch))
            assert [i for i, _ in got] == [i for i, _ in want]
            for (_, v), (_, w) in zip(got, want):
                np.testing.assert_array_equal(v, w)


def test_microbatch_layout_is_jax_grad_accum_split():
    """Rank r's batch under grad_accum k is its part of each of the JAX
    step's k microbatches of the global batch (the ranks' slices in rank
    order); shard_batch takes the same rows of a global tensor."""
    n, batch, world, k = 24, 8, 2, 2
    glob = [sum((c for c in (list(JSampler(n, batch, r, world, True, 1)
                                  .local_batches(0))[s]
                             for r in range(world))), [])
            for s in range(n // batch)]
    x = torch.arange(batch * 3).reshape(batch, 3)
    for r in range(world):
        ours = list(HostShardSampler(n, batch, r, world, True, 1)
                    .local_batches(0, microbatches=k))
        for g, mine in zip(glob, ours):
            micro = np.asarray(g).reshape(k, world, -1)
            assert mine == micro[:, r].reshape(-1).tolist()
        rows = shard_batch(x, r, world, microbatches=k)
        want = x.reshape(k, world, -1, 3)[:, r].reshape(-1, 3)
        assert torch.equal(rows, want)
        stack = torch.stack([x, x + 100])
        assert torch.equal(shard_batch_stacked(stack, r, world),
                           stack[:, r * 4:(r + 1) * 4])
    with pytest.raises(ValueError, match="does not divide"):
        list(HostShardSampler(n, batch, 0, world).local_batches(
            0, microbatches=3))


# ---- the 2-process job ----

def test_two_ranks_match_jax_sharded_over_two_devices(job, inputs):
    """JAX's fused step on a 2-device mesh (one global program, XLA's
    psum) against the two ranks on the draws JAX made."""
    flat, raws, key, _ = inputs
    jcfg, _ = train_cfgs(CROP, **KW)
    jmodel, jstate = jax_train_state(flat, jcfg, SPE)
    mesh = make_mesh(jax.devices()[:2])
    jstate = jstate.replace(
        params=jreplicate(jstate.params, mesh),
        batch_stats=jreplicate(jstate.batch_stats, mesh),
        opt_state=jreplicate(jstate.opt_state, mesh))
    step = jmake_step(jmodel, jcfg, jpreprocess, pp_kwargs(CROP), FLAGS)
    jstate, jm = step(jstate, jshard(jax_raw(raws[0]), mesh), key)
    losses, _, _ = _one_process(inputs, "fast", 1, 1, given=True)
    outs, _ = job.result()
    for r in (0, 1):
        for k, v in jm.items():
            np.testing.assert_allclose(outs[r][0]["given"][0][k], float(v),
                                       rtol=1e-5)
    assert_trajectory_close(jax_variables(jstate),
                            _of(outs[0][1], "given/var/"))
    # the same injected draws in one process give the ranks' step
    for k, v in losses[0].items():
        np.testing.assert_allclose(outs[0][0]["given"][0][k], v, rtol=1e-6)


def _one_process(inputs, bn, ga, n_steps, given=False, reverse=False):
    """The port's 1-process fused step on the global batches; with
    ``reverse`` each BatchNorm sums its rows in reverse order."""
    flat, raws, _, draws = inputs
    _, cfg = train_cfgs(CROP, **KW, bn_variance=bn, grad_accum=ga)
    model, state = torch_train_state(flat, cfg, SPE)
    step = make_fused_train_step(model, cfg, None, pp_kwargs(CROP), FLAGS)
    g = torch.Generator().manual_seed(SEED)
    losses, grads = [], None
    sums = ((lambda x2d, shift: moments.shifted_moments(x2d.flip(0), shift))
            if reverse else moments._moments)
    with mock.patch.object(moments, "_moments", sums):
        for i in range(n_steps):
            kw = dict(draws=draws) if given else dict(generator=g)
            state, ls = step(state, torch_raw(raws[i]), **kw)
            losses.append({k: float(v) for k, v in ls.items()})
            if i == 0:
                grads = export_flax_variables(model, grads=True)
    return losses, grads, export_flax_variables(model)


def _drifts(losses, grads, variables, o_losses, o_grads, o_vars):
    """(loss, gradient, statistics) errors of the other run: relative,
    as a share of the tree's largest gradient, of each leaf's range."""
    scale = max(np.abs(v).max() for v in grads.values())
    return (max(abs(o_losses[k] - v) / abs(v) for k, v in losses.items()),
            max(np.abs(o_grads[p] - g).max() for p, g in grads.items())
            / scale,
            max(max_rel_err(v, o_vars[p]) for p, v in variables.items()
                if p.startswith("batch_stats/")))


@pytest.mark.parametrize("bn,ga,n_steps", CASES)
def test_two_ranks_equal_one_process(job, inputs, bn, ga, n_steps):
    name = _case_name(bn, ga)
    losses, grads, variables = _one_process(inputs, bn, ga, n_steps)
    r_losses, r_grads, r_vars = _one_process(inputs, bn, ga, n_steps,
                                             reverse=True)
    outs, _ = job.result()
    (j0, a0), (j1, a1) = outs[0], outs[1]
    g0 = _of(a0, f"{name}/grad/")
    v0, v1 = _of(a0, f"{name}/var/"), _of(a1, f"{name}/var/")
    assert sorted(g0) == sorted(grads) and sorted(v0) == sorted(variables)
    assert j0[name] == j1[name]
    yard = _drifts(losses[0], grads, variables, r_losses[0], r_grads, r_vars)
    ours = _drifts(losses[0], grads, variables, j0[name][0], g0, v0)
    assert ours[0] <= max(1e-6, 2 * yard[0]), (ours, yard)
    assert ours[1] <= 2 * yard[1] + 1e-6, (ours, yard)
    assert ours[2] <= 2 * yard[2] + 1e-6, (ours, yard)
    for path in v0:               # replicated: bit-equal on the ranks
        np.testing.assert_array_equal(v0[path], v1[path])
    assert_trajectory_close(variables, v0)


def test_padded_validation_is_exact_and_equal_on_both_ranks(job):
    outs, work = job.result()
    w0, w1 = outs[0][0]["worker"], outs[1][0]["worker"]
    assert w0["val_mpjpe"] == w1["val_mpjpe"] and w0["step"] == 2
    cfg = Config.from_json(json.dumps(_worker_cfg(os.path.join(work, "rhd")))
                           ).replace(save_log_dir=os.path.join(work, "ref"))
    weights = os.path.join(w0["run_dir"], "checkpoint")
    ev = Evaluator(cfg, weights=weights, device="cpu")
    ds = RHDDataset(os.path.join(work, "rhd"), "evaluation")
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
    assert abs(w0["val_mpjpe"] - want) <= 1e-9 * want
    assert abs(w0["val_mpjpe"] - ev.evaluate()) <= 1e-5 * want


def test_only_rank_0_writes_and_its_checkpoint_resumes_one_process(job):
    outs, work = job.result()
    w0, w1 = outs[0][0]["worker"], outs[1][0]["worker"]
    assert w0["wrote"] and not w1["wrote"]
    assert not os.path.exists(os.path.join(work, "logs1"))
    assert w1["run_dir"].endswith("nonlead_rank1")
    ckpt = os.path.join(w0["run_dir"], "checkpoint")
    cfg = Config.from_json(json.dumps(_worker_cfg(os.path.join(work, "rhd")))
                           ).replace(save_log_dir=os.path.join(work, "res"),
                                     resume_weight_path=ckpt, max_epoch=2)
    resumed = Worker(cfg, device="cpu")
    assert "as resume; start_epoch=1" in open(resumed.log_path).read()
    assert resumed.start_epoch == 1 and resumed.state.step == 2
    got = export_flax_variables(resumed.model)
    for k, v in load_variables(ckpt).items():
        np.testing.assert_array_equal(got[k], v)


def test_preemption_on_one_rank_stops_both_at_one_boundary(job):
    outs, work = job.result()
    p0, p1 = outs[0][0]["preempt"], outs[1][0]["preempt"]
    assert p1["local_requested"] and not p0["local_requested"]
    assert p0["agreed"] and p1["agreed"]
    assert p0["calls"] == p1["calls"] == 1
    assert p0["step"] == p1["step"] == 1
    saved = torch.load(os.path.join(p0["run_dir"], "checkpoint",
                                    "train_state.pt"), weights_only=True)
    assert saved["epoch"] == 0 and saved["step"] == 1
    assert p0["wrote"] and not p1["wrote"]
    assert not os.path.exists(os.path.join(work, "preempt1"))


def test_initialisation_tolerates_a_second_call_only(job):
    outs, _ = job.result()
    for r in (0, 1):
        assert "already initialised with 2 processes" in \
            outs[r][0]["other_world"]
