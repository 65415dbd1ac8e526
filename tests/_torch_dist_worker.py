"""One rank of the 2-process gloo job of tests/test_torch_parallel.py.

    python tests/_torch_dist_worker.py PORT RANK WORKDIR

Imports torch, numpy and the port only (no JAX, no conftest), one torch
thread, at a lower CPU priority than the suite's workers.  Reads ``WORKDIR/inputs.npz`` and ``WORKDIR/job.json`` (written by
the test), joins the group at ``localhost:PORT`` with
``initialize_distributed`` and runs, in order:

* ``steps``: for each case, the port's fused train step on this rank's
  rows of the global raw batches (``shard_batch`` in the ``grad_accum``
  layout) through ``replicate(model)``, the draws either the injected
  global ones or the generator's; writes each step's losses, the first
  step's gradient tree (after DDP's mean) and the variables after the
  last step;
* ``worker``: a Worker on the RHD tree for one epoch (training, padded
  validation, the checkpoint on rank 0 only);
* ``preempt``: a Worker whose preemption guard only rank 1 trips, inside
  its first step;
* the initialisation's tolerance of a second call, and its refusal of a
  different world.

Writes ``WORKDIR/rank{R}.npz`` (arrays) and ``WORKDIR/rank{R}.json``.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
torch.set_num_threads(1)

from handpose_tpu_torch.config import Config  # noqa: E402
from handpose_tpu_torch.convert import (export_flax_variables,  # noqa: E402
                                        load_flax_variables)
from handpose_tpu_torch.data.preprocess import (AugmentDraws,  # noqa: E402
                                                RawBatch)
from handpose_tpu_torch.models import build_model  # noqa: E402
from handpose_tpu_torch.parallel import (initialize_distributed,  # noqa: E402
                                         replicate, shard_batch)
from handpose_tpu_torch.train import PreemptionGuard, Worker  # noqa: E402
from handpose_tpu_torch.train.state import create_train_state  # noqa: E402
from handpose_tpu_torch.train.steps import make_fused_train_step  # noqa: E402


def _group(inputs: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in inputs.items()
            if k.startswith(prefix)}


def _raw(inputs, i):
    g = _group(inputs, f"raw{i}/")
    return RawBatch(*(torch.from_numpy(g[f]) for f in RawBatch._fields))


def _draws(inputs, i):
    g = _group(inputs, f"draws{i}/")
    return AugmentDraws(*(torch.from_numpy(g[f]) if f in g else None
                          for f in AugmentDraws._fields))


def run_steps(job, inputs, arrays, out):
    flat = _group(inputs, "weights/")
    for case in job["steps"]:
        cfg = Config.from_json(json.dumps(case["cfg"]))
        model = load_flax_variables(build_model(cfg), flat)
        state = create_train_state(model, cfg, job["steps_per_epoch"])
        step = make_fused_train_step(replicate(model), cfg, None,
                                     job["pp_kwargs"], job["flags"])
        g = torch.Generator().manual_seed(job["generator_seed"])
        losses = []
        for i in range(case["steps"]):
            local = shard_batch(_raw(inputs, i), microbatches=cfg.grad_accum)
            kw = (dict(draws=_draws(inputs, i)) if case["draws"] == "given"
                  else dict(generator=g))
            state, ls = step(state, local, **kw)
            losses.append({k: float(v) for k, v in ls.items()})
            if i == 0:
                for k, v in export_flax_variables(model, grads=True).items():
                    arrays[f"{case['name']}/grad/{k}"] = v
        for k, v in export_flax_variables(model).items():
            arrays[f"{case['name']}/var/{k}"] = v
        out[case["name"]] = losses


def run_worker(job, rank, out):
    cfg = Config.from_json(json.dumps(job["worker_cfg"])).replace(
        save_log_dir=os.path.join(job["workdir"], f"logs{rank}"))
    w = Worker(cfg, device="cpu")
    best = w.run()
    out["worker"] = {"val_mpjpe": best, "run_dir": w.run_dir,
                     "step": w.state.step, "wrote": os.path.exists(
                         os.path.join(w.run_dir, "checkpoint"))}


def run_preempt(job, rank, out):
    cfg = Config.from_json(json.dumps(job["worker_cfg"])).replace(
        save_log_dir=os.path.join(job["workdir"], f"preempt{rank}"))
    w = Worker(cfg, device="cpu")
    guard = w.enable_preemption_save(PreemptionGuard(signals=()))
    calls = [0]
    step = w.train_step

    def requesting_step(state, raw, **kw):
        calls[0] += 1
        if rank == 1 and calls[0] == 1:
            guard.request()
        return step(state, raw, **kw)

    w.train_step = requesting_step
    w.run()
    out["preempt"] = {"local_requested": guard.requested,
                      "agreed": w._preempt_now(), "calls": calls[0],
                      "step": w.state.step, "run_dir": w.run_dir,
                      "wrote": os.path.exists(w.run_dir)}


def main():
    port, rank, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    # the job runs beside the suite's workers: yield the CPU to them, at
    # the port's workers' nice value (inherited from a niced test process,
    # or set here)
    os.setpriority(os.PRIO_PROCESS, 0,
                   max(os.getpriority(os.PRIO_PROCESS, 0), 19))
    with open(os.path.join(workdir, "job.json")) as f:
        job = json.load(f)
    inputs = dict(np.load(os.path.join(workdir, "inputs.npz")))
    initialize_distributed(f"localhost:{port}", 2, rank)
    initialize_distributed(f"localhost:{port}", 2, rank)   # tolerated
    out, arrays = {}, {}
    try:
        initialize_distributed(f"localhost:{port}", 3, rank)
        out["other_world"] = "accepted"
    except RuntimeError as e:
        out["other_world"] = str(e)
    run_steps(job, inputs, arrays, out)
    run_worker(job, rank, out)
    run_preempt(job, rank, out)
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
