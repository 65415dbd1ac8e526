"""One rank of a gloo job of tests/test_torch_sharding.py.

    python tests/_torch_shard_worker.py PORT RANK WORKDIR

Imports torch, numpy and the port only (no JAX, no conftest), one torch
thread, at a lower CPU priority than the suite's workers.  Reads
``WORKDIR/job.json`` (written by the test), joins the group of its
``world`` ranks at ``localhost:PORT`` and runs the job's ``parts``, in
this order:

* ``meshes`` (4 ranks): ``make_dp_tp_mesh`` at tp 1, 4 and the default 2, each
  mesh's shape, this rank's coordinates and the ranks of its data and
  model groups (an all-reduce of one-hot rows over each), and the
  ``ValueError``s of 8 ranks, 2 ranks and tp 3;
* ``dryrun1``: ``parallel.dryrun.dryrun`` (the default mesh: dp 2 x tp 2
  on 4 ranks, dp 2 x tp 1 on 2; the flagship at the job's crop,
  float32, the job's global batch), one fused step: its losses, its
  gradients gathered whole and its variables;
* ``dryrun``: the same, two steps: each step's losses, the stored against
  the whole state's bytes, the rows each shard keeps, and the variables
  and Adam moments gathered whole;
* ``worker``: a Worker with ``mesh_shape=(2, 2)`` over ("data", "model")
  on the RHD tree for one epoch (training, padded validation, the
  checkpoint on rank 0 only).

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
from handpose_tpu_torch.convert import export_flax_variables  # noqa: E402
from handpose_tpu_torch.parallel import initialize_distributed  # noqa: E402
from handpose_tpu_torch.parallel.dryrun import dryrun  # noqa: E402
from handpose_tpu_torch.parallel.sharding import (  # noqa: E402
    make_dp_tp_mesh)
from handpose_tpu_torch.train import Worker  # noqa: E402


def members(group, rank, world):
    """The world ranks of ``group`` (None: every rank), in order."""
    t = torch.zeros(world)
    t[rank] = 1.0
    torch.distributed.all_reduce(t, group=group)
    return [int(r) for r in t.nonzero().flatten()]


def run_meshes(job, rank, arrays, out):
    world = job["world"]
    meshes = {}
    for tp in (1, 4, None):
        m = make_dp_tp_mesh(world, tp)
        meshes[str(tp)] = {"shape": m.shape,
                           "index": [m.data_index, m.model_index],
                           "data": members(m.data_group, rank, world),
                           "model": members(m.model_group, rank, world)
                           if m.model_group is not None else [rank]}
    errors = {}
    for n, tp in ((8, None), (2, None), (4, 3)):
        try:
            make_dp_tp_mesh(n, tp)
            errors[f"{n},{tp}"] = "accepted"
        except ValueError as e:
            errors[f"{n},{tp}"] = str(e)
    out["meshes"], out["mesh_errors"] = meshes, errors


def adam_moments(state) -> dict:
    names = {id(p): n for n, p in state.model.named_parameters()}
    return {f"adam/{names[id(p)]}/{k}": v.numpy()
            for p, st in state.optimizer.state.items()
            for k, v in st.items() if k in ("exp_avg", "exp_avg_sq")}


def run_dryrun1(job, rank, arrays, out):
    one = dryrun(crop=job["crop"], batch=job["batch"], steps=1,
                 device="cpu")
    out["dryrun1"] = {"losses": one.losses}
    for k, v in export_flax_variables(one.state.model).items():
        arrays[f"var1/{k}"] = v
    for k, v in one.grads.items():
        arrays[f"grad1/{k}"] = v


def run_dryrun(job, rank, arrays, out):
    run = dryrun(crop=job["crop"], batch=job["batch"], steps=2,
                 device="cpu")
    out["dryrun"] = {"mesh": run.mesh.shape, "losses": run.losses,
                     "stored": run.stored, "replicated": run.replicated,
                     "shard_rows": run.shard_rows,
                     "step": run.state.step}
    for k, v in export_flax_variables(run.state.model).items():
        arrays[f"var/{k}"] = v
    arrays.update(adam_moments(run.state))


def run_worker(job, rank, arrays, out):
    cfg = Config.from_json(json.dumps(job["worker_cfg"])).replace(
        save_log_dir=os.path.join(job["workdir"], f"logs{rank}"))
    w = Worker(cfg, device="cpu")
    best = w.run()
    out["worker"] = {"val_mpjpe": best, "run_dir": w.run_dir,
                     "step": w.state.step, "dp": w.dp,
                     "data_rank": w.data_rank,
                     "wrote": os.path.exists(
                         os.path.join(w.run_dir, "checkpoint"))}


PARTS = {"meshes": run_meshes, "dryrun1": run_dryrun1, "dryrun": run_dryrun,
         "worker": run_worker}


def main():
    port, rank, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    # the job runs beside the suite's workers: yield the CPU to them, at
    # the port's workers' nice value (inherited from a niced test process,
    # or set here)
    os.setpriority(os.PRIO_PROCESS, 0,
                   max(os.getpriority(os.PRIO_PROCESS, 0), 19))
    with open(os.path.join(workdir, "job.json")) as f:
        job = json.load(f)
    initialize_distributed(f"localhost:{port}", job["world"], rank,
                           backend="gloo")
    out, arrays = {}, {}
    for part in job["parts"]:
        PARTS[part](job, rank, arrays, out)
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
