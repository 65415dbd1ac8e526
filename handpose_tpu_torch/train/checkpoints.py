"""Checkpoints with the reference's filtered resume and finetune.

Port of ``handpose_tpu/train/checkpoints.py:48-155`` (reference
trainval.py:163-212, 589-596).  Each save writes ``<run_dir>/checkpoint/``
and, on a new best validation MPJPE, ``<run_dir>/model_best/``, each
holding:

* ``variables.npz``: params and batch_stats as flattened flax paths
  (``convert.export_flax_variables``), the ``weights`` the Evaluator and
  ``--weights`` take;
* ``train_state.pt``: the epoch to resume at, ``best_mpjpe`` (float32),
  the schedule's count and Adam's ``state_dict``.

Resume keeps the stored params whose path and shape exist in the current
model (``strict=False``) and calls it a finetune unless the key sets are
equal and every key matched; only an exact match restores the batch
statistics, the optimizer, the epoch and the best MPJPE.

The names are the flax names of the model inside whatever wraps it for
training (DDP, ``Remat``): a ``module.`` prefix never reaches
``variables.npz``, where it would turn every resume into a finetune.  In a
data-parallel run the lead rank writes and every rank resumes from the
same directory (the Worker).  A state laid out dp x tp
(``parallel.sharding.shard_train_state``) is refused: gather it whole
first (``gather_train_state``).
"""

from __future__ import annotations

import os
import shutil
from typing import Tuple

import numpy as np
import torch

from ..convert import export_flax_variables, load_flax_variables
from ..parallel.sharding import TensorParallel
from .state import TrainState
from .steps import unwrap

CKPT_LAST = "checkpoint"
CKPT_BEST = "model_best"
VARIABLES = "variables.npz"
TRAIN_STATE = "train_state.pt"


def _write_dir(path: str, state: TrainState, epoch: int,
               best_mpjpe: float) -> None:
    """Both files, each written under a temporary name and renamed, so a
    reader never sees a half-written file."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, VARIABLES + ".tmp.npz")
    np.savez(tmp, **export_flax_variables(unwrap(state.model)))
    os.replace(tmp, os.path.join(path, VARIABLES))
    tmp = os.path.join(path, TRAIN_STATE + ".tmp")
    torch.save({"epoch": int(epoch),
                "best_mpjpe": torch.tensor(best_mpjpe, dtype=torch.float32),
                **state.state_dict()}, tmp)
    os.replace(tmp, os.path.join(path, TRAIN_STATE))


def save_checkpoint(run_dir: str, state: TrainState, epoch: int,
                    best_mpjpe: float, is_best: bool) -> None:
    """Write ``<run_dir>/checkpoint/`` and, when ``is_best``,
    ``<run_dir>/model_best/`` (a copy of it).  Raises ``ValueError`` for a
    state whose parameters are stored sharded."""
    if isinstance(state.model, TensorParallel):
        raise ValueError("a tensor-parallel train state holds this rank's "
                         "rows only: gather_train_state(state) before "
                         "saving it")
    last = os.path.join(run_dir, CKPT_LAST)
    _write_dir(last, state, epoch, best_mpjpe)
    if is_best:
        best = os.path.join(run_dir, CKPT_BEST)
        os.makedirs(best, exist_ok=True)
        for name in (VARIABLES, TRAIN_STATE):
            shutil.copyfile(os.path.join(last, name),
                            os.path.join(best, name + ".tmp"))
            os.replace(os.path.join(best, name + ".tmp"),
                       os.path.join(best, name))


def load_variables(path: str) -> dict:
    """``<path>/variables.npz`` as {flax path: array}."""
    with np.load(os.path.join(path, VARIABLES)) as f:
        return {k: f[k] for k in f.files}


def filtered_resume(state: TrainState, ckpt_path: str
                    ) -> Tuple[TrainState, int, float, bool]:
    """Load a checkpoint into ``state`` (its model in place) with the
    reference's semantics; returns ``(state, start_epoch, best_mpjpe,
    is_finetune)``."""
    loaded = load_variables(ckpt_path)
    model = unwrap(state.model)
    cur = export_flax_variables(model)

    def part(flat, coll):
        return {k: v for k, v in flat.items() if k.startswith(coll + "/")}

    cur_p, loaded_p = part(cur, "params"), part(loaded, "params")
    matched = {k: v for k, v in loaded_p.items()
               if k in cur_p and v.shape == cur_p[k].shape}
    full_match = set(loaded_p) == set(cur_p) and len(matched) == len(cur_p)
    merged = dict(cur)
    merged.update(matched)
    if not full_match:
        load_flax_variables(model, merged)
        return state, 0, float(np.inf), True
    # exact architecture: the reference's resume branch
    # (trainval.py:196-208)
    cur_bs, loaded_bs = part(cur, "batch_stats"), part(loaded, "batch_stats")
    if set(cur_bs) == set(loaded_bs) and all(
            v.shape == cur_bs[k].shape for k, v in loaded_bs.items()):
        merged.update(loaded_bs)
    load_flax_variables(model, merged)
    train = torch.load(os.path.join(ckpt_path, TRAIN_STATE),
                       map_location="cpu", weights_only=True)
    try:
        state.load_state_dict(train)
    except (ValueError, KeyError) as e:
        # a silent reset would mean full-LR Adam with zero moments in the
        # middle of the cosine decay, and nobody knowing why
        print("WARNING: optimizer-state restore failed "
              f"({type(e).__name__}: {e}); resuming epoch/params but with a "
              "FRESH optimizer (moments and schedule count reset)")
    return state, int(train["epoch"]), float(train["best_mpjpe"]), False


def reconcile_schedule_count(state: TrainState, start_epoch: int,
                             steps_per_epoch: int) -> TrainState:
    """Pin the LR schedule's count to the resumed epoch's start.

    The schedule reads its epoch as ``count // steps_per_epoch`` of the
    resuming run; a restored count came from the run that wrote the
    checkpoint, whose steps_per_epoch may differ (another batch size, a
    preemption mid-epoch).  The count becomes ``start_epoch *
    steps_per_epoch``; Adam's per-parameter ``step`` (bias correction)
    keeps the number of updates taken: the JAX package's two counts.
    """
    state.step = start_epoch * steps_per_epoch
    return state
