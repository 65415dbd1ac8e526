"""The dp x tp dry run of the flagship's training step.

Port of ``__graft_entry__.py::_dryrun_body``: the production training
program of ``Hand3DPosePriorNetwork``, the fused raw-batch step (device
preprocessing with the scoremap render K1, both ResNet-18 trunks with
every train-mode BatchNorm's sums through K2, the stem pools' backward
through K3, the loss, Adam), with the train state laid out dp x tp by
``shard_train_state`` on the caller's process group (one rank, or none:
a (1, 1) mesh).  Its inputs are the JAX body's: a global raw batch of
``2 * dp`` 80 x 80 frames from a numpy generator seeded 0, with
keypoints projected from plausible 3-D hands, cut to this rank's rows by
its data coordinate; a generator seeded 1 draws the augmentations (JAX's
two, uv noise and scoremap dropout, by default) for the global batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..convert import export_flax_tensors
from ..data.preprocess import RawBatch
from ..device import resolve_device
from ..infer.evaluator import serving_kwargs
from ..models import build_model
from ..train.state import TrainState, create_train_state
from ..train.steps import make_fused_train_step
from . import distributed as dist_
from .mesh import shard_batch
from .sharding import (DpTpMesh, gather_gradients, gather_train_state,
                       make_dp_tp_mesh, shard_train_state, stored_bytes)

# the augmentations of the JAX body's step
JAX_AUGMENTATIONS = ("coord_uv_noise", "scoremap_dropout")


def dryrun_config(crop: int = 64, batch: int = 2, **kw) -> Config:
    """The JAX body's configuration: the flagship on 21 scoremap channels
    at ``crop``, float32, global batch ``batch``, two epochs; ``kw`` are
    further fields."""
    return Config(model_name="Hand3DPosePriorNetwork", input_channels=21,
                  input_img_shape=(crop, crop), batch_size=batch,
                  compute_dtype="float32", max_epoch=2, **kw)


def dryrun_inputs(batch: int) -> RawBatch:
    """The JAX body's global raw batch on the host: ``batch`` random 80 x
    80 images and masks, 42 keypoints per sample drawn around 0.6 m and
    projected with a fixed camera, 70% visible."""
    rng = np.random.default_rng(0)
    frame = 80
    K = np.tile(np.asarray([[80., 0, 40], [0, 80., 40], [0, 0, 1]],
                           np.float32), (batch, 1, 1))
    xyz = (rng.normal(size=(batch, 42, 3)) * 0.05 +
           np.asarray([0, 0, 0.6])).astype(np.float32)
    uvw = np.einsum("bij,bkj->bki", K, xyz)
    return RawBatch(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        rng.integers(0, 255, (batch, frame, frame, 3), dtype=np.uint8),
        rng.integers(0, 34, (batch, frame, frame), dtype=np.uint8),
        (uvw[..., :2] / uvw[..., 2:3]).astype(np.float32),
        rng.uniform(size=(batch, 42)) > 0.3, xyz, K)))


@dataclasses.dataclass
class DryRun:
    """What a rank returns: its mesh, each step's losses, the state
    gathered to full shapes, the first step's gradients gathered whole
    (after the mean over the data axis; flattened flax leaves, as
    ``convert.export_flax_variables(model, grads=True)``), and the bytes of parameters and Adam moments
    it stored sharded (``stored``) against the whole state's
    (``replicated``)."""

    mesh: DpTpMesh
    losses: list
    state: TrainState
    grads: dict
    stored: dict
    replicated: dict
    shard_rows: dict          # {parameter: (rows stored, rows whole)}


def dryrun(crop: int = 64, batch: Optional[int] = None, steps: int = 1,
           augmentations: Sequence[str] = JAX_AUGMENTATIONS,
           device=None) -> DryRun:
    """``steps`` fused train steps of the flagship on the same global raw
    batch (``batch`` rows, default ``2 * dp``) with the state laid out
    over ``make_dp_tp_mesh()`` (every rank of the group, JAX's tp), which
    becomes the process's mesh (``distributed.set_mesh``), on the card
    unless ``device`` says otherwise; every rank of the group calls it.
    Raises ``FloatingPointError`` on a non-finite loss."""
    dev = resolve_device(device)
    mesh = make_dp_tp_mesh()
    dist_.set_mesh(mesh)
    cfg = dryrun_config(crop, batch or 2 * mesh.dp)
    model = build_model(cfg).to(dev)
    state = shard_train_state(create_train_state(model, cfg, 4), mesh)
    raw = shard_batch(dryrun_inputs(cfg.batch_size).to(dev))
    step = make_fused_train_step(state.model, cfg, None, serving_kwargs(cfg),
                                 {f: True for f in augmentations})
    generator = torch.Generator(device=dev).manual_seed(1)
    losses, grads = [], None
    for i in range(steps):
        state, ls = step(state, raw, generator=generator)
        losses.append({k: float(v) for k, v in ls.items()})
        if i == 0:
            grads = export_flax_tensors(state.model.module,
                                        gather_gradients(state.model))
        if not math.isfinite(losses[-1]["loss"]):
            raise FloatingPointError(f"non-finite loss in the dry run's "
                                     f"step {i}: {losses[-1]}")
    stored = stored_bytes(state)
    shard_rows = {p.name: (s.shape[p.out_dim], p.shape[p.out_dim])
                  for p, s in zip(state.model.placed, state.model.shards)}
    state = gather_train_state(state)
    return DryRun(mesh, losses, state, grads, stored, stored_bytes(state),
                  shard_rows)

