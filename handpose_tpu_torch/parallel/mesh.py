"""Replication and batch sharding over the process group.

Port of ``handpose_tpu/parallel/mesh.py``.  The JAX package lays a
``jax.sharding.Mesh`` over the devices and places arrays on it with
``NamedSharding``; PyTorch has no counterpart of either: here the process
group is the mesh (one rank, one card), a rank holds its rows of each
global batch as plain tensors, and :func:`replicate` keeps the parameters
equal on every rank (``DistributedDataParallel``, whose gradient
all-reduce plays XLA's ``psum``).  By default every
rank is on the "data" axis; ``parallel/sharding.py`` lays out JAX's
("data", "model") mesh over the ranks, and then the ranks that share a
"data" coordinate hold the same rows (``distributed.data_rank``).

The global batch is the data ranks' local batches concatenated in the
order of the data axis.  :func:`shard_batch` takes a rank's rows of a
tensor that spans it (a raw batch, ``AugmentDraws`` or a dict of draws);
with ``microbatches`` k it takes the rank's part of each of k consecutive
microbatches, the layout ``HostShardSampler.local_batches(epoch, k)``
loads.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch
from torch.nn.parallel import DistributedDataParallel

from .distributed import data_rank, data_world


def _rows(x: torch.Tensor, r: int, w: int, k: int, axis: int):
    n = x.shape[axis]
    if n % (w * k):
        raise ValueError(f"batch axis of {n} rows does not split into "
                         f"{k} microbatches over {w} ranks")
    m = n // (w * k)
    parts = [x.narrow(axis, i * w * m + r * m, m) for i in range(k)]
    return parts[0] if k == 1 else torch.cat(parts, axis)


def shard_batch(batch, rank: Optional[int] = None,
                world: Optional[int] = None, microbatches: int = 1,
                axis: int = 0):
    """This rank's rows of ``batch`` (a tensor, a NamedTuple or dict of
    tensors and Nones) along ``axis``.  ``rank``/``world`` default to the
    data axis's (``distributed.data_rank``/``data_world``)."""
    r = data_rank() if rank is None else rank
    w = data_world() if world is None else world

    def one(x):
        return None if x is None else _rows(x, r, w, microbatches, axis)

    if torch.is_tensor(batch):
        return one(batch)
    if isinstance(batch, dict):
        return {k: one(v) for k, v in batch.items()}
    return type(batch)(*(one(v) for v in batch))


def shard_batch_stacked(stack, rank: Optional[int] = None,
                        world: Optional[int] = None):
    """:func:`shard_batch` for a ``steps_per_dispatch`` group: leaves
    shaped (k, B, ...), each step's batch on axis 1."""
    return shard_batch(stack, rank, world, axis=1)


def replicate(model: torch.nn.Module, find_unused_parameters: bool = False
              ) -> DistributedDataParallel:
    """``model`` wrapped for data-parallel training: parameters broadcast
    from rank 0, gradients averaged over every rank, BatchNorm's
    statistics global over the data axis (``nn.norm.set_global_stats``).
    Under a dp x tp mesh the ranks of one data coordinate compute the
    gradient of the same rows, so the mean over the world is the data
    axis's, and every rank gets the same bits of it.  Buffers are not
    broadcast: global BatchNorm's sums (``distributed.data_sum_``) keep
    the running statistics equal on every rank, and a broadcast would
    only hide a divergence.  ``find_unused_parameters`` for a model whose training
    forward leaves parameters without a gradient (the zoo's
    ``trains_every_parameter``), which DDP then looks for every step."""
    from ..nn.norm import set_global_stats
    set_global_stats(model, True)
    device = next(model.parameters()).device
    # the gradient of a 1x1 conv kernel comes back with other strides on
    # its size-1 axes than the kernel's: the same memory order, which DDP
    # flags on every backward
    warnings.filterwarnings(
        "ignore", "Grad strides do not match bucket view strides",
        UserWarning)
    with warnings.catch_warnings():
        # torch 2.13 names broadcast_buffers deprecated, but its successor
        # (forward_sync_buffers) still syncs the buffers at construction
        warnings.filterwarnings("ignore", ".*broadcast_buffers",
                                FutureWarning)
        return DistributedDataParallel(
            model, device_ids=[device] if device.type == "cuda" else None,
            broadcast_buffers=False,
            find_unused_parameters=find_unused_parameters)
