"""Process groups, per-rank data sharding and the collectives of the
data-parallel step.

Port of ``handpose_tpu/parallel/distributed.py``.  The JAX package runs
one global SPMD program over every host's devices; here each rank is one
process with one card, joined by ``torch.distributed`` (NCCL on CUDA,
gloo on the CPU).  :func:`initialize_distributed` forms the group,
:class:`HostShardSampler` gives each rank its contiguous shard of every
epoch (index for index the JAX class), and the two differentiable
collectives give the step JAX's global reductions: :func:`all_reduce_sum`
(BatchNorm's sums; its backward all-reduces the incoming gradients, the
VJP of JAX's ``psum``) and :func:`gather_rows` (the rows of every rank, in
rank order, for a loss over the global batch).

The rows of a global batch lie on the mesh's "data" axis.  Without a
dp x tp mesh every rank is on it; once a ``parallel.sharding.DpTpMesh``
is laid out (:func:`set_mesh`), the ranks that share a "data" coordinate
hold the same rows, and :func:`data_rank`/:func:`data_world` (which
``HostShardSampler``, ``mesh.shard_batch`` and BatchNorm's row count
read) give the data coordinate and dp.  A sum over rows
(:func:`all_reduce_sum`, :func:`gather_rows`, :func:`all_reduce_float64`)
is then the data axis's sum with the same bits on every rank of the
world (:func:`data_sum_`): the ranks off the first model index add
zeros to one all-reduce over the world, so the copies on one data
coordinate cannot drift apart, whatever order the card's own sums take.
Their backward runs over the data group.  The preemption flag
(:func:`all_reduce_max_flag`) stays over every rank.

Without a process group every helper is the single-process case: rank 0
of a world of 1, and no collective is issued.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def is_distributed() -> bool:
    """Whether this process belongs to a process group."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world() -> int:
    return dist.get_world_size() if is_distributed() else 1


def is_lead() -> bool:
    """Rank 0 owns the run directory, the logs and the checkpoints."""
    return rank() == 0


_MESH = None        # the mesh of set_mesh


def set_mesh(mesh) -> None:
    """Lay this process's collectives over rows out on ``mesh`` (a
    ``parallel.sharding.DpTpMesh`` of the standing process group; None:
    every rank on the data axis).  ``parallel.dryrun`` and the Worker
    call it; it lapses with the process group that made the mesh."""
    global _MESH
    _MESH = mesh


def _mesh():
    """The mesh of :func:`set_mesh`, while its process group stands."""
    if _MESH is None or not is_distributed() \
            or _MESH.world_group is not dist.group.WORLD:
        return None
    return _MESH


def data_rank() -> int:
    """This rank's coordinate on the data axis."""
    m = _mesh()
    return rank() if m is None else m.data_index


def data_world() -> int:
    """The number of ranks on the data axis (dp)."""
    m = _mesh()
    return world() if m is None else m.dp


def data_group():
    """The process group of this rank's data axis (None: every rank)."""
    m = _mesh()
    return None if m is None else m.data_group


def data_sum_(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed in place over the data axis, the same bits on every
    rank of the world: off the mesh's first model index ``t`` becomes
    zeros, and one all-reduce over the world adds the data axis's terms
    (the other ranks hold copies of them).  Returns ``t``."""
    m = _mesh()
    if m is not None and m.model_index:
        t.zero_()
    dist.all_reduce(t)
    return t


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> None:
    """Join this process to a group (``torch.distributed.
    init_process_group``).

    ``coordinator_address`` is rank 0's ``host:port`` (or a full
    ``tcp://`` URL); without it torchrun's ``MASTER_ADDR``/``MASTER_PORT``,
    ``RANK`` and ``WORLD_SIZE`` are read.  With a single process and
    nothing given (no argument, no ``MASTER_ADDR``) it does nothing.  The
    backend is NCCL where a card is present and gloo on the host, unless
    ``backend`` names one (gloo also reduces CUDA tensors, through the
    host).  A second call with the same world is tolerated; any other
    failure (no coordinator, a rank mismatch) raises rather than leaving
    the run single-process.
    """
    if is_distributed():
        if num_processes is not None and num_processes != world():
            raise RuntimeError(
                f"already initialised with {world()} processes, asked for "
                f"{num_processes}")
        return
    if num_processes in (None, 1) and coordinator_address is None \
            and "MASTER_ADDR" not in os.environ:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    init = "env://"
    if coordinator_address is not None:
        init = (coordinator_address if "://" in coordinator_address
                else f"tcp://{coordinator_address}")
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if backend == "nccl" and torch.cuda.device_count() > 1:
        local = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id)


class HostShardSampler:
    """Deterministic per-rank epoch sharding (``DistributedSampler``'s
    role), the JAX class index for index.

    Every rank sees the same shuffled permutation (seeded ``seed * 100003
    + epoch``) and takes its contiguous slice; lengths are truncated to a
    multiple of the global batch so every step's global batch is full.
    ``process_index``/``process_count`` default to the data axis's
    (:func:`data_rank`, :func:`data_world`): ranks with one "data"
    coordinate load the same rows.
    """

    def __init__(self, dataset_len: int, global_batch_size: int,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None, shuffle: bool = True,
                 seed: int = 0):
        self.n = dataset_len
        self.shuffle = shuffle
        self.seed = seed
        self.rank = (process_index if process_index is not None
                     else data_rank())
        self.world = (process_count if process_count is not None
                      else data_world())
        if global_batch_size % self.world:
            raise ValueError(f"global batch {global_batch_size} does not "
                             f"divide across {self.world} processes")
        self.local_batch = global_batch_size // self.world
        usable = dataset_len - (dataset_len % global_batch_size)
        self.per_host = usable // self.world

    def _order(self, epoch: int) -> np.ndarray:
        order = np.arange(self.n)
        if self.shuffle:
            np.random.default_rng(self.seed * 100003 + epoch).shuffle(order)
        return order

    def epoch_indices(self, epoch: int, process_index: Optional[int] = None
                      ) -> np.ndarray:
        r = self.rank if process_index is None else process_index
        start = r * self.per_host
        return self._order(epoch)[start:start + self.per_host]

    def local_batches(self, epoch: int,
                      microbatches: int = 1) -> Iterator[Sequence[int]]:
        """This rank's index lists, one per step.  With ``microbatches``
        k > 1 (``cfg.grad_accum``) the global batch of a step is the
        ranks' slices in rank order, as in the JAX package, cut into k
        microbatches of consecutive global rows; this rank then gets the
        rank-th part of each microbatch, in order, so that cutting its
        own batch into k gives its share of each global microbatch."""
        if microbatches == 1:
            idx = self.epoch_indices(epoch)
            for s in range(0, len(idx) - self.local_batch + 1,
                           self.local_batch):
                yield idx[s:s + self.local_batch].tolist()
            return
        if self.local_batch % microbatches:
            raise ValueError(f"grad_accum={microbatches} does not divide "
                             f"the local batch {self.local_batch}")
        lb, m = self.local_batch, self.local_batch // microbatches
        shards = [self.epoch_indices(epoch, r) for r in range(self.world)]
        for s in range(0, self.per_host - lb + 1, lb):
            glob = np.concatenate([sh[s:s + lb] for sh in shards])
            micro = glob.reshape(microbatches, self.world, m)
            yield micro[:, self.rank].reshape(-1).tolist()

    def local_batches_padded(self, epoch: int):
        """Whole-split per-rank batches for validation: the epoch order is
        padded (wrap-around) up to a multiple of the global batch so that
        every sample is seen exactly once across ranks, and each chunk
        comes with a validity mask marking the pad duplicates (the
        consumer zeroes their visibility, so the exact MPJPE sums weigh
        each sample once).  Yields ``(indices, valid)``: a
        local_batch-long list and a (local_batch,) bool array."""
        order = self._order(epoch)
        global_batch = self.local_batch * self.world
        pad = (-self.n) % global_batch
        padded = np.concatenate([order, order[:pad]])
        valid = np.concatenate([np.ones(self.n, bool), np.zeros(pad, bool)])
        per_host = len(padded) // self.world
        start = self.rank * per_host
        idx = padded[start:start + per_host]
        v = valid[start:start + per_host]
        for s in range(0, len(idx), self.local_batch):
            yield idx[s:s + self.local_batch].tolist(), \
                v[s:s + self.local_batch]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return data_sum_(x.clone())

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=data_group())
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the data axis, on every rank
    (:func:`data_sum_`); differentiable (the backward sums the data
    group's incoming gradients, JAX's ``psum`` VJP).  Without a process group, ``x`` itself."""
    return _AllReduceSum.apply(x) if is_distributed() else x


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        r, w = data_rank(), data_world()
        ctx.rank, ctx.rows = r, x.shape[0]
        # each rank writes its rows into zeros and the sum assembles them:
        # one all-reduce, which every backend has for CUDA and host
        # tensors (gloo has no CUDA all-gather)
        out = x.new_zeros((w * x.shape[0],) + tuple(x.shape[1:]))
        out[r * x.shape[0]:(r + 1) * x.shape[0]] = x
        return data_sum_(out)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=data_group())
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows]


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every data rank's rows of ``x``, concatenated in the order of the
    data axis, on every rank; differentiable (this rank's gradient is the
    sum over the data axis of the gradient of its rows).  Without a
    process group, ``x`` itself."""
    if not is_distributed():
        return x
    if x.dtype == torch.bool:
        return _GatherRows.apply(x.to(torch.uint8)).bool()
    return _GatherRows.apply(x)


def all_reduce_max_flag(flag: bool, device) -> bool:
    """Whether ``flag`` is set on any rank of the world (``False``
    everywhere unless one sets it); every rank must call it at the same
    point."""
    t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def all_reduce_float64(values: Sequence[float], device) -> list:
    """``values`` summed over the data axis in float64, the same on every
    rank (:func:`data_sum_`)."""
    t = torch.tensor(list(values), dtype=torch.float64, device=device)
    return data_sum_(t).tolist()
