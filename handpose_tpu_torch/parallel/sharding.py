"""The dp x tp layout of the train state over the process group.

Port of ``handpose_tpu/parallel/sharding.py``.  The JAX package jits its
training step over a 2-D ("data", "model") mesh of devices: the batch
sharded over "data", the wide output channels of the kernels over
"model", and XLA inserts the collectives.  Here each rank is one process
with one card, and the layout is written out:

* :func:`make_dp_tp_mesh` lays the ranks out as JAX reshapes its devices,
  (dp, tp) row-major: rank r sits at data index r // tp and model index
  r % tp, with JAX's rule for tp.  Every rank makes one process group per
  model index (the ranks of one "data" column: a data group) and one per
  data index (a model group), once per process group and tp.  A caller
  that trains on the mesh hands it to ``distributed.set_mesh``, which
  lays the process's collectives over rows out on it: BatchNorm's sums,
  the loss gathers, the validation sums, the cut of a batch and the
  sampler's shard.  The ranks of one data index hold the same rows.
* :func:`param_sharding` is JAX's rule on torch's layouts: a tensor of
  two or more dimensions whose output dimension is at least ``min_width``
  wide and divisible by tp is sharded over "model" along that dimension;
  everything else is replicated.  The output dimension of a conv (OIHW,
  or OIK in 1-D) or dense (out, in) weight is dim 0 in torch, flax's
  kernel keeps it last; the other leaves keep flax's layout.
* :func:`shard_train_state` stores each selected parameter as this rank's
  rows (a :class:`TensorParallel` model) and rebuilds Adam over the
  stored tensors, its ``exp_avg`` and ``exp_avg_sq`` cut to the same
  rows; BatchNorm's statistics and the other parameters are replicated.
  :func:`gather_train_state` is its inverse.

A :class:`TensorParallel` model gathers its weights whole over the model
group before each forward (one all-reduce of them all), and the module
computes with the whole weights, in the forward and in ``Remat``'s
recompute alike.  The ranks of a model group compute the same gradient on
the same rows, so each keeps its rows of a sharded weight's gradient and
nothing is summed over "model" (a sum would double it); the shards'
gradients are averaged over the data group that holds their rows, the
replicated parameters' over the data axis as the sums over rows are
(``distributed.data_sum_``: the same bits on every rank of the world),
one flat all-reduce each.  So the state is equal on every rank by
construction, whatever order the card's own sums take, and a rank stores
about 1/tp of the selected parameters and their moments.  Each rank
computes the whole model: the layout saves memory, not time.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from ..convert import flax_path
from ..nn.norm import set_global_stats
from . import distributed as dist_

AXES = ("data", "model")


def dp_tp_shape(n: int, tp: Optional[int] = None) -> tuple:
    """(dp, tp) of a mesh over ``n`` ranks: ``tp=None`` picks JAX's, 2
    when n is even and at least 4, else 1; ``ValueError`` when tp does
    not divide n."""
    if tp is None:
        tp = 2 if (n % 2 == 0 and n >= 4) else 1
    if tp < 1 or n % tp:
        raise ValueError(f"tp={tp} does not divide n_devices={n}")
    return n // tp, tp


@dataclasses.dataclass(frozen=True)
class DpTpMesh:
    """A (dp, tp) layout of the ranks and this rank's place in it:
    ``data_group`` holds the ranks of its model index, ``model_group``
    those of its data index; None where the axis needs no group of its
    own (a data axis of every rank, a model axis of one); ``world_group``
    is the process group the mesh was laid over (None: no group)."""

    dp: int
    tp: int
    data_index: int = 0
    model_index: int = 0
    data_group: object = None
    model_group: object = None
    world_group: object = None

    @property
    def shape(self) -> dict:
        return {"data": self.dp, "model": self.tp}


# the meshes laid over the standing process group, by tp
_MESHES = {"world": None, "by_tp": {}}


def make_dp_tp_mesh(n: Optional[int] = None,
                    tp: Optional[int] = None) -> DpTpMesh:
    """The (dp, tp) mesh over the process group's ``n`` ranks (default:
    all), with JAX's rule for ``tp=None``; without a process group and n
    = 1 it is (1, 1).  Raises ``ValueError`` for more ranks than the group
    has, for fewer (the port lays a mesh over every rank) and for a tp
    that does not divide n.  Every rank calls it at the same point: the
    first call for a tp makes every group, in one order, on every rank,
    and later calls under the same process group return that mesh."""
    have = dist_.world()
    n = have if n is None else n
    if n > have:
        raise ValueError(f"need {n} devices, have {have}")
    if n < have:
        raise ValueError(f"a mesh of {n} of the {have} ranks: the port "
                         "lays its mesh over every rank")
    dp, tp = dp_tp_shape(n, tp)
    world_group = dist.group.WORLD if dist_.is_distributed() else None
    if _MESHES["world"] is not world_group:
        _MESHES["world"], _MESHES["by_tp"] = world_group, {}
    if tp in _MESHES["by_tp"]:
        return _MESHES["by_tp"][tp]
    data_index, model_index = divmod(dist_.rank(), tp)
    data_group = model_group = None
    if tp > 1:
        for m in range(tp):
            group = dist.new_group([d * tp + m for d in range(dp)])
            if m == model_index:
                data_group = group
        for d in range(dp):
            group = dist.new_group([d * tp + m for m in range(tp)])
            if d == data_index:
                model_group = group
    mesh = DpTpMesh(dp, tp, data_index, model_index, data_group,
                    model_group, world_group)
    _MESHES["by_tp"][tp] = mesh
    return mesh


def config_mesh(shape: Sequence[int], axis_names: Sequence[str]
                ) -> DpTpMesh:
    """The mesh of ``cfg.mesh_shape`` over ``cfg.mesh_axis_names``, as the
    JAX Worker's ``make_mesh`` reads them (one -1 takes the ranks the
    other sizes leave): ("data",) puts every rank on the data axis,
    ("data", "model") lays out ``make_dp_tp_mesh(world, tp)``.  Raises
    ``ValueError`` for other axis names, a shape of another length, or a
    shape whose product is not the world."""
    names, shape = tuple(axis_names), list(shape)
    if names not in (AXES[:1], AXES):
        raise ValueError(f"mesh_axis_names {names}: the port lays out "
                         f"{AXES[:1]} or {AXES}")
    n = dist_.world()
    if len(shape) != len(names) or shape.count(-1) > 1 \
            or any(s < 1 and s != -1 for s in shape):
        raise ValueError(f"mesh_shape {tuple(shape)} does not lay out the "
                         f"axes {names}")
    if -1 in shape:
        known = math.prod(s for s in shape if s != -1)
        shape[shape.index(-1)] = n // known
    if math.prod(shape) != n:
        raise ValueError(f"mesh_shape {tuple(shape)} spans "
                         f"{math.prod(shape)} ranks; the world has {n}")
    return make_dp_tp_mesh(n, tp=shape[1] if len(shape) == 2 else 1)


def param_sharding(mesh: DpTpMesh, tensor: torch.Tensor,
                   min_width: int = 64, out_dim: int = 0) -> tuple:
    """JAX's layout rule for one parameter, in torch's layout: the spec
    ``("model", None, ...)`` with "model" at ``out_dim`` (the output
    dimension: 0 for a conv or dense weight) when the tensor has two or
    more dimensions and that one is at least ``min_width`` wide and
    divisible by tp; ``()``, replicated, otherwise."""
    tp = mesh.tp
    if tp > 1 and tensor.ndim >= 2:
        width = tensor.shape[out_dim]
        if width % tp == 0 and width >= min_width:
            spec = [None] * tensor.ndim
            spec[out_dim] = "model"
            return tuple(spec)
    return ()


def output_dim(model: nn.Module, name: str, tensor: torch.Tensor) -> int:
    """The dimension flax's rule reads of ``model``'s parameter ``name``:
    a kernel's output dimension, dim 0 in torch; else the last."""
    if flax_path(model, name).endswith("/kernel"):
        return 0
    return tensor.ndim - 1


class _Placed(NamedTuple):
    """Where a sharded parameter lives in the module."""
    name: str
    owner: nn.Module
    attr: str
    keys: tuple           # the owner's parameter names, in their order
    out_dim: int
    shape: tuple          # the whole parameter's


def _rows(t: torch.Tensor, p: _Placed, index: int, tp: int
          ) -> torch.Tensor:
    """Model rank ``index``'s rows of a whole tensor of ``p``'s shape."""
    rows = p.shape[p.out_dim] // tp
    return t.narrow(p.out_dim, index * rows, rows)


def _gather(tensors: Sequence[torch.Tensor], placed: Sequence[_Placed],
            mesh: DpTpMesh) -> list:
    """Whole tensors from every model rank's rows (``tensors``, this
    rank's): each rank writes its rows of each into zeros and one
    all-reduce over the model group assembles them all, the pattern of
    ``distributed.gather_rows`` (gloo has no CUDA all-gather)."""
    sizes = [math.prod(p.shape) for p in placed]
    flat = tensors[0].new_zeros(sum(sizes))
    whole = [f.view(p.shape) for f, p in zip(flat.split(sizes), placed)]
    for w, t, p in zip(whole, tensors, placed):
        _rows(w, p, mesh.model_index, mesh.tp).copy_(t)
    if mesh.tp > 1:
        dist.all_reduce(flat, group=mesh.model_group)
    return whole


class _GatherWeights(torch.autograd.Function):
    """The whole weights from the shards; the backward keeps this rank's
    rows of each weight's gradient: every rank of the model group
    computed the same gradient on the same rows of the batch."""

    @staticmethod
    def forward(ctx, owner, *shards):
        ctx.owner = owner
        return tuple(_gather(shards, owner.placed, owner.mesh))

    @staticmethod
    def backward(ctx, *grads):
        mesh = ctx.owner.mesh
        return (None,) + tuple(
            _rows(g, p, mesh.model_index, mesh.tp).contiguous()
            for g, p in zip(grads, ctx.owner.placed))


class TensorParallel(nn.Module):
    """``module`` with the parameters :func:`param_sharding` selects
    stored as this rank's rows (``shards``, registered here in place of
    the module's own), gathered whole over the model group at each
    forward; the rest of the module as it is, BatchNorm's statistics
    global over the data axis.  :meth:`all_reduce_gradients` averages
    the gradients over the data axis after the backward (the train step
    calls it).  Only a forward through this wrapper sees the weights."""

    def __init__(self, module: nn.Module, mesh: DpTpMesh,
                 min_width: int = 64):
        super().__init__()
        self.module = module
        self.mesh = mesh
        self.shards = nn.ParameterList()
        placed = []
        for name, p in list(module.named_parameters()):
            out = output_dim(module, name, p)
            if not param_sharding(mesh, p, min_width, out):
                continue
            owner_name, _, attr = name.rpartition(".")
            owner = module.get_submodule(owner_name)
            where = _Placed(name, owner, attr, tuple(owner._parameters),
                            out, tuple(p.shape))
            self.shards.append(nn.Parameter(_rows(
                p.detach(), where, mesh.model_index, mesh.tp).clone(
                    memory_format=torch.contiguous_format)))
            del owner._parameters[attr]
            setattr(owner, attr, None)          # set by each forward
            placed.append(where)
        self.placed = tuple(placed)
        set_global_stats(module, True)

    def forward(self, *args, **kwargs):
        if self.placed:
            whole = _GatherWeights.apply(self, *self.shards)
            for p, w in zip(self.placed, whole):
                setattr(p.owner, p.attr, w)
        return self.module(*args, **kwargs)

    def all_reduce_gradients(self) -> None:
        """Every gradient averaged over the data axis: the replicated
        parameters' in one flat ``distributed.data_sum_`` (the same bits
        on every rank), the shards' in one flat all-reduce over the data
        group that holds their rows; then the gathered weights are let go
        until the next forward."""
        mesh = self.mesh

        def mean(params, reduce):
            if not params:
                return
            flat = reduce(torch.cat([p.grad.reshape(-1) for p in params]))
            flat.div_(mesh.dp)
            for p, g in zip(params, flat.split([p.numel() for p in params])):
                p.grad = g.view_as(p)

        def over_data_group(flat):
            dist.all_reduce(flat, group=mesh.data_group)
            return flat

        if dist_.world() > 1:
            mean([p for p in self.module.parameters() if p.grad is not None],
                 dist_.data_sum_)
        if mesh.dp > 1:
            mean([p for p in self.shards if p.grad is not None],
                 over_data_group)
        for p in self.placed:
            setattr(p.owner, p.attr, None)


def gather_gradients(model: TensorParallel) -> dict:
    """Every gradient of ``model``'s module whole, by its parameter names:
    the replicated parameters' as they are, the shards' gathered over the
    model group.  A collective over the model group: every rank calls
    it."""
    grads = {n: p.grad for n, p in model.module.named_parameters()}
    if model.placed:
        whole = _gather([s.grad for s in model.shards], model.placed,
                        model.mesh)
        grads.update((p.name, w) for p, w in zip(model.placed, whole))
    return grads


def shard_train_state(state, mesh: DpTpMesh, min_width: int = 64):
    """``state`` (a ``train.TrainState``) laid out over ``mesh``: its model
    as a :class:`TensorParallel` model storing this rank's rows of each
    selected parameter, Adam rebuilt over the stored tensors with each
    moment (``exp_avg``, ``exp_avg_sq``) cut to its parameter's rows and
    the replicated parameters' state kept.  The model is changed in
    place; checkpoints take the state only after
    :func:`gather_train_state`."""
    old = state.optimizer
    before = dict(state.model.named_parameters())
    model = TensorParallel(state.model, mesh, min_width)
    opt = type(old)(model.parameters(), **old.defaults)
    for name, p in model.module.named_parameters():
        if before[name] in old.state:
            opt.state[p] = old.state[before[name]]
    for shard, where in zip(model.shards, model.placed):
        st = old.state.get(before[where.name], {})
        opt.state[shard] = {
            k: (_rows(v, where, mesh.model_index, mesh.tp).clone(
                memory_format=torch.contiguous_format)
                if k in ("exp_avg", "exp_avg_sq") else v)
            for k, v in st.items()}
    return dataclasses.replace(state, model=model, optimizer=opt)


def gather_train_state(state):
    """The inverse of :func:`shard_train_state`: the module inside with
    every parameter whole again, in its place and in its order (Adam's
    ``state_dict`` keys the parameters by their order, so a checkpoint
    of it resumes into an unsharded model), and Adam over it with whole
    moments.  A collective over the model group: every rank calls it."""
    tp_model, old = state.model, state.optimizer
    mesh, placed = tp_model.mesh, tp_model.placed
    shards = list(tp_model.shards)
    moments = {}
    with torch.no_grad():
        whole = _gather([s.detach() for s in shards], placed, mesh) \
            if placed else []
        for k in ("exp_avg", "exp_avg_sq"):
            if shards and all(k in old.state.get(s, {}) for s in shards):
                moments[k] = _gather([old.state[s][k] for s in shards],
                                     placed, mesh)
    module = tp_model.module
    for i, (p, w) in enumerate(zip(placed, whole)):
        delattr(p.owner, p.attr)
        p.owner.register_parameter(p.attr, nn.Parameter(w.clone()))
        p.owner._parameters = {k: p.owner._parameters[k] for k in p.keys}
    opt = type(old)(module.parameters(), **old.defaults)
    restored = {p.name: i for i, p in enumerate(placed)}
    for name, p in module.named_parameters():
        if name not in restored:
            if p in old.state:
                opt.state[p] = old.state[p]
            continue
        i = restored[name]
        st = old.state.get(shards[i])
        if st:
            opt.state[p] = {k: (moments[k][i].clone() if k in moments
                                else v) for k, v in st.items()}
    return dataclasses.replace(state, model=module, optimizer=opt)


def stored_bytes(state) -> dict:
    """The bytes a rank stores of ``state``: its optimizer's parameters
    (``params``) and their Adam moments (``adam``)."""
    opt = state.optimizer
    params = [p for g in opt.param_groups for p in g["params"]]
    return {"params": sum(p.numel() * p.element_size() for p in params),
            "adam": sum(v.numel() * v.element_size() for p in params
                        for k, v in opt.state.get(p, {}).items()
                        if k in ("exp_avg", "exp_avg_sq"))}
