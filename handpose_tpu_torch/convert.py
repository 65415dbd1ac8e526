"""Weights carried across from the JAX package.

The input is the flax model's ``{"params": ..., "batch_stats": ...}``
flattened to ``/``-joined paths with numpy leaves, e.g.

    params/PosePrior_net/backbone/trunk/BasicBlock_0/Conv_0/kernel
    batch_stats/ViewPoint_net/backbone/trunk/bn_init/mean
    params/resnet_extractor/trunk/BottleneckBlock_3/Conv_2/kernel
    params/view_point_predictor/fc_vp_ux/bias

which :func:`flatten_variables` makes from the nested tree and
``np.savez`` stores (the ``--weights`` file of the CLIs).
:func:`export_flax_variables` is the inverse: the port's model (or its
gradients) as the same flat paths.  The port's modules carry flax's
names, so every path names a module; the leaf maps as follows:

* conv ``kernel`` (H, W, I, O) -> ``weight`` (O, I, H, W), and a 1-D
  conv's (K, I, O) -> (O, I, K);
* dense ``kernel`` (in, out) -> ``weight`` (out, in); ``bias`` -> ``bias``;
* BatchNorm and GroupNorm ``scale``/``bias`` -> ``weight``/``bias``, and
  BatchNorm's ``mean``/``var`` -> the ``running_mean``/``running_var``
  buffers (flax keeps the biased variance, which the port's BatchNorm
  reads as it is);
* RMSNorm ``g`` -> ``g``, in flax's (1, 1, C) shape.

Non-persistent buffers (the MANO layer's constants, which the JAX
package keeps outside its variables) are neither filled nor exported.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from .nn.diffusion import GroupNorm
from .nn.norm import BatchNorm

_LEAF = {
    ("params", "kernel"): "weight",
    ("params", "bias"): "bias",
    ("params", "scale"): "weight",
    ("params", "g"): "g",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


# torch name -> (collection, flax leaf); ``weight`` depends on the module
_EXPORT = {"bias": ("params", "bias"), "g": ("params", "g"),
           "running_mean": ("batch_stats", "mean"),
           "running_var": ("batch_stats", "var")}


def flatten_variables(tree: Mapping, prefix: str = "") -> dict:
    """Nested mapping of arrays -> {``a/b/c``: np.ndarray}."""
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten_variables(v, path))
        else:
            flat[path] = np.asarray(v)
    return flat


def _to_torch_layout(name: str, value: np.ndarray) -> np.ndarray:
    if name == "kernel" and value.ndim == 4:
        return value.transpose(3, 2, 0, 1)          # HWIO -> OIHW
    if name == "kernel" and value.ndim == 3:
        return value.transpose(2, 1, 0)             # KIO -> OIK
    if name == "kernel" and value.ndim == 2:
        return value.T                              # (in, out) -> (out, in)
    return value


def _from_torch_layout(leaf: str, value: np.ndarray) -> np.ndarray:
    if leaf == "kernel" and value.ndim == 4:
        return value.transpose(2, 3, 1, 0)          # OIHW -> HWIO
    if leaf == "kernel" and value.ndim == 3:
        return value.transpose(2, 1, 0)             # OIK -> KIO
    if leaf == "kernel" and value.ndim == 2:
        return value.T                              # (out, in) -> (in, out)
    return value


def _variables(model: nn.Module, grads: bool = False) -> dict:
    """{name: tensor} of the parameters and, unless ``grads``, the
    buffers that ``state_dict()`` keeps, in registration order."""
    tensors = dict(model.named_parameters())
    if not grads:
        keep = set(model.state_dict())
        tensors.update((n, t) for n, t in model.named_buffers() if n in keep)
    return tensors


def load_flax_variables(model: nn.Module,
                        flat: Mapping[str, np.ndarray]) -> nn.Module:
    """Copy flattened flax variables into ``model`` in place.

    Raises ``KeyError`` on a path with no tensor in the model or a tensor
    of the model that no path fills, and ``ValueError`` on a shape
    mismatch.  Returns the model.
    """
    targets = _variables(model)
    filled = set()
    for path, value in flat.items():
        parts = path.split("/")
        # ``params/<leaf>`` is a leaf of the model's own top module
        if len(parts) < 2 or (parts[0], parts[-1]) not in _LEAF:
            raise KeyError(f"{path}: not a params/ or batch_stats/ leaf the "
                           "port knows")
        name = ".".join(parts[1:-1] + [_LEAF[(parts[0], parts[-1])]])
        if name not in targets:
            raise KeyError(f"{path}: the model has no {name}")
        value = _to_torch_layout(parts[-1], np.asarray(value))
        tensor = targets[name]
        if tuple(value.shape) != tuple(tensor.shape):
            raise ValueError(f"{path}: shape {value.shape} (torch layout) "
                             f"does not fit {name} {tuple(tensor.shape)}")
        with torch.no_grad():
            tensor.copy_(torch.from_numpy(np.array(value, dtype=np.float32)))
        filled.add(name)
    missing = sorted(set(targets) - filled)
    if missing:
        raise KeyError(f"{len(missing)} model tensors have no flax "
                       f"variable, e.g. {missing[:4]}")
    return model


def export_flax_variables(model: nn.Module, grads: bool = False) -> dict:
    """The model's parameters and BatchNorm statistics as flattened flax
    variables (``params/...`` and ``batch_stats/...``, flax layouts,
    float32 numpy), the inverse of :func:`load_flax_variables`.  With
    ``grads=True``, the ``.grad`` of every parameter instead, under its
    ``params/...`` path (no statistics); a parameter without a gradient
    raises ``ValueError``."""
    tensors = _variables(model, grads)
    if grads:
        for name, tensor in tensors.items():
            if tensor.grad is None:
                raise ValueError(f"{name} has no gradient")
        tensors = {name: tensor.grad for name, tensor in tensors.items()}
    return export_flax_tensors(model, tensors)


def export_flax_tensors(model: nn.Module,
                        tensors: Mapping[str, torch.Tensor]) -> dict:
    """``tensors`` (``model``'s tensor names to tensors of their shapes,
    such as gradients) as flattened flax leaves: float32 numpy, each
    under its name's flax path in flax's layout."""
    flat = {}
    for name, tensor in tensors.items():
        path = flax_path(model, name)
        value = tensor.detach().to("cpu", torch.float32).numpy()
        flat[path] = np.ascontiguousarray(
            _from_torch_layout(path.rpartition("/")[2], value))
    return flat


def flax_path(model: nn.Module, name: str) -> str:
    """The flattened flax path of ``model``'s tensor ``name`` (a
    ``named_parameters``/``named_buffers`` name): a conv or dense
    ``weight`` is a ``kernel``, whose output dimension the port keeps
    first and flax last; every other leaf keeps flax's layout."""
    module_path, _, attr = name.rpartition(".")
    if attr == "weight":
        is_norm = isinstance(model.get_submodule(module_path),
                             (BatchNorm, GroupNorm))
        coll, leaf = "params", "scale" if is_norm else "kernel"
    elif attr in _EXPORT:
        coll, leaf = _EXPORT[attr]
    else:
        raise KeyError(f"{name}: not a tensor the flax model has")
    return "/".join([coll, *module_path.split("."), leaf])
