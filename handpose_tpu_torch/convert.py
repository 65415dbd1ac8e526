"""Weights carried across from the JAX package.

The input is the flax model's ``{"params": ..., "batch_stats": ...}``
flattened to ``/``-joined paths with numpy leaves, e.g.

    params/PosePrior_net/backbone/trunk/BasicBlock_0/Conv_0/kernel
    batch_stats/ViewPoint_net/backbone/trunk/bn_init/mean

which :func:`flatten_variables` makes from the nested tree and
``np.savez`` stores (the ``--weights`` file of the CLIs).
:func:`export_flax_variables` is the inverse: the port's model (or its
gradients) as the same flat paths.  The port's modules carry flax's
names, so every path names a module; the leaf maps as follows:

* conv ``kernel`` (H, W, I, O) -> ``weight`` (O, I, H, W);
* dense ``kernel`` (in, out) -> ``weight`` (out, in); ``bias`` -> ``bias``;
* BatchNorm ``scale``/``bias`` -> ``weight``/``bias``, and ``mean``/``var``
  -> the ``running_mean``/``running_var`` buffers (flax keeps the biased
  variance, which the port's BatchNorm reads as it is).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from .nn.norm import BatchNorm

_LEAF = {
    ("params", "kernel"): "weight",
    ("params", "bias"): "bias",
    ("params", "scale"): "weight",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


# torch name -> (collection, flax leaf); ``weight`` depends on the module
_EXPORT = {"bias": ("params", "bias"),
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
    if name == "kernel" and value.ndim == 2:
        return value.T                              # (in, out) -> (out, in)
    return value


def _from_torch_layout(leaf: str, value: np.ndarray) -> np.ndarray:
    if leaf == "kernel" and value.ndim == 4:
        return value.transpose(2, 3, 1, 0)          # OIHW -> HWIO
    if leaf == "kernel" and value.ndim == 2:
        return value.T                              # (out, in) -> (in, out)
    return value


def load_flax_variables(model: nn.Module,
                        flat: Mapping[str, np.ndarray]) -> nn.Module:
    """Copy flattened flax variables into ``model`` in place.

    Raises ``KeyError`` on a path with no tensor in the model or a tensor
    of the model that no path fills, and ``ValueError`` on a shape
    mismatch.  Returns the model.
    """
    targets = dict(model.named_parameters())
    targets.update(model.named_buffers())
    filled = set()
    for path, value in flat.items():
        parts = path.split("/")
        if len(parts) < 3 or (parts[0], parts[-1]) not in _LEAF:
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
    tensors = list(model.named_parameters())
    if not grads:
        tensors += list(model.named_buffers())
    flat = {}
    for name, tensor in tensors:
        module_path, _, attr = name.rpartition(".")
        if attr == "weight":
            is_bn = isinstance(model.get_submodule(module_path), BatchNorm)
            coll, leaf = "params", "scale" if is_bn else "kernel"
        elif attr in _EXPORT:
            coll, leaf = _EXPORT[attr]
        else:
            raise KeyError(f"{name}: not a tensor the flax model has")
        if grads:
            if tensor.grad is None:
                raise ValueError(f"{name} has no gradient")
            tensor = tensor.grad
        value = tensor.detach().to("cpu", torch.float32).numpy()
        path = "/".join([coll, *module_path.split("."), leaf])
        flat[path] = np.ascontiguousarray(_from_torch_layout(leaf, value))
    return flat
