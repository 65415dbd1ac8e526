"""Geometric-decay MLP.

Port of ``handpose_tpu/nn/mlp.py:16-51`` (reference utils/util.py:3-35):
the hidden width shrinks by ``divide`` per layer while it stays at least
``output_dim``, then a final projection (+ optional sigmoid).  Layers are
named ``Dense_i`` like flax's auto-names.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense


def decay_dims(input_dim: int, output_dim: int, divide: int) -> Sequence[int]:
    dims = []
    d = input_dim
    while d // divide >= output_dim:
        d //= divide
        dims.append(d)
    return dims


_ACTIVATIONS = {
    "ReLU": F.relu,
    "LeakyReLU": lambda v: F.leaky_relu(v, negative_slope=0.01),
    "Tanh": torch.tanh,
}


class DecayMLP(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, divide: int = 4,
                 activation: str = "ReLU", use_sigmoid: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if activation not in _ACTIVATIONS:
            raise ValueError("activation should be ReLU, LeakyReLU or Tanh")
        self.act = _ACTIVATIONS[activation]
        self.use_sigmoid = use_sigmoid
        dims = [input_dim, *decay_dims(input_dim, output_dim, divide),
                output_dim]
        self.layers = []
        for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
            layer = Dense(din, dout, dtype)
            self.add_module(f"Dense_{i}", layer)
            self.layers.append(layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = self.act(layer(x))
        x = self.layers[-1](x)
        return torch.sigmoid(x) if self.use_sigmoid else x
