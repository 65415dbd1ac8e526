"""A configuration's weights, made on the device from the seed.

Two draws in all, one normal and one uniform over every leaf at once,
then cut into leaves and scaled by role: convolutions He-normal, dense
kernels LeCun-normal, small random biases, BatchNorm scales in [0.5, 1]
(the last BatchNorm of each residual branch scaled by 1/sqrt(blocks),
so that eval-mode activations, which no batch re-normalises, stay of
order one through the depth), shifts and running means near 0, running
variances in [0.8, 1.2].  Both sides get these same values: the measured
package through its flax-path loader, the reference as they are.
"""

from __future__ import annotations

import math

import torch

_BLOCKS = ("BasicBlock_", "BottleneckBlock_")
_BRANCH_END = ("BatchNorm_1", "BatchNorm_2")     # basic, bottleneck


def _block_counts(spec) -> dict:
    """{trunk path: number of residual blocks}."""
    seen = set()
    for path, _, _ in spec:
        parts = path.split("/")
        if len(parts) > 3 and parts[-3].startswith(_BLOCKS):
            seen.add(("/".join(parts[1:-3]), parts[-3]))
    counts: dict = {}
    for trunk, _ in seen:
        counts[trunk] = counts.get(trunk, 0) + 1
    return counts


def _ends_branch(parts) -> bool:
    block, norm = parts[-3], parts[-2]
    return ((block.startswith("BasicBlock_") and norm == _BRANCH_END[0])
            or (block.startswith("BottleneckBlock_")
                and norm == _BRANCH_END[1]))


def make(spec, generator: torch.Generator) -> dict:
    """{flax path: float32 tensor on ``generator``'s device}."""
    dev = generator.device
    total = sum(math.prod(shape) for _, shape, _ in spec)
    normal = torch.randn(total, generator=generator, device=dev)
    uniform = torch.rand(total, generator=generator, device=dev)
    blocks = _block_counts(spec)
    out, at = {}, 0
    for path, shape, role in spec:
        n = math.prod(shape)
        z = normal[at:at + n].view(shape)
        u = uniform[at:at + n].view(shape)
        at += n
        if role == "conv":
            v = z * math.sqrt(2.0 / math.prod(shape[:-1]))
        elif role == "dense":
            v = z * math.sqrt(1.0 / shape[0])
        elif role == "dense_bias":
            v = z * 0.01
        elif role == "bn_scale":
            v = 0.5 + 0.5 * u
            parts = path.split("/")
            if _ends_branch(parts):
                v = v / math.sqrt(blocks["/".join(parts[1:-3])])
        elif role in ("bn_bias", "bn_mean"):
            v = z * 0.05
        elif role == "bn_var":
            v = 0.8 + 0.4 * u
        else:
            raise ValueError(f"{path}: unknown role {role!r}")
        out[path] = v.contiguous()
    return out
