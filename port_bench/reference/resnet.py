"""ResNet trunks, BatchNorm and decay MLPs on flax-path weights, plain.

He et al., "Deep Residual Learning for Image Recognition" (arXiv:
1512.03385), with torchvision's widths: ResNet-18 (basic blocks [2, 2, 2,
2]) and ResNet-50 (bottleneck blocks [3, 4, 6, 3], expansion 4), a
64-filter stem (3x3 stride 2, the repository's default ``k3s2``, or
7x7 stride 2), a 3x3 stride-2 max pool, a projection wherever a block
changes shape, the spatial mean and a 1000-way fc.  The heads are the
reference repository's geometric-decay MLPs (``utils/util.py:3-35``):
the width divides by ``divide`` while it stays at least the output's.

Weights are one flat dict keyed by flax paths (``params/<module>/
kernel``, ``batch_stats/<module>/mean``...), the layout in which the
repository's checkpoints interchange: conv kernels (kh, kw, in, out),
dense kernels (in, out).  :func:`trunk_spec` and :func:`mlp_spec` list
the leaves of a trunk and a head with their shapes and roles.

``quant="fp8"`` computes the trunk in float8 where the measured package
computes it in bfloat16: every tensor it passes on rounded to e4m3 and
every gradient flowing back through it to e5m2, each under a per-tensor
scale.  It is the benchmark's control for a configuration that computes
its trunk in bfloat16.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import torch
import torch.nn.functional as F

EPS = 1e-5
Spec = List[Tuple[str, tuple, str]]
BLOCKS = {18: ("BasicBlock", (2, 2, 2, 2), 1),
          50: ("BottleneckBlock", (3, 4, 6, 3), 4)}
STEM_KERNEL = {"k3s2": 3, "k3s2_s2d": 3, "k7s2": 7}


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to the float8 ``dtype`` under a per-tensor scale that
    maps its largest magnitude to the format's largest."""
    top = torch.finfo(dtype).max
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8(torch.autograd.Function):
    """Values rounded to e4m3 on the way forward, gradients to e5m2 on
    the way back (the float8 training recipe)."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


def q(x: torch.Tensor, quant) -> torch.Tensor:
    """``x`` as the trunk holds it: unchanged in float32, rounded (value
    and gradient) under ``quant="fp8"``."""
    return _Fp8.apply(x) if quant == "fp8" else x


def _conv(prefix, cin, cout, k) -> Spec:
    return [(f"params/{prefix}/kernel", (k, k, cin, cout), "conv")]


def _bn(prefix, c) -> Spec:
    return [(f"params/{prefix}/scale", (c,), "bn_scale"),
            (f"params/{prefix}/bias", (c,), "bn_bias"),
            (f"batch_stats/{prefix}/mean", (c,), "bn_mean"),
            (f"batch_stats/{prefix}/var", (c,), "bn_var")]


def _dense(prefix, din, dout) -> Spec:
    return [(f"params/{prefix}/kernel", (din, dout), "dense"),
            (f"params/{prefix}/bias", (dout,), "dense_bias")]


def blocks(depth: int) -> Iterator[tuple]:
    """(name, in channels, filters, stride, expansion) of each block."""
    kind, stages, expansion = BLOCKS[depth]
    cin, i = 64, 0
    for s, count in enumerate(stages):
        for j in range(count):
            f = 64 * 2 ** s
            yield (f"{kind}_{i}", cin, f, 2 if s > 0 and j == 0 else 1,
                   expansion)
            cin, i = f * expansion, i + 1


def trunk_spec(prefix: str, depth: int, in_channels: int,
               stem: str = "k3s2") -> Spec:
    spec = _conv(f"{prefix}/conv_init", in_channels, 64, STEM_KERNEL[stem])
    spec += _bn(f"{prefix}/bn_init", 64)
    cout = 64
    for name, cin, f, stride, ex in blocks(depth):
        p = f"{prefix}/{name}"
        # (in, out, kernel) of the branch's convolutions, each with its BN
        convs = ([(cin, f, 3), (f, f, 3)] if ex == 1 else
                 [(cin, f, 1), (f, f, 3), (f, f * ex, 1)])
        for i, (a, b, k) in enumerate(convs):
            spec += _conv(f"{p}/Conv_{i}", a, b, k) + _bn(f"{p}/BatchNorm_{i}",
                                                           b)
        cout = f * ex
        if stride != 1 or cin != cout:
            spec += (_conv(f"{p}/conv_proj", cin, cout, 1)
                     + _bn(f"{p}/norm_proj", cout))
    return spec + _dense(f"{prefix}/fc", cout, 1000)


def decay_dims(din: int, dout: int, divide: int) -> List[int]:
    dims, d = [din], din
    while d // divide >= dout:
        d //= divide
        dims.append(d)
    return dims + [dout]


def mlp_spec(prefix: str, din: int, dout: int, divide: int) -> Spec:
    dims = decay_dims(din, dout, divide)
    return [leaf for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))
            for leaf in _dense(f"{prefix}/Dense_{i}", a, b)]


def conv(w, path, x, stride, quant=None):
    k = q(w[f"params/{path}/kernel"].permute(3, 2, 0, 1), quant)
    return q(F.conv2d(q(x, quant), k, stride=stride,
                      padding=k.shape[-1] // 2), quant)


def bn(w, path, x, train: bool):
    """BatchNorm over (N, H, W): the batch's mean and biased variance
    (two passes) in train mode, the running ones in eval mode."""
    scale, bias = w[f"params/{path}/scale"], w[f"params/{path}/bias"]
    if train:
        d = x - x.mean((0, 2, 3), keepdim=True)
        var = (d * d).mean((0, 2, 3), keepdim=True)
        return d * (torch.rsqrt(var + EPS) * scale[:, None, None]) \
            + bias[:, None, None]
    return F.batch_norm(x, w[f"batch_stats/{path}/mean"],
                        w[f"batch_stats/{path}/var"], scale, bias, False,
                        0.0, EPS)


def dense(w, path, x, quant=None):
    k, b = w[f"params/{path}/kernel"], w[f"params/{path}/bias"]
    return q(q(x, quant) @ q(k, quant) + q(b, quant), quant)


def trunk(w, prefix: str, depth: int, x, train: bool, quant=None):
    """(B, C, H, W) -> (B, 1000).  Under ``quant`` every tensor the trunk
    passes on is rounded, as the measured package rounds each to its
    compute dtype: convolutions' inputs, kernels and outputs,
    BatchNorm's outputs, the residual sums, the pooled features and the
    fc."""
    def norm(path, v):
        return q(bn(w, path, v, train), quant)

    x = F.relu(norm(f"{prefix}/bn_init",
                    conv(w, f"{prefix}/conv_init", x, 2, quant)))
    x = F.max_pool2d(x, 3, 2, 1)
    for name, cin, f, stride, ex in blocks(depth):
        p = f"{prefix}/{name}"
        if ex == 1:
            y = F.relu(norm(f"{p}/BatchNorm_0",
                            conv(w, f"{p}/Conv_0", x, stride, quant)))
            y = norm(f"{p}/BatchNorm_1", conv(w, f"{p}/Conv_1", y, 1, quant))
        else:
            y = F.relu(norm(f"{p}/BatchNorm_0",
                            conv(w, f"{p}/Conv_0", x, 1, quant)))
            y = F.relu(norm(f"{p}/BatchNorm_1",
                            conv(w, f"{p}/Conv_1", y, stride, quant)))
            y = norm(f"{p}/BatchNorm_2", conv(w, f"{p}/Conv_2", y, 1, quant))
        if stride != 1 or cin != f * ex:
            x = norm(f"{p}/norm_proj",
                     conv(w, f"{p}/conv_proj", x, stride, quant))
        x = F.relu(q(x + y, quant))
    return dense(w, f"{prefix}/fc", q(x.mean((2, 3)), quant), quant)


def mlp(w, prefix: str, x, activation: str, sigmoid: bool):
    i = 0
    while f"params/{prefix}/Dense_{i + 1}/kernel" in w:
        x = dense(w, f"{prefix}/Dense_{i}", x)
        x = F.leaky_relu(x, 0.01) if activation == "LeakyReLU" else F.relu(x)
        i += 1
    x = dense(w, f"{prefix}/Dense_{i}", x)
    return torch.sigmoid(x) if sigmoid else x
