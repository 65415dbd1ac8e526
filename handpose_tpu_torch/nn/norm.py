"""BatchNorm with flax's names and semantics, in both modes.

Port of ``handpose_tpu/nn/norm.py`` (flax ``nn.BatchNorm`` and
``ShiftedBatchNorm``).  Eval mode (``.eval()``) normalises with the
running statistics; train mode (``.train()``) with the batch statistics,
in one of the JAX package's three variance modes (``cfg.bn_variance``):

* 'fast'    (flax ``use_fast_variance=True``): mean = E[x],
            var = max(E[x^2] - E[x]^2, 0);
* 'stable'  (flax ``use_fast_variance=False``): mean = E[x],
            var = E[(x - mean)^2];
* 'shifted' (``ShiftedBatchNorm``): d = x - running_mean, mean =
            running_mean + E[d], var = max(E[d^2] - E[d]^2, 0).

Every mode takes its sums from ``ops.moments.fused_shifted_moments``
(the CUDA kernel on the card): 'fast' with shift 0, 'shifted' with the
running mean, 'stable' twice (shift 0 for the mean, then the mean as the
shift, so the gradient reaches x through it as in flax).  x is converted
to float32 before the sums.

Both modes compute

    y = (x - mean) * (rsqrt(var + eps) * scale) + bias

in float32 and cast to the compute dtype, as flax ``nn.BatchNorm`` does;
'shifted' casts ``x - mean``, the multiplier and the bias to the compute
dtype before the affine step, as ``ShiftedBatchNorm`` does.  Train mode
then updates the running statistics as flax does, ``ra = 0.9 * ra + 0.1 *
batch``, keeping the biased batch variance (torch ``BatchNorm2d`` keeps
the unbiased one at momentum 0.1).  Parameters are ``weight``/``bias``
(flax ``scale``/``bias``), the buffers ``running_mean``/``running_var``
(flax ``mean``/``var``).
"""

from __future__ import annotations

from functools import partial

import torch
from torch import nn

from ..ops.moments import fused_shifted_moments, rows_view

BN_MODES = ("stable", "fast", "shifted")
MOMENTUM = 0.9          # flax nn.BatchNorm's, on the running value
EPSILON = 1e-5


class BatchNorm(nn.Module):
    def __init__(self, num_features: int, dtype: torch.dtype = torch.float32,
                 mode: str = "fast"):
        super().__init__()
        if mode not in BN_MODES:
            raise ValueError(f"bn_variance {mode!r} not in {BN_MODES}")
        self.dtype = dtype
        self.mode = mode
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def reset_parameters(self, generator: torch.Generator | None = None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def batch_stats(self, x: torch.Tensor):
        """(mean, var) of the batch, float32 (C,), differentiable."""
        x2d = rows_view(x)
        n = x2d.shape[0]
        zero = torch.zeros_like(self.running_mean)
        if self.mode == "shifted":
            shift = self.running_mean.clone()
            s, ss = fused_shifted_moments(x2d, shift)
            mu = s / n
            var = torch.clamp(ss / n - mu * mu, min=0.0)
            return shift + mu, var
        s, ss = fused_shifted_moments(x2d, zero)
        mean = s / n
        if self.mode == "fast":
            return mean, torch.clamp(ss / n - mean * mean, min=0.0)
        _, ss = fused_shifted_moments(x2d, mean)
        return mean, torch.clamp(ss / n, min=0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W) in channels_last memory, or (B, C) -> the same
        shape in ``dtype``."""
        if self.training:
            mean, var = self.batch_stats(x)
            with torch.no_grad():
                m = MOMENTUM
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean.detach())
                self.running_var.copy_(m * self.running_var
                                       + (1 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mul = (torch.rsqrt(var + EPSILON) * self.weight).reshape(shape)
        y = x.to(torch.float32) - mean.reshape(shape)
        bias = self.bias.reshape(shape)
        if self.mode == "shifted":
            # ShiftedBatchNorm casts y, mul and bias to the compute dtype
            # before the affine step (handpose_tpu/nn/norm.py:121-125)
            y, mul, bias = (t.to(self.dtype) for t in (y, mul, bias))
        return (y * mul + bias).to(self.dtype)


# the class the JAX package names for the 'shifted' mode
ShiftedBatchNorm = partial(BatchNorm, mode="shifted")


def make_norm(bn_variance: str, dtype: torch.dtype):
    """The norm-layer factory of every backbone (``handpose_tpu/nn/
    norm.py:make_norm``): ``make_norm(mode, dtype)(num_features)``.  The
    module's ``.train()``/``.eval()`` selects the batch or the running
    statistics, where the JAX factory takes ``train``."""
    if bn_variance not in BN_MODES:
        raise ValueError(f"bn_variance {bn_variance!r} not in {BN_MODES}")
    return partial(BatchNorm, dtype=dtype, mode=bn_variance)
