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
dtype before the affine step, as ``ShiftedBatchNorm`` does
(``ops.bn_apply_cuda.bn_apply``).  ``forward(x, relu, residual)`` then
adds the block's residual and applies its ReLU.  In eval mode with no
gradient recorded, a (B, C, H, W) input takes the registered operator of
the eval apply: on the card the CUDA kernel (``csrc/bn_apply.cu``), one
pass over x (and the residual) where the expression makes eight, with
the same roundings, which raises for an input it cannot take (not
channels_last, not in the compute dtype); on the host the expression.
Each such apply counts ``bn_fused`` (``utils.tracing.count``).  Every
other call, train mode's among them, runs the expression.  Train mode
then updates the running statistics as flax does, ``ra = 0.9 * ra + 0.1 *
batch``, keeping the biased batch variance (torch ``BatchNorm2d`` keeps
the unbiased one at momentum 0.1).  Parameters are ``weight``/``bias``
(flax ``scale``/``bias``), the buffers ``running_mean``/``running_var``
(flax ``mean``/``var``).

Global statistics (``set_global_stats``, which ``parallel.replicate``
and ``parallel.sharding.TensorParallel`` turn on): in train mode each
rank's sums are all-reduced over the data axis before ``mean``/``var``
are formed (one all-reduce of the packed (2, C) sums a BN, two in
'stable', whose second pass takes the global mean as its shift;
'shifted''s running mean is equal on every rank), through the
differentiable ``parallel.all_reduce_sum``: the batch statistics of the
global batch, as the JAX package's ``psum`` over its sharded batch.
Every data rank holds the same number of rows, so the row count is ``n *
dp`` (``parallel.distributed.data_world``: the world, unless a dp x tp
mesh puts the ranks of one "data" coordinate on the same rows).
``SYNC.all_reduces`` counts them.
"""

from __future__ import annotations

from functools import partial

import torch
from torch import nn

from ..ops.bn_apply_cuda import bn_apply, bn_eval_apply
from ..ops.moments import fused_shifted_moments, rows_view
from ..parallel.distributed import all_reduce_sum, data_world
from ..utils.tracing import count

BN_MODES = ("stable", "fast", "shifted")
MOMENTUM = 0.9          # flax nn.BatchNorm's, on the running value


class _SyncCount:
    """The all-reduces of BatchNorm sums this process issued."""

    def __init__(self):
        self.all_reduces = 0


SYNC = _SyncCount()


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
        self.global_stats = False

    def reset_parameters(self, generator: torch.Generator | None = None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def _sum(self, *sums: torch.Tensor):
        """``sums`` summed over the data axis, packed into one all-reduce,
        with global statistics; else as they are."""
        if not self.global_stats:
            return sums
        SYNC.all_reduces += 1
        return all_reduce_sum(torch.stack(sums)).unbind(0)

    def batch_stats(self, x: torch.Tensor):
        """(mean, var) of the batch (the global batch with global
        statistics), float32 (C,), differentiable."""
        x2d = rows_view(x)
        n = x2d.shape[0] * (data_world() if self.global_stats else 1)
        zero = torch.zeros_like(self.running_mean)
        if self.mode == "shifted":
            shift = self.running_mean.clone()
            s, ss = self._sum(*fused_shifted_moments(x2d, shift))
            mu = s / n
            var = torch.clamp(ss / n - mu * mu, min=0.0)
            return shift + mu, var
        s, ss = fused_shifted_moments(x2d, zero)
        if self.mode == "fast":
            s, ss = self._sum(s, ss)
            mean = s / n
            return mean, torch.clamp(ss / n - mean * mean, min=0.0)
        (s,) = self._sum(s)
        mean = s / n
        _, ss = fused_shifted_moments(x2d, mean)
        (ss,) = self._sum(ss)
        return mean, torch.clamp(ss / n, min=0.0)

    def _fuses(self, x: torch.Tensor) -> bool:
        """Whether the apply of ``x`` takes the eval operator: eval mode,
        no gradient recorded (``serve`` and the Evaluator run under
        ``inference_mode``, export under ``no_grad``) and a (B, C, H, W)
        input; the operator checks the rest."""
        return not self.training and not torch.is_grad_enabled() \
            and x.ndim == 4

    def forward(self, x: torch.Tensor, relu: bool = False,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        """(B, C, H, W) in channels_last memory, or (B, C) -> the same
        shape in ``dtype``; with ``residual``, ``residual + y``; with
        ``relu``, then its ReLU."""
        if self._fuses(x):
            count("bn_fused")
            return bn_eval_apply(x, self.running_mean, self.running_var,
                                 self.weight, self.bias, residual, relu,
                                 self.mode == "shifted", self.dtype)
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
        return bn_apply(x, mean, var, self.weight, self.bias, self.dtype,
                        self.mode == "shifted", residual, relu)


def set_global_stats(model: nn.Module, on: bool = True) -> nn.Module:
    """Turn global (process-group) batch statistics on or off for every
    BatchNorm of ``model``; returns it."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.global_stats = on
    return model


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
