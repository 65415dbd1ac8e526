"""Eval-mode BatchNorm with its ReLU and residual add as one operator
(``ops/bn_apply_cuda.py``), on the host.

* The registered operator ``torch.ops.handpose_tpu_torch.bn_eval_apply``
  on host tensors, reached through ``BatchNorm.forward`` in eval mode
  under no gradient, equals the expression the BatchNorm applied before
  it existed, then ``residual + y`` and ``relu``, bit for bit: the three
  ``bn_variance`` modes x bfloat16 and float32 x no fusion, the ReLU, the
  residual and the ReLU.
* ``BasicBlock`` and ``BottleneckBlock``, with and without a projection,
  equal the unfused sequence (each BatchNorm, then ``F.relu``, then
  ``F.relu(residual + y)``): in eval mode the outputs, in train mode the
  outputs, every gradient and the running statistics.
* Dispatch: eval mode, no gradient and a 4-D input take the operator,
  whose host path takes any layout and computes in the module's dtype
  (an NCHW-contiguous input, a float32 input to a bfloat16 BatchNorm);
  train mode, a recorded gradient or a (B, C) input take the expression.
* ``bn_fused`` counts each fused apply under a profiler session (20 a
  ResNet-18 forward, 53 a ResNet-50 one) and nothing without one.
"""

import copy
from unittest import mock

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from handpose_tpu_torch.nn import norm
from handpose_tpu_torch.nn.norm import BN_MODES, BatchNorm, make_norm
from handpose_tpu_torch.nn.resnet import (BasicBlock, BottleneckBlock,
                                          ResNet18, ResNet50)
from handpose_tpu_torch.utils import tracing

from _torch_port import port_worker_niced  # noqa: F401

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
FUSIONS = ("none", "relu", "residual_relu")


def _today(bn: BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """The eval-mode apply as ``BatchNorm.forward`` wrote it before the
    operator."""
    shape = (1, -1) + (1,) * (x.ndim - 2)
    mul = (torch.rsqrt(bn.running_var + 1e-5) * bn.weight).reshape(shape)
    y = x.to(torch.float32) - bn.running_mean.reshape(shape)
    bias = bn.bias.reshape(shape)
    if bn.mode == "shifted":
        y, mul, bias = (t.to(bn.dtype) for t in (y, mul, bias))
    return (y * mul + bias).to(bn.dtype)


def _seeded_bn(C, dtype, mode, seed):
    g = torch.Generator().manual_seed(seed)
    bn = BatchNorm(C, dtype, mode).eval()
    with torch.no_grad():
        bn.weight.copy_(torch.rand(C, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(C, generator=g) * 0.1)
        bn.running_mean.copy_(torch.randn(C, generator=g) * 0.5)
        bn.running_var.copy_(torch.rand(C, generator=g) + 0.5)
    return bn


def _cl(t, dtype):
    return t.to(dtype=dtype, memory_format=torch.channels_last)


@pytest.mark.parametrize("fusion", FUSIONS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", BN_MODES)
def test_the_host_operator_is_the_expression(mode, dtype, fusion):
    dt = DTYPES[dtype]
    bn = _seeded_bn(16, dt, mode, seed=3)
    g = torch.Generator().manual_seed(4)
    x = _cl(torch.randn(3, 16, 5, 7, generator=g) * 2 + 0.3, dt)
    res = _cl(torch.randn(3, 16, 5, 7, generator=g), dt)
    residual = res if fusion == "residual_relu" else None
    relu = fusion != "none"
    want = _today(bn, x)
    if residual is not None:
        want = residual + want
    if relu:
        want = F.relu(want)
    with mock.patch.object(norm, "bn_eval_apply",
                           wraps=norm.bn_eval_apply) as op:
        with torch.inference_mode():
            got = bn(x, relu=relu, residual=residual)
    assert op.call_count == 1
    assert got.dtype == dt and got.is_contiguous(
        memory_format=torch.channels_last)
    assert torch.equal(got, want)
    direct = torch.ops.handpose_tpu_torch.bn_eval_apply(
        x, bn.running_mean, bn.running_var, bn.weight, bn.bias, residual,
        relu, mode == "shifted", dt)
    assert torch.equal(direct, want)


def _unfused(block, x):
    """A block's forward as it was written before the fusion."""
    y = F.relu(block.BatchNorm_0(block.Conv_0(x)))
    if isinstance(block, BottleneckBlock):
        y = F.relu(block.BatchNorm_1(block.Conv_1(y)))
        y = block.BatchNorm_2(block.Conv_2(y))
    else:
        y = block.BatchNorm_1(block.Conv_1(y))
    residual = block.norm_proj(block.conv_proj(x)) if block.project else x
    return F.relu(residual + y)


BLOCKS = {"basic_projected": (BasicBlock, 8, 16, 2),
          "basic_identity": (BasicBlock, 16, 16, 1),
          "bottleneck_projected": (BottleneckBlock, 16, 8, 1),
          "bottleneck_identity": (BottleneckBlock, 32, 8, 1)}


@pytest.mark.parametrize("kind", list(BLOCKS))
def test_blocks_equal_the_unfused_sequence(kind):
    cls, cin, filters, stride = BLOCKS[kind]
    dt = torch.bfloat16
    torch.manual_seed(5)
    block = cls(cin, filters, stride, dt, make_norm("fast", dt))
    assert block.project == kind.endswith("projected")
    for i, bn in enumerate(m for m in block.modules()
                           if isinstance(m, BatchNorm)):
        fresh = _seeded_bn(bn.weight.shape[0], dt, "fast", seed=10 + i)
        bn.load_state_dict(fresh.state_dict())
    g = torch.Generator().manual_seed(6)
    x = _cl(torch.randn(2, cin, 8, 8, generator=g), dt)

    block.eval()
    with torch.inference_mode():
        fused = block(x)
    plain = _unfused(block, x).detach()        # grad on: the expression
    assert torch.equal(fused, plain)

    a, b = copy.deepcopy(block).train(), copy.deepcopy(block).train()
    w = torch.randn(fused.shape, generator=g)
    outs = []
    for net, fwd in ((a, lambda n, t: n(t)), (b, _unfused)):
        xi = x.clone().requires_grad_(True)
        out = fwd(net, xi)
        (out.float() * w).sum().backward()
        outs.append((out.detach(), xi.grad))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa.grad, pb.grad), name
    for (name, sa), sb in zip(a.named_buffers(), b.buffers()):
        assert torch.equal(sa, sb), name


@pytest.mark.parametrize("case", ["eval_nograd_channels_last", "train",
                                  "grad_enabled", "nchw_contiguous",
                                  "float32_input", "two_dim"])
def test_dispatch_follows_mode_grad_and_layout(case):
    """The operator is chosen from the mode, the gradient mode and the
    rank alone; on the host it gives the expression for any layout and
    input dtype."""
    dt = torch.bfloat16
    bn = _seeded_bn(16, dt, "fast", seed=7)
    shape = (2, 16) if case == "two_dim" else (2, 16, 4, 4)
    x = torch.randn(*shape).to(torch.float32 if case == "float32_input"
                               else dt)
    if case not in ("nchw_contiguous", "two_dim"):
        x = x.contiguous(memory_format=torch.channels_last)
    if case == "train":
        bn.train()
    grad = torch.enable_grad() if case == "grad_enabled" \
        else torch.inference_mode()
    with mock.patch.object(norm, "bn_eval_apply",
                           wraps=norm.bn_eval_apply) as op, grad:
        y = bn(x, relu=True)
    assert op.call_count == (case not in ("train", "grad_enabled",
                                          "two_dim"))
    if case != "train":
        assert y.dtype == dt
        assert torch.equal(y, F.relu(_today(bn, x)))


def test_bn_fused_counts_each_fused_apply_under_a_profiler_session():
    dt = torch.bfloat16
    x = _cl(torch.randn(1, 3, 32, 32), dt)
    nets = {20: ResNet18(3, dtype=dt).eval(), 53: ResNet50(3, dtype=dt).eval()}
    rec = tracing.RECORDER
    rec.clear()
    try:
        with torch.inference_mode():
            for n, net in nets.items():
                net(x)
                assert rec.counts == {}
                with profile(activities=[ProfilerActivity.CPU]):
                    net(x)
                # keyed by the thread's unit, which earlier spans may set
                assert [k for _, k in rec.counts] == ["bn_fused"]
                assert sum(rec.counts.values()) == n
                rec.clear()
    finally:
        rec.clear()
