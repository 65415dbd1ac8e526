"""Port parity: train-mode BatchNorm in all three variance modes.

The port's ``BatchNorm`` in train mode against the JAX package's
``make_norm(mode, train=True, dtype)`` -- flax ``nn.BatchNorm`` with
``use_fast_variance`` True ('fast') or False ('stable'), and
``ShiftedBatchNorm`` ('shifted') -- on the same numpy input, parameters
and running statistics (running mean away from 0, so 'shifted' differs
from 'fast'), in float32 and bfloat16 compute.  Compared: the output y,
the new running mean and variance, and the gradients of sum(w * y) with
respect to x, scale and bias.

Tolerances, each a share of the compared array's range: float32 1e-5
everywhere.  bfloat16: the statistics 1e-5 (both sum the same bf16
values in float32); y and dx 1e-2 (bf16 outputs, where a float32
difference of one ulp in mean or variance flips single roundings); the
scale and bias gradients 1e-3 (float32 sums over those bf16 values),
except in 'shifted', whose affine step runs in bf16 in both packages:
XLA then sums the scale and bias gradients in bf16 over the N*H*W = 144
rows (torch accumulates in float32), so those two are held to 3e-2.

Eval mode, all three modes, against the JAX ``make_norm(mode, train=False,
dtype)``: y to 1e-6 of its range in float32 and exactly in bfloat16 (one
float32 expression rounded once, or, in 'shifted', the same bf16 affine
step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handpose_tpu.nn.norm import make_norm as jmake_norm
from handpose_tpu_torch.nn.norm import BatchNorm, ShiftedBatchNorm, make_norm

from _torch_port import max_rel_err

N, H, W, C = 4, 6, 6, 16


def _setup(seed):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.normal(1.0, 2.0, (N, H, W, C)).astype(np.float32),
        w=rng.normal(size=(N, H, W, C)).astype(np.float32),
        scale=rng.uniform(0.5, 1.5, C).astype(np.float32),
        bias=rng.normal(0.0, 0.1, C).astype(np.float32),
        mean=rng.normal(0.8, 0.3, C).astype(np.float32),
        var=rng.uniform(0.5, 1.5, C).astype(np.float32))


def _jax(mode, dtype, s):
    jd = getattr(jnp, dtype)
    bn = jmake_norm(mode, True, jd)()
    x = jnp.asarray(s["x"]).astype(jd)
    variables = {"params": {"scale": jnp.asarray(s["scale"]),
                            "bias": jnp.asarray(s["bias"])},
                 "batch_stats": {"mean": jnp.asarray(s["mean"]),
                                 "var": jnp.asarray(s["var"])}}

    def loss(x_, params):
        y, upd = bn.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          x_, mutable=["batch_stats"])
        return jnp.sum(jnp.asarray(s["w"]) * y.astype(jnp.float32)), (y, upd)

    (_, (y, upd)), (gx, gp) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(x, variables["params"])
    stats = upd["batch_stats"]
    return dict(y=y, mean=stats["mean"], var=stats["var"], dx=gx,
                dscale=gp["scale"], dbias=gp["bias"])


def _torch(mode, dtype, s):
    td = getattr(torch, dtype)
    bn = make_norm(mode, td)(C).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(s["scale"]))
        bn.bias.copy_(torch.from_numpy(s["bias"]))
        bn.running_mean.copy_(torch.from_numpy(s["mean"]))
        bn.running_var.copy_(torch.from_numpy(s["var"]))
    x = torch.from_numpy(s["x"]).permute(0, 3, 1, 2).to(td).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    y = bn(x)
    w = torch.from_numpy(s["w"]).permute(0, 3, 1, 2)
    (w * y.to(torch.float32)).sum().backward()

    def nhwc(t):
        return t.detach().to(torch.float32).permute(0, 2, 3, 1).numpy()

    assert y.dtype == td
    assert y.is_contiguous(memory_format=torch.channels_last)
    return dict(y=nhwc(y), mean=bn.running_mean.numpy(),
                var=bn.running_var.numpy(), dx=nhwc(x.grad),
                dscale=bn.weight.grad.numpy(), dbias=bn.bias.grad.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["fast", "stable", "shifted"])
def test_train_bn_matches_flax(mode, dtype):
    s = _setup(seed=len(mode))
    want, got = _jax(mode, dtype, s), _torch(mode, dtype, s)
    bf16 = dtype == "bfloat16"
    tol_p = (3e-2 if mode == "shifted" else 1e-3) if bf16 else 1e-5
    tol = dict(y=1e-2 if bf16 else 1e-5, mean=1e-5, var=1e-5,
               dx=1e-2 if bf16 else 1e-5, dscale=tol_p, dbias=tol_p)
    for key, t in tol.items():
        err = max_rel_err(np.asarray(want[key], np.float32), got[key])
        assert err <= t, (key, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["fast", "stable", "shifted"])
def test_eval_bn_matches_flax(mode, dtype):
    """Eval mode reads the running statistics; 'shifted' casts x - mean,
    the multiplier and the bias to the compute dtype before the affine
    step, as ``ShiftedBatchNorm`` does."""
    s = _setup(seed=5 + len(mode))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jmake_norm(mode, False, jd)().apply(
        {"params": {"scale": jnp.asarray(s["scale"]),
                    "bias": jnp.asarray(s["bias"])},
         "batch_stats": {"mean": jnp.asarray(s["mean"]),
                         "var": jnp.asarray(s["var"])}},
        jnp.asarray(s["x"]).astype(jd))
    bn = make_norm(mode, td)(C).eval()
    with torch.no_grad():
        for name, key in (("weight", "scale"), ("bias", "bias"),
                          ("running_mean", "mean"), ("running_var", "var")):
            getattr(bn, name).copy_(torch.from_numpy(s[key]))
        x = torch.from_numpy(s["x"]).permute(0, 3, 1, 2).to(td).contiguous(
            memory_format=torch.channels_last)
        y = bn(x)
    assert y.dtype == td
    got = y.to(torch.float32).permute(0, 2, 3, 1).numpy()
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        assert max_rel_err(want, got) <= 1e-6
    else:
        np.testing.assert_array_equal(got, want)


def test_running_stats_are_flax_momentum_and_biased_variance():
    """ra = 0.9 ra + 0.1 batch with the biased batch variance -- not torch
    BatchNorm2d's momentum 0.1 on the unbiased one -- and eval mode reads
    the running statistics."""
    s = _setup(seed=9)
    x = torch.from_numpy(s["x"]).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    bn = BatchNorm(C).train()
    bn(x)
    xd = x.double()
    mean = xd.mean((0, 2, 3))
    var = xd.var((0, 2, 3), unbiased=False)
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.1 * mean.numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               0.9 + 0.1 * var.numpy(), rtol=1e-5)
    with torch.no_grad():
        y = bn.eval()(x)
    want = (xd - bn.running_mean.double().reshape(1, -1, 1, 1)) \
        / torch.sqrt(bn.running_var.double().reshape(1, -1, 1, 1) + 1e-5)
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert ShiftedBatchNorm(C).mode == "shifted"
    with pytest.raises(ValueError, match="bn_variance"):
        make_norm("exact", torch.float32)
