"""Port parity: the stem max-pool backward (K3) -- plain version.

``handpose_tpu_torch.ops.pooling.max_pool_3x3s2p1_bwd`` (the plain
version the CUDA kernel is held to on the card) against:

* the TPU kernel ``max_pool_3x3s2p1_bwd_pallas`` in interpret mode,
  where its shapes allow (H even, W % 4 == 0): equal exactly, float32
  and bfloat16 -- both sum a pixel's <= 4 terms in float32 in the same
  order and round once;
* ``jax.vjp`` of ``stem_max_pool(x, 'native')`` (select-and-scatter) on
  odd H and W: equal gradient support, values to 1e-6 of range in
  float32 (XLA adds the terms in its own order), and in bfloat16 to 1e-2
  with the support carve-out of ``tests/test_pooling.py`` (XLA adds in
  bf16);
* torch's own ``F.max_pool2d`` autograd on tie-heavy integer inputs:
  equal support exactly, values to 1e-6 of range;
* in bfloat16, eagerly: every dy lands once (mass conserved to 2e-2, as
  ``tests/test_pooling.py:193``) and nothing is NaN.

Layouts: JAX NHWC, the port NCHW (channels_last where the trunk has it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from handpose_tpu.ops.pallas_kernels import max_pool_3x3s2p1_bwd_pallas
from handpose_tpu.ops.pooling import stem_max_pool as jstem_max_pool
from handpose_tpu_torch.ops.pooling import (max_pool_3x3s2p1_bwd,
                                            stem_max_pool)

from _torch_port import max_rel_err
from _torch_port import port_worker_niced  # noqa: F401


def _nhwc(t):
    return np.ascontiguousarray(t.to(torch.float32).permute(0, 2, 3, 1)
                                .numpy())


def _case(kind, shape, dtype, seed):
    """(x, dy) torch NCHW channels_last in ``dtype``; shape is NHWC."""
    N, H, W, C = shape
    rng = np.random.default_rng(seed)
    if kind == "ties":
        x = np.maximum(rng.integers(-2, 3, (N, C, H, W)), 0)
    else:
        x = rng.normal(size=(N, C, H, W))
    dy = rng.normal(size=(N, C, (H + 1) // 2, (W + 1) // 2))
    cl = torch.channels_last
    return (torch.from_numpy(x.astype(np.float32)).to(dtype).contiguous(
                memory_format=cl),
            torch.from_numpy(dy.astype(np.float32)).to(dtype).contiguous(
                memory_format=cl))


def _support_equal(a, b):
    assert ((np.asarray(a) != 0) == (np.asarray(b) != 0)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,shape", [("ties", (2, 16, 16, 4)),
                                        ("smooth", (2, 8, 12, 8)),
                                        ("stemlike", (1, 32, 32, 64))])
def test_pool_bwd_plain_equals_pallas(kind, shape, dtype):
    x, dy = _case(kind, shape, getattr(torch, dtype), seed=len(kind))
    if kind == "stemlike":
        x = torch.relu(x)
    jd = getattr(jnp, dtype)
    want = max_pool_3x3s2p1_bwd_pallas(jnp.asarray(_nhwc(x)).astype(jd),
                                       jnp.asarray(_nhwc(dy)).astype(jd),
                                       interpret=True)
    got = max_pool_3x3s2p1_bwd(x, dy)
    assert got.dtype == x.dtype and got.shape == x.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 17, 13, 5), (1, 7, 9, 3),
                                   (2, 1, 1, 2), (1, 2, 3, 4)])
def test_pool_bwd_plain_matches_native_vjp_odd_shapes(shape, dtype):
    x, dy = _case("smooth", shape, getattr(torch, dtype), seed=sum(shape))
    jd = getattr(jnp, dtype)
    _, vjp = jax.vjp(lambda v: jstem_max_pool(v, "native"),
                     jnp.asarray(_nhwc(x)).astype(jd))
    want = np.asarray(vjp(jnp.asarray(_nhwc(dy)).astype(jd))[0], np.float32)
    got = _nhwc(max_pool_3x3s2p1_bwd(x, dy))
    if dtype == "float32":
        _support_equal(want, got)
        assert max_rel_err(want, got) <= 1e-6
    else:
        # XLA accumulates in bf16: where terms cancel it may round to
        # exactly 0 -- support may differ only at that scale
        atol = 1e-2 * max(1.0, np.abs(want).max())
        bad = ((want != 0) != (got != 0)) & ~((np.abs(want) <= atol)
                                              & (np.abs(got) <= atol))
        assert not bad.any()
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=atol)


def test_pool_bwd_plain_matches_torch_autograd_on_ties():
    x, dy = _case("ties", (3, 16, 15, 4), torch.float32, seed=2)
    xr = x.clone().requires_grad_()
    F.max_pool2d(xr, 3, stride=2, padding=1).backward(dy)
    got = max_pool_3x3s2p1_bwd(x, dy)
    _support_equal(xr.grad.numpy(), got.numpy())
    assert max_rel_err(xr.grad.numpy(), got.numpy()) <= 1e-6


def test_pool_bwd_bf16_mass_conserved_and_autograd_routes_it():
    x, dy = _case("smooth", (2, 16, 16, 8), torch.bfloat16, seed=6)
    dx = max_pool_3x3s2p1_bwd(x, dy).to(torch.float32)
    assert torch.isfinite(dx).all()
    np.testing.assert_allclose(float(dx.sum()),
                               float(dy.to(torch.float32).sum()),
                               rtol=2e-2, atol=2e-2)
    # the autograd function's backward on the host is the plain version
    xr = x.clone().requires_grad_()
    y = stem_max_pool(xr)
    torch.testing.assert_close(y, F.max_pool2d(x, 3, 2, 1), rtol=0, atol=0)
    y.backward(dy.contiguous())
    assert torch.equal(xr.grad, max_pool_3x3s2p1_bwd(x, dy))
