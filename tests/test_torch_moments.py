"""Port parity: the BatchNorm moments (K2) -- plain version and backward.

``handpose_tpu_torch.ops.moments.shifted_moments`` (the plain version the
CUDA kernel is held to on the card) against the TPU kernel
``_moments_pallas_raw`` in interpret mode and the jnp shifted form, on the
same numpy inputs: float32 and bfloat16 x (bf16 values made on the bf16
grid, so both frameworks read the same numbers), shift 0 and nonzero,
N = 1, 17, 1023, 1025, 4100 (tails of every tile) and C = 64, 512.

Tolerance: the sums are taken in another order than XLA's, so each
channel's difference is held to 1e-5 of the sum of |x - shift| over its
rows (for ``ss``, of ``ss`` itself): the scale of a float32 sum's
rounding.

The backward (``FusedShiftedMoments``) against ``jax.vjp`` of
``fused_shifted_moments`` (interpret mode) with random cotangents: dx to
1e-6 of its range in float32 and to one bf16 ulp (2^-8) of its range in
bfloat16 (the same formula rounded to bf16 once, where a 1-ulp float32
difference may flip the rounding); dshift to 1e-5 of its range (it
carries the forward's sums).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import jax

from handpose_tpu.ops.pallas_kernels import (_moments_pallas_raw,
                                             fused_shifted_moments as jfsm)
from handpose_tpu_torch.ops.moments import (fused_shifted_moments,
                                            rows_view, shifted_moments)

from _torch_port import max_rel_err
from _torch_port import port_worker_niced  # noqa: F401

SHAPES = [(N, C) for N in (1, 17, 1023, 1025, 4100) for C in (64, 512)]
TOL = 1e-5


def _inputs(N, C, dtype, seed):
    """(x on the dtype's grid as float32 numpy, torch x, jax x, shift)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0.5, 1.5, (N, C)).astype(np.float32))
    tx = x.to(getattr(torch, dtype))
    x32 = tx.to(torch.float32).numpy()
    jx = jnp.asarray(x32).astype(getattr(jnp, dtype))
    shift = rng.normal(0.0, 1.0, C).astype(np.float32)
    return x32, tx, jx, shift


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_moments_plain_matches_pallas_and_jnp(shape, dtype):
    N, C = shape
    x32, tx, jx, shift = _inputs(N, C, dtype, seed=N + C)
    for sh in (np.zeros(C, np.float32), shift):
        d = x32.astype(np.float64) - sh
        scale = (np.abs(d).sum(0), (d * d).sum(0))
        s, ss = shifted_moments(tx, torch.from_numpy(sh))
        assert s.dtype == ss.dtype == torch.float32
        pal = _moments_pallas_raw(jx, jnp.asarray(sh), interpret=True)
        jd = jx.astype(jnp.float32) - jnp.asarray(sh)[None, :]
        for ref in (pal, (jnp.sum(jd, 0), jnp.sum(jd * jd, 0))):
            for ours, theirs, sc in zip((s, ss), ref, scale):
                diff = np.abs(ours.numpy() - np.asarray(theirs, np.float64))
                assert (diff <= TOL * sc + 1e-30).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(17, 64), (1025, 512)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_moments_backward_matches_jax_vjp(shape, dtype):
    N, C = shape
    _, tx, jx, shift = _inputs(N, C, dtype, seed=7 * N + C)
    rng = np.random.default_rng(N)
    gs, gss = (rng.normal(size=C).astype(np.float32) for _ in range(2))

    _, vjp = jax.vjp(lambda a, b: jfsm(a, b, True), jx, jnp.asarray(shift))
    jdx, jdshift = vjp((jnp.asarray(gs), jnp.asarray(gss)))

    x = tx.clone().requires_grad_()
    sh = torch.from_numpy(shift).requires_grad_()
    s, ss = fused_shifted_moments(x, sh)
    torch.autograd.backward((s, ss), (torch.from_numpy(gs),
                                      torch.from_numpy(gss)))
    assert x.grad.dtype == x.dtype
    tol = 2.0 ** -8 if dtype == "bfloat16" else 1e-6
    assert max_rel_err(np.asarray(jdx, np.float32),
                       x.grad.to(torch.float32).numpy()) <= tol
    assert max_rel_err(jdshift, sh.grad.numpy()) <= 1e-5


def test_rows_view_of_channels_last_and_its_gradient():
    """A channels_last (B, C, H, W) activation is read as its (B·H·W, C)
    memory without a copy, and the gradient comes back in that layout;
    an NCHW-contiguous activation raises."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 8, 3, 5)).astype(np.float32))
    xc = x.contiguous(memory_format=torch.channels_last).requires_grad_()
    x2d = rows_view(xc)
    assert x2d.data_ptr() == xc.data_ptr() and x2d.shape == (30, 8)
    shift = torch.from_numpy(rng.normal(size=8).astype(np.float32))
    s, ss = fused_shifted_moments(x2d, shift)
    (s.sum() + ss.sum()).backward()
    want = 1.0 + 2.0 * (x - shift.reshape(1, -1, 1, 1))
    torch.testing.assert_close(xc.grad, want, rtol=1e-6, atol=1e-6)
    assert xc.grad.is_contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="channels_last"):
        rows_view(x)
