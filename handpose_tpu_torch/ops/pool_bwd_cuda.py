"""Wrapper of the CUDA stem max-pool backward (``csrc/pool_bwd.cu``).

Replaces ``handpose_tpu/ops/pallas_kernels.py:max_pool_3x3s2p1_bwd_pallas``.
:func:`max_pool_3x3s2p1_bwd_cuda` takes the arguments of the plain
:func:`handpose_tpu_torch.ops.pooling.max_pool_3x3s2p1_bwd`:

* host tensors go to the plain version;
* CUDA tensors launch the kernel, or raise: there is no fallback.

The kernel reads and writes channels_last memory; a tensor in another
layout raises (the autograd function converts ``dy`` explicitly).
``KERNEL.launches`` counts the kernel's launches and nothing else;
``KERNEL.dy_copies`` counts the backward calls whose ``dy`` the autograd
function had to copy into channels_last first.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .pooling import max_pool_3x3s2p1_bwd, pooled_size

SOURCE = "pool_bwd"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class PoolBwdKernel:
    """The loaded library and the launch count."""

    def __init__(self):
        self.launches = 0
        self.dy_copies = 0
        self._fn = None

    def _entry(self):
        if self._fn is None:
            fn = cuda_build.load(SOURCE).hpt_pool_bwd
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
        if x.ndim != 4:
            raise ValueError(f"x must be (N, C, H, W), got {tuple(x.shape)}")
        N, C, H, W = x.shape
        want = (N, C, *pooled_size(H, W))
        if tuple(dy.shape) != want:
            raise ValueError(f"dy must be {want}, got {tuple(dy.shape)}")
        if x.dtype not in _DTYPES or dy.dtype != x.dtype:
            raise ValueError("x and dy must share a float32 or bfloat16 "
                             f"dtype, got {x.dtype} and {dy.dtype}")
        if dy.device != x.device:
            raise ValueError("x and dy lie on different devices")
        cl = torch.channels_last
        if not (x.is_contiguous(memory_format=cl)
                and dy.is_contiguous(memory_format=cl)):
            raise ValueError("x and dy must be in channels_last memory")
        if min(N, C, H, W) < 1:
            raise ValueError(f"empty input {tuple(x.shape)}")
        dx = torch.empty_like(x, memory_format=cl)
        vec = cuda_build.vector_width(x, dy, dx)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = self._entry()(x.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                                _DTYPES[x.dtype], N, H, W, C, vec, stream)
        if err != 0:
            raise RuntimeError(f"pool backward kernel launch failed: CUDA "
                               f"error {err}")
        self.launches += 1
        return dx


KERNEL = PoolBwdKernel()


def max_pool_3x3s2p1_bwd_cuda(x: torch.Tensor,
                              dy: torch.Tensor) -> torch.Tensor:
    """dx of the 3x3/s2/p1 max pool, (N, C, H, W) like ``x``: the kernel
    on the card, the plain version for host tensors."""
    if x.device.type == "cpu":
        return max_pool_3x3s2p1_bwd(x, dy)
    if x.device.type != "cuda":
        raise ValueError(f"no pool backward kernel for device {x.device}")
    return KERNEL(x, dy)
