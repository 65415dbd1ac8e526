"""Wrapper of the CUDA moments kernel (``csrc/moments.cu``).

Replaces ``handpose_tpu/ops/pallas_kernels.py:_moments_pallas_raw``.
:func:`shifted_moments_cuda` takes the arguments of the plain
:func:`handpose_tpu_torch.ops.moments.shifted_moments`:

* host tensors go to the plain version;
* CUDA tensors launch the kernel (both stages), or raise: there is no
  fallback.

``KERNEL.launches`` counts the wrapper's launches (one for the two
stages together) and nothing else; ``KERNEL.by_shape`` splits the same
count by the (N, C) of the launch.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from . import cuda_build
from .moments import shifted_moments

SOURCE = "moments"
THREADS = 512           # threads of a stage-1 block (csrc/moments.cu)
MAX_CTAS = 2 * 132      # two resident blocks on each of the H100's 132 SMs
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def grid_size(n_rows: int, C: int, vec: int) -> int:
    """Stage-1 blocks: one wave of two blocks per SM, fewer when there
    are fewer row steps than that.  Fixed for a shape, so the order of
    every sum, and the result, repeat from run to run."""
    rows_per_step = THREADS // (C // vec)
    return max(1, min(MAX_CTAS, -(-n_rows // rows_per_step)))


class MomentsKernel:
    """The loaded library and the launch counts."""

    def __init__(self):
        self.launches = 0
        self.by_shape = Counter()
        self._fn = None

    def _entry(self):
        if self._fn is None:
            fn = cuda_build.load(SOURCE).hpt_moments
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, x2d: torch.Tensor, shift: torch.Tensor):
        if x2d.ndim != 2 or not x2d.is_contiguous():
            raise ValueError("x must be a contiguous (N, C) row view; got "
                             f"shape {tuple(x2d.shape)}, strides "
                             f"{x2d.stride()}")
        if x2d.dtype not in _DTYPES:
            raise ValueError(f"x must be float32 or bfloat16, got {x2d.dtype}")
        N, C = x2d.shape
        if shift.dtype != torch.float32 or shift.shape != (C,) \
                or not shift.is_contiguous():
            raise ValueError(f"shift must be a contiguous float32 ({C},)")
        if shift.device != x2d.device:
            raise ValueError("x and shift lie on different devices")
        if N < 1 or C < 1:
            raise ValueError(f"empty input {tuple(x2d.shape)}")
        vec = cuda_build.vector_width(x2d)
        if C // vec > THREADS:
            raise ValueError(f"C={C} needs {C // vec} threads per row, more "
                             f"than a block's {THREADS}")
        grid = grid_size(N, C, vec)
        part = torch.empty((grid, 2 * C), dtype=torch.float32,
                           device=x2d.device)
        out = torch.empty((2, C), dtype=torch.float32, device=x2d.device)
        with torch.cuda.device(x2d.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = self._entry()(x2d.data_ptr(), _DTYPES[x2d.dtype],
                                shift.data_ptr(), part.data_ptr(),
                                out.data_ptr(), N, C, grid, vec, stream)
        if err != 0:
            raise RuntimeError(f"moments kernel launch failed: CUDA error "
                               f"{err}")
        self.launches += 1
        self.by_shape[(N, C)] += 1
        return out[0], out[1]


KERNEL = MomentsKernel()


def shifted_moments_cuda(x2d: torch.Tensor, shift: torch.Tensor):
    """(N, C) ``x2d`` and f32 (C,) ``shift`` -> (sum(x - shift),
    sum((x - shift)^2)), two f32 (C,): the kernel on the card, the plain
    version for host tensors."""
    if x2d.device.type == "cpu":
        return shifted_moments(x2d, shift)
    if x2d.device.type != "cuda":
        raise ValueError(f"no moments kernel for device {x2d.device}")
    return KERNEL(x2d, shift)
