"""Wrapper of the CUDA stem max-pool backward (``csrc/pool_bwd.cu``).

Replaces ``handpose_tpu/ops/pallas_kernels.py:max_pool_3x3s2p1_bwd_pallas``.
:func:`max_pool_3x3s2p1_bwd_cuda` takes the arguments of the plain
:func:`handpose_tpu_torch.ops.pooling.max_pool_3x3s2p1_bwd`:

* host tensors go to the plain version;
* CUDA tensors launch the kernel, or raise: there is no fallback.

The kernel reads and writes channels_last memory; a tensor in another
layout raises (the autograd function converts ``dy`` explicitly).  It is
tiled: persistent blocks walk tiles of 8 x 8 pooling windows of one
image and one chunk of channel vectors, stage each tile's x halo and dy in
shared memory, derive each window's first-max tap once and gather each dx
pixel's terms from shared memory.  :func:`tile_plan` decides the
chunking, the variant, the block, the shared memory and the grid; the
CPU tests check it.  ``KERNEL.plan`` opts each planned launch into its
shared memory once.  ``KERNEL.launches`` counts the kernel's launches and
nothing else, ``KERNEL.by_variant`` the same launches by variant;
``KERNEL.dy_copies`` counts the backward calls whose ``dy`` the autograd
function had to copy into channels_last first.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from . import cuda_build
from .pooling import max_pool_3x3s2p1_bwd, pooled_size

SOURCE = "pool_bwd"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

TILE = (8, 8)                 # windows a tile, csrc/pool_bwd.cu's kTH, kTW
THREADS = 256                 # a block's threads at most
MAX_CHUNK_VECTORS = 8         # channel vectors a block stages per pixel
SMEM_SM = 233_472             # Hopper: shared memory of an SM, 1 KB a block
SMEM_DEFAULT = 48 * 1024      # above it the kernel must opt in
SMS = 132                     # H100 SXM


def _align16(n: int) -> int:
    return -(-n // 16) * 16


@dataclass(frozen=True)
class TilePlan:
    """One launch of the tiled kernel: which variant, the tile of
    ``th`` x ``tw`` windows (2 th x 2 tw dx pixels), ``cvb`` channel
    vectors of ``vec`` channels a chunk (``block = (cvb, block_y)``
    threads), the tile counts, the persistent ``grid``, the dynamic
    shared memory and whether it needs the opt-in above 48 KB."""

    variant: str
    N: int
    C: int
    H: int
    W: int
    vec: int
    th: int
    tw: int
    cvb: int
    n_chunks: int
    block_y: int
    tiles_h: int
    tiles_w: int
    n_tiles: int
    grid: int
    smem: int
    smem_opt_in: bool
    blocks_per_sm: int

    @property
    def block(self) -> Tuple[int, int]:
        return self.cvb, self.block_y


def smem_bytes(cvb: int, vec: int, esize: int) -> int:
    """Dynamic shared memory of a launch, as ``csrc/pool_bwd.cu`` lays it
    out: the stage buffer (x halo, then dy of the tile's windows) and a
    two-byte code per (window, channel)."""
    th, tw = TILE
    stage = ((2 * th + 3) * (2 * tw + 3) + (th + 1) * (tw + 1)) \
        * cvb * vec * esize
    return _align16(stage) + _align16((th + 1) * (tw + 1) * cvb * vec * 2)


def tile_plan(N: int, C: int, H: int, W: int, dtype: torch.dtype, vec: int,
              sms: int = SMS, blocks_per_sm: int = 0) -> TilePlan:
    """The launch of the tiled kernel for x (N, C, H, W) in ``dtype`` with
    ``vec`` channels a vector.  Channels go in the fewest chunks of at
    most 8 vectors (128 bytes or less of a pixel, so every tile fits a
    block), evened out; the grid is one block per tile up to ``sms`` x
    ``blocks_per_sm`` (resident blocks; 0: what the shared memory and
    thread counts allow)."""
    if dtype not in _DTYPES or C % vec:
        raise ValueError(f"no tile plan for {dtype} with C={C}, vec={vec}")
    esize = torch.empty((), dtype=dtype).element_size()
    cvs = C // vec
    n_chunks = -(-cvs // MAX_CHUNK_VECTORS)
    cvb = -(-cvs // n_chunks)
    smem = smem_bytes(cvb, vec, esize)
    block_y = THREADS // cvb
    if not blocks_per_sm:
        blocks_per_sm = min(SMEM_SM // (smem + 1024),
                            2048 // (cvb * block_y))
    th, tw = TILE
    Ho, Wo = pooled_size(H, W)
    tiles_h, tiles_w = -(-Ho // th), -(-Wo // tw)
    n_tiles = N * n_chunks * tiles_h * tiles_w
    return TilePlan(
        variant="tiled" if vec * esize >= 4 else "tiled_sync",
        N=N, C=C, H=H, W=W, vec=vec, th=th, tw=tw, cvb=cvb,
        n_chunks=n_chunks, block_y=block_y, tiles_h=tiles_h,
        tiles_w=tiles_w, n_tiles=n_tiles,
        grid=min(n_tiles, sms * blocks_per_sm), smem=smem,
        smem_opt_in=smem > SMEM_DEFAULT, blocks_per_sm=blocks_per_sm)


class PoolBwdKernel:
    """The loaded library, the launch counts and the plans made."""

    def __init__(self):
        self.launches = 0
        self.by_variant: Counter = Counter()
        self.dy_copies = 0
        self._lib = None
        self._plans: Dict[tuple, TilePlan] = {}

    def _library(self):
        if self._lib is None:
            lib = cuda_build.load(SOURCE)
            lib.hpt_pool_bwd.argtypes = (
                [ctypes.c_void_p] * 3 + [ctypes.c_int] * 13
                + [ctypes.c_void_p])
            lib.hpt_pool_bwd.restype = ctypes.c_int
            lib.hpt_pool_bwd_occupancy.argtypes = (
                [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_int)] * 2)
            lib.hpt_pool_bwd_occupancy.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def occupancy(self, plan: TilePlan, dtype: torch.dtype) -> Tuple[int,
                                                                     int]:
        """(resident blocks per SM, registers per thread) of ``plan``'s
        kernel on the current card, after opting it into ``plan.smem``
        bytes of shared memory where the plan needs that."""
        blocks, regs = ctypes.c_int(0), ctypes.c_int(0)
        err = self._library().hpt_pool_bwd_occupancy(
            _DTYPES[dtype], plan.vec, plan.th, plan.tw, plan.cvb,
            plan.block_y, plan.smem, int(plan.smem_opt_in),
            ctypes.byref(blocks), ctypes.byref(regs))
        if err != 0:
            raise RuntimeError(f"pool backward occupancy query failed: CUDA "
                               f"error {err}")
        return blocks.value, regs.value

    def plan(self, x: torch.Tensor, vec: int) -> TilePlan:
        """The tile plan for ``x`` on its card, the grid sized by the
        card's SM count and the kernel's measured occupancy.  Made once
        per shape, dtype, vector width and card; making it opts the
        kernel into its shared memory on that card."""
        N, C, H, W = x.shape
        key = (N, C, H, W, x.dtype, vec, x.device.index)
        if key not in self._plans:
            sms = torch.cuda.get_device_properties(x.device) \
                .multi_processor_count
            plan = tile_plan(N, C, H, W, x.dtype, vec, sms=sms)
            with torch.cuda.device(x.device):
                blocks, regs = self.occupancy(plan, x.dtype)
            if blocks < 1:
                raise RuntimeError(f"pool backward tile {plan.th}x{plan.tw} "
                                   f"does not fit on an SM ({plan.smem} B "
                                   f"of shared memory, {regs} registers)")
            plan = tile_plan(N, C, H, W, x.dtype, vec, sms=sms,
                             blocks_per_sm=blocks)
            self._plans[key] = plan
        return self._plans[key]

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
        plan = self.plan(x, cuda_build.vector_width(x, dy, dx))
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = self._library().hpt_pool_bwd(
                x.data_ptr(), dy.data_ptr(), dx.data_ptr(), _DTYPES[x.dtype],
                N, H, W, C, plan.vec, plan.th, plan.tw, plan.cvb,
                plan.n_chunks, plan.block_y, plan.grid, plan.smem, stream)
        if err != 0:
            raise RuntimeError(f"pool backward kernel launch failed: CUDA "
                               f"error {err}")
        self.launches += 1
        self.by_variant[plan.variant] += 1
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
