"""The tiled stem max-pool backward (K3): its tile plan and its algorithm.

``csrc/pool_bwd.cu`` runs only on the card.  What a CPU can check of it
is checked here, at the shapes the card's tests run:

* :func:`tile_plan`'s tile counts, channel chunks and block cover every
  dx element exactly once, its shared memory holds the kernel's layout
  within a Hopper block's 232,448 bytes, and it picks the cp.async
  variant at the b256 stem shape;
* a tile-by-tile model of the kernel (stage the halo, derive each
  window's first-max tap once, gather each pixel's terms in the fixed
  order, write once) equals the plain version exactly (``torch.equal``),
  on tie-heavy inputs too, and stages exactly the windows its pixels
  need and the x rows and columns those windows read.

The model's geometry (:class:`Geometry`: tile order, chunk channels,
pixels, windows and halo of a tile) is this file's copy of what the
kernel computes for itself; the kernel's own is held to the plain
version only on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from handpose_tpu_torch.ops import pool_bwd_cuda
from handpose_tpu_torch.ops.pool_bwd_cuda import TILE, smem_bytes, tile_plan
from handpose_tpu_torch.ops.pooling import max_pool_3x3s2p1_bwd, pooled_size
from _torch_port import port_worker_niced  # noqa: F401

STEM = (256, 64, 128, 128)
# (N, C, H, W): the stem, odd sizes, C = 5 and 3, 1 x 1, one past and one
# short of a 16-pixel tile multiple, and C over 32 vectors (chunked)
SHAPES = [STEM, (2, 64, 33, 17), (3, 5, 9, 7), (1, 8, 1, 1),
          (1, 16, 31, 17), (1, 16, 33, 15), (2, 3, 9, 7), (2, 520, 9, 7)]
DTYPES = [torch.bfloat16, torch.float32]
SMEM_BLOCK_MAX = 232_448      # Hopper: dynamic shared memory of one block


def _vec(C, dtype):
    """The widest vector of at most 16 bytes dividing C (the wrapper's
    rule for aligned tensors)."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    while vec > 1 and C % vec:
        vec //= 2
    return vec


def _plan(shape, dtype):
    N, C, H, W = shape
    return tile_plan(N, C, H, W, dtype, _vec(C, dtype))


class Geometry:
    """What ``csrc/pool_bwd.cu`` derives of a plan's tiles, in Python."""

    def __init__(self, plan):
        self.plan = plan

    def tile(self, t):
        """Tile ``t`` as (n, chunk, k0, l0): image, channel chunk and its
        first window row and column; columns go fastest, as in the
        kernel."""
        p = self.plan
        t, tc = divmod(t, p.tiles_w)
        t, tr = divmod(t, p.tiles_h)
        n, chunk = divmod(t, p.n_chunks)
        return n, chunk, tr * p.th, tc * p.tw

    def channels(self, chunk):
        """Channels of a chunk (the last one may be short)."""
        p = self.plan
        lo = chunk * p.cvb * p.vec
        return range(lo, min(lo + p.cvb * p.vec, p.C))

    def pixels(self, k0, l0):
        """dx rows and columns a tile writes."""
        p = self.plan
        return (range(2 * k0, min(2 * (k0 + p.th), p.H)),
                range(2 * l0, min(2 * (l0 + p.tw), p.W)))

    def windows(self, k0, l0):
        """Window rows and columns whose codes and dy a tile stages."""
        p = self.plan
        Ho, Wo = pooled_size(p.H, p.W)
        return (range(k0, min(k0 + p.th + 1, Ho)),
                range(l0, min(l0 + p.tw + 1, Wo)))

    def halo(self, k0, l0):
        """x rows and columns a tile stages (inside the image)."""
        p = self.plan
        return (range(max(2 * k0 - 1, 0), min(2 * (k0 + p.th) + 2, p.H)),
                range(max(2 * l0 - 1, 0), min(2 * (l0 + p.tw) + 2, p.W)))


def _needed_windows(lo, hi, n_out):
    """Window indices (along one axis) whose 3-tap span holds a pixel in
    [lo, hi)."""
    return sorted({o for p in range(lo, hi) for o in range(n_out)
                   if 2 * o - 1 <= p <= 2 * o + 1})


def _taps(windows, n_in):
    """Input indices (along one axis) the windows read."""
    return sorted({2 * o - 1 + d for o in windows for d in range(3)
                   if 0 <= 2 * o - 1 + d < n_in})


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_tile_plan_covers_every_element_once(shape, dtype):
    plan = _plan(shape, dtype)
    geo = Geometry(plan)
    N, C, H, W = shape
    tiles = [geo.tile(t) for t in range(plan.n_tiles)]
    assert len(set(tiles)) == plan.n_tiles
    assert sorted({n for n, *_ in tiles}) == list(range(N))
    # every image is tiled alike: count the elements of the first one
    count = np.zeros((C, H, W), np.int32)
    for n, chunk, k0, l0 in tiles:
        if n == 0:
            ch, (rows, cols) = geo.channels(chunk), geo.pixels(k0, l0)
            count[ch.start:ch.stop, rows.start:rows.stop,
                  cols.start:cols.stop] += 1
    assert (count == 1).all()
    assert plan.n_tiles == N * plan.n_chunks * plan.tiles_h * plan.tiles_w
    assert plan.cvb * plan.n_chunks * plan.vec >= C
    assert plan.cvb * plan.block_y <= 256 and plan.block_y >= 32
    assert 1 <= plan.grid <= plan.n_tiles


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_tile_plan_halo_is_what_the_windows_need(shape, dtype):
    _, _, H, W = shape
    Ho, Wo = pooled_size(H, W)
    plan = _plan(shape, dtype)
    geo = Geometry(plan)
    for t in range(plan.n_tiles // plan.N):      # the first image
        _, _, k0, l0 = geo.tile(t)
        rows, cols = geo.pixels(k0, l0)
        wr, wc = geo.windows(k0, l0)
        hr, hc = geo.halo(k0, l0)
        assert list(wr) == _needed_windows(rows.start, rows.stop, Ho)
        assert list(wc) == _needed_windows(cols.start, cols.stop, Wo)
        assert list(hr) == _taps(wr, H) and list(hc) == _taps(wc, W)
        # the kernel's staging frame: rows 2k0-1 .. 2k0+2TH+1
        assert 2 * k0 - 1 <= hr.start and hr.stop <= 2 * (k0 + plan.th) + 2
        assert 2 * l0 - 1 <= hc.start and hc.stop <= 2 * (l0 + plan.tw) + 2
        assert wr.stop - k0 <= plan.th + 1 and wc.stop - l0 <= plan.tw + 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_tile_plan_shared_memory_fits_a_block(shape, dtype):
    plan = _plan(shape, dtype)
    esize = torch.empty((), dtype=dtype).element_size()
    th, tw, cw = plan.th, plan.tw, plan.cvb * plan.vec
    need = (((2 * th + 3) * (2 * tw + 3) + (th + 1) * (tw + 1)) * cw * esize
            + (th + 1) * (tw + 1) * cw * 2)
    assert need <= plan.smem <= SMEM_BLOCK_MAX
    assert plan.smem == smem_bytes(plan.cvb, plan.vec, esize)
    assert plan.smem_opt_in == (plan.smem > 48 * 1024)
    assert plan.blocks_per_sm >= 1


def test_tile_plan_at_the_stem():
    esize = {torch.bfloat16: 2, torch.float32: 4}
    for dtype in DTYPES:
        plan = _plan(STEM, dtype)
        assert plan.variant == "tiled"
        assert (plan.th, plan.tw) == TILE == (8, 8)
        # 128 bytes of a pixel a chunk: one chunk in bf16, two in float32
        assert plan.n_chunks == esize[dtype] // 2
        assert plan.cvb * plan.vec * esize[dtype] == 128
        # three blocks of 256 threads fit an SM's shared memory
        assert plan.smem < 233_472 // 3 - 1024 and plan.blocks_per_sm == 3
        assert plan.smem_opt_in
    assert _plan(STEM, torch.bfloat16).smem == 66_944
    # bf16 with odd C has 2-byte vectors, which cp.async cannot copy
    assert _plan((2, 3, 9, 7), torch.bfloat16).variant == "tiled_sync"
    assert _plan((2, 520, 9, 7), torch.bfloat16).n_chunks == 9


def test_tile_matches_the_source():
    """TILE is the tile that csrc/pool_bwd.cu is built for."""
    src = (Path(pool_bwd_cuda.__file__).parents[1] / "csrc"
           / "pool_bwd.cu").read_text()
    built = re.search(r"constexpr int kTH = (\d+), kTW = (\d+);", src)
    assert built and (int(built[1]), int(built[2])) == TILE


def tiled_model(x, dy, plan):
    """The kernel's algorithm, tile by tile, in float32: stage the tile's
    x halo (NaN where nothing is staged, so a read outside it shows) and
    dy; derive each window's first-max tap over the taps inside the image;
    then each pixel adds the dy of the covering windows whose tap it is,
    window rows then columns descending (ascending tap index); each dx
    element is written once."""
    N, C, H, W = x.shape
    Ho, Wo = pooled_size(H, W)
    th, tw = plan.th, plan.tw
    geo = Geometry(plan)
    xf, g = x.to(torch.float32), dy.to(torch.float32)
    dx = torch.full((N, C, H, W), float("nan"))
    for t in range(plan.n_tiles):
        n, chunk, k0, l0 = geo.tile(t)
        ch = geo.channels(chunk)
        cs = slice(ch.start, ch.stop)
        r0, c0 = 2 * k0 - 1, 2 * l0 - 1          # the staging frame
        xs = torch.full((len(ch), 2 * th + 3, 2 * tw + 3), float("nan"))
        hr, hc = geo.halo(k0, l0)
        xs[:, hr.start - r0:hr.stop - r0, hc.start - c0:hc.stop - c0] = \
            xf[n, cs, hr.start:hr.stop, hc.start:hc.stop]
        wr, wc = geo.windows(k0, l0)
        ds = torch.zeros((len(ch), th + 1, tw + 1))
        ds[:, :len(wr), :len(wc)] = g[n, cs, wr.start:wr.stop,
                                      wc.start:wc.stop]
        codes = torch.full((len(ch), th + 1, tw + 1), -1)
        for oh in wr:
            for ow in wc:
                m = code = None
                for k in range(9):
                    di, dj = divmod(k, 3)
                    ih, iw = 2 * oh - 1 + di, 2 * ow - 1 + dj
                    if not (0 <= ih < H and 0 <= iw < W):
                        continue
                    v = xs[:, ih - r0, iw - c0]
                    assert not torch.isnan(v).any()
                    if m is None:
                        m, code = v, torch.full(v.shape, k)
                        continue
                    take = v > m
                    m = torch.where(take, v, m)
                    code = torch.where(take, k, code)
                codes[:, oh - k0, ow - l0] = code
        rows, cols = geo.pixels(k0, l0)
        for h in rows:
            for w in cols:
                pr, pc = h - 2 * k0, w - 2 * l0
                acc = torch.zeros(len(ch))
                for a in range(2):
                    r = (pr + 1) // 2 - a
                    di = pr + 1 - 2 * r
                    if di > 2 or k0 + r >= Ho:
                        continue
                    for b in range(2):
                        c = (pc + 1) // 2 - b
                        dj = pc + 1 - 2 * c
                        if dj > 2 or l0 + c >= Wo:
                            continue
                        hit = codes[:, r, c] == di * 3 + dj
                        acc = torch.where(hit, acc + ds[:, r, c], acc)
                assert torch.isnan(dx[n, cs, h, w]).all()
                dx[n, cs, h, w] = acc
    assert not torch.isnan(dx).any()
    return dx.to(x.dtype)


def _inputs(shape, dtype, ties, seed):
    N, C, H, W = shape
    rng = np.random.default_rng(seed)
    x = (np.maximum(rng.integers(-2, 3, shape), 0) if ties
         else np.maximum(rng.normal(size=shape), 0))
    dy = rng.normal(size=(N, C, *pooled_size(H, W)))
    cl = torch.channels_last
    return (torch.from_numpy(x.astype(np.float32)).to(dtype)
            .contiguous(memory_format=cl),
            torch.from_numpy(dy.astype(np.float32)).to(dtype)
            .contiguous(memory_format=cl))


@pytest.mark.parametrize("shape,dtype,ties", [
    ((2, 64, 33, 17), torch.bfloat16, False),
    ((2, 64, 33, 17), torch.float32, True),
    ((3, 5, 9, 7), torch.float32, True),
    ((1, 8, 1, 1), torch.bfloat16, False),
    ((1, 16, 31, 17), torch.bfloat16, True),
    ((1, 16, 33, 15), torch.float32, False),
    ((2, 3, 9, 7), torch.bfloat16, True),
    ((1, 72, 32, 32), torch.bfloat16, True),
    ((2, 16, 33, 15), torch.bfloat16, True),
    ((1, 33, 5, 6), torch.float32, True),
])
def test_tiled_model_equals_plain(shape, dtype, ties):
    x, dy = _inputs(shape, dtype, ties, seed=sum(shape))
    got = tiled_model(x, dy, _plan(shape, dtype))
    assert torch.equal(got, max_pool_3x3s2p1_bwd(x, dy))
