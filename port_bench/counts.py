"""Operations and bytes from the published shapes, and the card's peaks.

The yardstick of the kernels' roofline shares and of the whole step's
share of the card's peak.  Everything here follows from the
architecture (``reference/resnet.py``'s blocks) and the cell's sizes,
never from the measured package's modules, so a change to the package
cannot move it.

FLOPs count 2 per multiply-add of every convolution and fully connected
layer (BatchNorm, activations and the geometry are left out, as MFU
conventionally leaves them).  A trained image costs three forwards: the
forward, and the backward's products for the inputs and for the
weights.  Bytes count each input read once and each output written
once, whatever the kernel reads again.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

from .reference import resnet

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
TRAIN_FORWARDS = 3


def _out(h: int, stride: int) -> int:
    """Side of a stride-``stride`` convolution or pool with 'same'
    padding (k // 2)."""
    return (h - 1) // stride + 1


def trunks(spec) -> List[Tuple[int, int, int]]:
    """(depth, input channels, stem kernel) of every ResNet trunk of a
    network's leaves ``spec`` (``reference/<module>.spec``): a trunk is
    a ``conv_init`` with its residual blocks beside it."""
    out = []
    for path, shape, _ in spec:
        if not path.endswith("/conv_init/kernel"):
            continue
        prefix = path[:-len("conv_init/kernel")]
        names = {p[len(prefix):].split("/")[0] for p, _, _ in spec
                 if p.startswith(prefix)}
        for depth, (kind, stages, _) in resnet.BLOCKS.items():
            if sum(n.startswith(kind + "_") for n in names) == sum(stages):
                out.append((depth, shape[2], shape[0]))
    return out


def trunk_convs(depth: int, in_channels: int, side: int,
                stem_kernel: int = 3) -> Iterator[Tuple[int, int, int, int]]:
    """(in channels, out channels, kernel, output side) of every
    convolution of a ResNet trunk on ``side`` x ``side`` inputs."""
    h = _out(side, 2)
    yield in_channels, 64, stem_kernel, h
    h = _out(h, 2)                                    # the stem's max pool
    for _, cin, f, stride, ex in resnet.blocks(depth):
        ho = _out(h, stride)
        if ex == 1:
            yield cin, f, 3, ho
            yield f, f, 3, ho
        else:
            yield cin, f, 1, h
            yield f, f, 3, ho
            yield f, f * ex, 1, ho
        if stride != 1 or cin != f * ex:
            yield cin, f * ex, 1, ho
        h = ho


def trunk_macs(depth: int, in_channels: int, side: int,
               stem_kernel: int = 3) -> int:
    """Multiply-adds of one image through a trunk, its 1000-way fc
    included."""
    convs = sum(h * h * cout * cin * k * k for cin, cout, k, h in
                trunk_convs(depth, in_channels, side, stem_kernel))
    return convs + resnet.BLOCKS[depth][2] * 512 * 1000


def dense_macs(spec) -> int:
    """Multiply-adds of the dense kernels of ``spec`` outside the trunks
    (heads and projections)."""
    return sum(shape[0] * shape[1] for path, shape, role in spec
               if role == "dense" and "/trunk/" not in path)


def forward_flops(side: int, spec) -> int:
    """FLOPs of one image's forward through the network of ``spec`` at
    ``side`` x ``side``."""
    return 2 * (sum(trunk_macs(d, c, side, k) for d, c, k in trunks(spec))
                + dense_macs(spec))


def _bns(side: int, spec):
    """(pixels per image, channels) of every BatchNorm's input: one
    behind each convolution of every trunk."""
    return [(h * h, cout) for d, c, k in trunks(spec)
            for _, cout, _, h in trunk_convs(d, c, side, k)]


def k1_bytes(batch: int, maps: int, side: int) -> int:
    """The scoremap render: the float32 maps written, the (row, col)
    float32 coordinates and the bool visibility read."""
    return batch * maps * side * side * 4 + batch * maps * (2 * 4 + 1)


def k1_flops(batch: int, maps: int, side: int) -> int:
    """exp and 6 arithmetic operations for each element of every map."""
    return batch * maps * side * side * 7


def k2_bytes(side: int, spec, batch: int, elem: int = 2) -> int:
    """BatchNorm's moments over one train step: each BN input (bf16) read,
    the shift read and the two (C,) sums written."""
    return sum(batch * px * ch * elem + 3 * ch * 4
               for px, ch in _bns(side, spec))


def k2_flops(side: int, spec, batch: int) -> int:
    return sum(4 * batch * px * ch for px, ch in _bns(side, spec))


def k3_bytes(side: int, spec, batch: int, elem: int = 2) -> int:
    """The stem max pool's backward over one train step: x read, dx
    written (the pool's input, 64 channels at half the side) and dy
    read (a quarter of that), once per trunk."""
    h = _out(side, 2)
    ho = _out(h, 2)
    return (2 * batch * 64 * h * h + batch * 64 * ho * ho) * elem \
        * len(trunks(spec))


def k3_flops(side: int, spec, batch: int) -> int:
    """Nine compares for each window of every trunk's pool."""
    ho = _out(_out(side, 2), 2)
    return 18 * batch * 64 * ho * ho * len(trunks(spec))


def least_seconds(n_bytes: float, flops: float, flops_peak: float) -> float:
    """The roofline: the larger of the bytes' time at the HBM peak and
    the operations' time at ``flops_peak``."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / flops_peak)
