"""k2_roofline.train: BatchNorm's moments (K2, csrc/moments.cu) over a
training step: least time from bytes over device time in the trace."""

from port_bench import readers


def read(ctx):
    return readers.k2(ctx)
