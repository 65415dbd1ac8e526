"""k3_roofline.train: The stem max pool's backward (K3, csrc/pool_bwd.cu)
over a training step: least time from bytes over device time."""

from port_bench import readers


def read(ctx):
    return readers.k3(ctx)
