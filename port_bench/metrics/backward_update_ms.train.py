"""backward_update_ms.train: Backward and Adam of one step: CUDA events
around the fused train step, less preprocessing, forward and loss."""

from port_bench import readers


def read(ctx):
    return readers.split(ctx, "backward_update_ms")
