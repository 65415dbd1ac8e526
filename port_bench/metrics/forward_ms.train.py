"""forward_ms.train: Train-mode forward and loss of one batch: CUDA events
around preprocessing, forward and loss, less preprocessing alone."""

from port_bench import readers


def read(ctx):
    return readers.split(ctx, "forward_ms")
