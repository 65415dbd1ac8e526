"""mfu.train: The whole training step's share of the dense bfloat16 peak,
three forwards an image, at the untraced rate."""

from port_bench import readers


def read(ctx):
    return readers.mfu(ctx)
