"""mfu.serve: The whole serve call's share of the dense bfloat16 peak at
the untraced rate."""

from port_bench import readers


def read(ctx):
    return readers.mfu(ctx)
