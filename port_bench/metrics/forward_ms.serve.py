"""forward_ms.serve: The inference forward with rel-to-absolute and
projection: CUDA events around a serve call, less preprocessing alone."""

from port_bench import readers


def read(ctx):
    return readers.split(ctx, "forward_ms")
