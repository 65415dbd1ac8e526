"""preprocess_ms.serve: Device preprocessing of one serving batch, timed
alone with CUDA events."""

from port_bench import readers


def read(ctx):
    return readers.split(ctx, "preprocess_ms")
