"""preprocess_ms.train: Device preprocessing of one training batch, timed
alone with CUDA events."""

from port_bench import readers


def read(ctx):
    return readers.split(ctx, "preprocess_ms")
