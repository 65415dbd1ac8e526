"""k1_roofline.train: The scoremap kernel (K1, csrc/scoremap.cu) in
training: its least time from bytes over its device time in the trace."""

from port_bench import readers


def read(ctx):
    return readers.k1(ctx)
