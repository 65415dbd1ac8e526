"""idle_pct.train: The share of the traced training window in which no
kernel, copy or set ran on the card."""

from port_bench import readers


def read(ctx):
    return readers.idle_pct(ctx)
