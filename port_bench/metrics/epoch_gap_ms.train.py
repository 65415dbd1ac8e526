"""epoch_gap_ms.train: Device time from the start event of hp.epoch to
its first step's start event: the start of the epoch's pinned prefetch,
per epoch of the card-only traced window."""

from port_bench import spans


def read(ctx):
    return spans.epoch_gap_ms(ctx)
