"""collate_ms.train: Host time of the span hp.data.collate (read, collate
and pin of one batch on the data pipeline's thread) per batch: the data
layer's busy time beside the main thread's wait for it."""

from port_bench import spans


def read(ctx):
    return spans.collate_ms(ctx)
