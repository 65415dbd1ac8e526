"""sync_wait_ms.train: Host time in the span hp.train.sync (the NaN
check's and the loss reads' blocking reads of a step's results in
Worker._finish_train_metrics) per training step."""

from port_bench import spans


def read(ctx):
    return spans.after_unit_ms(ctx, spans.SYNC)
