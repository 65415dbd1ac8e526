"""syncs_per_step.train: The counter syncs (blocking reads of device
values in Worker._finish_train_metrics) per training step."""

from port_bench import spans


def read(ctx):
    return spans.count_per_step(ctx, "syncs")
