"""update_span_ms.train: Device time of the span hp.train.update (Adam,
TrainState.apply_gradients) per training step, between its CUDA events,
inside the Worker's loop in the card-only traced epoch."""

from port_bench import spans


def read(ctx):
    return spans.device_ms(ctx, spans.STEP, "hp.train.update")
