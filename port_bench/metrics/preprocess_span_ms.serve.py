"""preprocess_span_ms.serve: Device time of the span hp.serve.preprocess
(the raw batch to the network input, K1 included) per serve call,
between its CUDA events, in the card-only traced calls."""

from port_bench import spans


def read(ctx):
    return spans.device_ms(ctx, spans.CALL, "hp.serve.preprocess")
