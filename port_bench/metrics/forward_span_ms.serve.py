"""forward_span_ms.serve: Device time of the span hp.serve.forward (the
is_inference model) per serve call, between its CUDA events, in the
card-only traced calls."""

from port_bench import spans


def read(ctx):
    return spans.device_ms(ctx, spans.CALL, "hp.serve.forward")
