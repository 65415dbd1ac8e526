"""preprocess_issue_ms.serve: Host time inside the span
hp.serve.preprocess per serve call: the host's issue of preprocessing,
in the card-only traced calls."""

from port_bench import spans


def read(ctx):
    return spans.host_ms(ctx, spans.CALL, "hp.serve.preprocess")
