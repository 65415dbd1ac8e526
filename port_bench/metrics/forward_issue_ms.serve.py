"""forward_issue_ms.serve: Host time inside the span hp.serve.forward per
serve call: the host's issue of the model, in the card-only traced
calls."""

from port_bench import spans


def read(ctx):
    return spans.host_ms(ctx, spans.CALL, "hp.serve.forward")
