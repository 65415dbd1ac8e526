"""bn_fused_per_call.serve: The counter bn_fused (BatchNorm applies in
eval mode through the one-pass operator, the kernel on the card) per
serve call, in the card-only traced calls; None where the program counts
no such apply."""

from port_bench import spans


def read(ctx):
    w = spans.window(ctx, spans.CALL)
    if w is None:
        return None
    counted = [c for (u, k), c in w.counts.items()
               if k == "bn_fused" and u in w.ids]
    return sum(counted) / w.n if counted else None
