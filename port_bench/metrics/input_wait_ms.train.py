"""input_wait_ms.train: The Worker's input stall (StepStats.input) per
training step over the untraced epochs of a traced run."""


def read(ctx):
    return ctx.get("input_wait_ms")
