"""step_gap_ms.train: Device time from each training step's end event to
the next step's start event (the epoch's end for its last step): the
card's idle across the step boundary while the host reads the losses
(hp.train.sync) and waits for the next batch (hp.data.wait), per step."""

from port_bench import spans


def read(ctx):
    return spans.step_gap_ms(ctx)
