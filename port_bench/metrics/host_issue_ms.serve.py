"""host_issue_ms.serve: The host time of a serve call from issue to return,
before its outputs are ready: the mean over the untraced calls of a
traced run."""


def read(ctx):
    return ctx.get("host_issue_ms")
