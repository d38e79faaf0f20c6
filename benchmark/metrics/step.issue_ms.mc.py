"""Host time to issue one tick's `rti_step_batched` call (the harness's
clock around the call, no sync), mean over the window's ticks, ms."""


def read(ctx):
    issue = ctx["window"]["issue_s"]
    return 1e3 * sum(issue) / len(issue) if issue else None
