"""`ServeReport.issue_s`: host time from a tick's state crossing the
host boundary to its solve issued, mean over the window's ticks, ms."""


def read(ctx):
    issue = ctx["window"]["issue_s"]
    return 1e3 * sum(issue) / len(issue) if issue else None
