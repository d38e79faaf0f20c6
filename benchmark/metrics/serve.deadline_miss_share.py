"""`ServeReport.deadline_misses` over the window's ticks, at the
configuration's budget (one 15 ms period), %."""


def read(ctx):
    w = ctx["window"]
    return 100.0 * w["deadline_misses"] / w["ticks"] if w["ticks"] else None
