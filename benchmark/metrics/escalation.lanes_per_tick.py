"""Lanes re-solved by the escalation (`ipm_fast.escalation_counts()`,
read after the window) over the window's ticks."""


def read(ctx):
    w = ctx["window"]
    return w["escalated_lanes"] / w["ticks"] if w["ticks"] else None
