"""Vehicle commands that reached the host over the window's seconds.
The schedule caps it at the vehicles times the rate (17.05k at 256 and
66.6 Hz) once a tick takes less than a period."""


def read(ctx):
    w = ctx["window"]
    n = len(w["latency_s"])
    return n * ctx["cell"].B / w["seconds"] if n else None
