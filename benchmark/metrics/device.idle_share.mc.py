"""The device's idle share of the window, %: 1 - the device's busy time
a tick (the union of device intervals in the traced segment, over its
ticks) over the untraced window's seconds a tick."""


def read(ctx):
    return ctx["trace"].idle_share(ctx["window"])
