"""Device kernels a tick that are not the port's own (PyTorch's: the
IPM's barrier algebra, the update, the plant), from the traced segment;
a count that repeats exactly."""


import program


def read(ctx):
    tr = ctx["trace"]
    port = len(program.port_kernel_events(tr))
    other = len(tr.kernels) - port
    return other / tr.ticks if tr.kernels else None
