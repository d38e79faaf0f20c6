"""The whole tick's share of the fp32 peak: the tick's counted
operations (K1, the iterations' K2, K3 and barrier algebra, K4, the
plant; counts.py) times the window's ticks, over 67 TFLOP/s times the
window's seconds, %."""

import counts


def read(ctx):
    w, cell = ctx["window"], ctx["cell"]
    if not w["ticks"]:
        return None
    ops = counts.tick_flops(cell.B, cell.N, cell.ipm.iters) * w["ticks"]
    return 100.0 * ops / (counts.PEAK_FP32_FLOPS * w["seconds"])
