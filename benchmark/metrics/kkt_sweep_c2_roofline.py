"""K2 `kkt_sweep_c2`: its counted roofline time (counts.py, at the
cell's B and N) over its mean traced device time a launch, %."""

import counts


def read(ctx):
    return counts.roofline_share(ctx, "kkt_sweep_c2")
