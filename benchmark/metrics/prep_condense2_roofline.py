"""K1 `prep_condense2`: its counted roofline time (counts.py, at the
cell's B and N) over its mean traced device time a launch, %."""

import counts


def read(ctx):
    return counts.roofline_share(ctx, "prep_condense2")
