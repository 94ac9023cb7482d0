"""K1's share of its roofline in a render call: its least time at the
call's shapes over the device time of the kernels mapped to it."""

from cardbench.core.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "k1_fused_head")
