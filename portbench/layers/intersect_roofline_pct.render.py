"""The intersect kernels' summed bound (portbench/roofline.py) over their
summed device time in the traced window, in percent."""
from portbench.layers import intersect_roofline_pct


def read(ctx):
    return intersect_roofline_pct(ctx)
