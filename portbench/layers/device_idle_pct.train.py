"""100 minus the share of the traced window in which an operation ran on the
device (the union of kernel, copy and fill intervals)."""
from portbench.layers import idle_pct


def read(ctx):
    return idle_pct(ctx)
