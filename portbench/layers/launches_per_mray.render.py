"""Device kernel launches in the traced window, the intersect kernels
launched through ctypes among them, per million camera rays."""
from portbench.layers import launches_per_mray


def read(ctx):
    return launches_per_mray(ctx)
