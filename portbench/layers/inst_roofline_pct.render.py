"""The 4-wide walk's summed bound over its device time in the traced window,
in percent, on a scene whose walk two callers launch: the base route from
node 0 and the instanced sweep from each ray's BLAS root. The bound is one
request's launches captured and counted from where the kernel starts each
ray (portbench/roofline_roots.py), times the window's requests; the time is
every `bvh4_kernel` of the window."""
from portbench import roofline_roots


def read(ctx):
    bound = roofline_roots.request_bound_s(ctx.generator, ctx.run)
    spent = ctx.trace.kernel_s(("bvh4_kernel",))
    if bound is None or spent <= 0.0:
        return None
    return 100.0 * bound * ctx.window.requests / spent
