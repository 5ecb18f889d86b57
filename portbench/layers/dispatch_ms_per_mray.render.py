"""Device time of the ray-binning stage of the intersect dispatch (bin keys,
bucket ranks, the sort and the unsort) per million camera rays; nothing on
a scene without a BVH."""


def read(ctx):
    if not any(s[0] == "binning" for s in ctx.trace.spans):
        return None
    return 1e3 * ctx.trace.stage_device_s("binning") / ctx.mrays
