"""Camera rays of every gradient step in the traced window over the traced
window's whole time: the training rate, read under the profiler."""


def read(ctx):
    return ctx.generator.end_to_end(ctx.window)["train_rays_per_s"]
