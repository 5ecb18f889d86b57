"""Host milliseconds from the loss to the end of its backward pass (a
synchronize on each side), the mean over the traced window's steps."""


def read(ctx):
    s = ctx.generator.backward_s
    return 1e3 * sum(s) / len(s) if s else None
