"""Device: the share of the traced window in which no operation (kernel,
copy or set) ran on the GPU, from the profiler's device events."""


def read(ctx):
    if ctx.trace is None or not ctx.trace["busy_s"]:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
