"""Device: kernels run in the traced stretch (the profiler's device events
less copies and sets), a scan."""


def read(ctx):
    if ctx.trace is None or not ctx.trace["kernels"]:
        return None
    return len(ctx.trace["kernels"]) / ctx.trace_scans
