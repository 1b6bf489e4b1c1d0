"""Scans inserted in the window over the window's time (host clock, the
device synchronised at both ends)."""


def read(ctx):
    return ctx.window_scans / ctx.window_s
