"""Seconds from the process's start to the window's opening: imports, the
device's start, making the world and the scans, building the program and
its kernels where they are not built yet, and the warm-up."""


def read(ctx):
    return ctx.setup_s
