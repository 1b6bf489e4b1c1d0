"""Ops (``ops/nn_search.py``, K1 and K2): device time of the port's
``nn_*`` kernels in the traced stretch, a millisecond a scan."""
import re

NN = re.compile(r"(^|[\s:])nn_[A-Za-z0-9_]*")


def read(ctx):
    if ctx.trace is None:
        return None
    t = sum(d for n, d in ctx.trace["kernels"] if NN.search(n))
    return 1e3 * t / ctx.trace_scans if t > 0 else None
